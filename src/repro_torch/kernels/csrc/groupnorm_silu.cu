// Fused GroupNorm + SiLU over NHWC feature maps in one launch, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `groupnorm_silu` (body `_gn_kernel`) of
// repro/kernels/groupnorm_silu.py:
//   y = silu((x - mean_g) * rsqrt(var_g + eps) * scale[c] + bias[c])
// with the statistics of each (batch element, channel group) taken in f32
// over all H*W pixels and the group's C/G channels.
//
// Inputs: x (B, H*W, C) f32 contiguous (NHWC), scale/bias (C,) f32.
// Output: like x.  Requires C % 4 == 0, C <= 1024, G | C.
//
// Bound on the card: memory, one read and one write of x; a few operations
// per element, far below the f32 rate.
//
// The TPU kernel holds one whole (H, W, C) map per grid step in VMEM.  Here
// one launch covers everything, with a thread-block cluster per (batch
// element, channel slice):
//   * A slice is the fewest whole groups that make at least 32 channels
//     and divide C (a 128-byte run per pixel); the cluster's CL blocks (up
//     to 16, non-portable above 8; at least 256 pixels each) split the
//     slice's H*W pixels into contiguous chunks.  A cluster runs inside one
//     GPC, and a 16-block cluster reaches at most 112 SMs of the card's 132
//     (7 GPCs x 16, measured with %smid).  So a map of at most 4 slices,
//     4 GPCs at batch 1, takes 16-channel slices where one fits on chip in
//     16 blocks (8 clusters; 64-byte runs cost DRAM efficiency where a map
//     is read twice: 256x256x128 took 0.058 ms with them, 0.045 without),
//     and otherwise blocks of up to 1024 threads, one an SM, keeping 160 KB
//     each on chip.  Other maps use 256-512 threads and up to 92 KB, two
//     blocks an SM.  The rule reads (H*W, C, G) only.
//   * Each block copies its chunk into shared memory with 16-byte cp.async,
//     all copies in flight at once, up to that size; a thread keeps a
//     Welford (count, mean, M2) per channel of its pixels.  Pixels past
//     that size are read straight from global memory, LOADS at a time,
//     while the copies land, and read again for the output.
//   * The block merges the Welfords in fixed binary trees, over pixel
//     lanes, then over a group's channels, into one partial per group in
//     shared memory; after cluster.sync() every block reads all CL
//     partials out of its peers' shared memory (distributed shared memory)
//     and merges them in a tree over the ranks, so every block holds the
//     same mean and 1/sqrt(var + eps) without a second launch or a trip
//     through global memory.  Every tree level is a warp shuffle, and the
//     merge has no branch and no IEEE division: a dozen levels behind
//     __syncthreads, each with a division, made most of a small shape's
//     time in a first version.
//   * The block then applies y = x * a + b (a = rstd * scale, b = bias -
//     mean * a) and SiLU (__expf and __fdividef: the precise expf and
//     division made this phase instruction-bound at one block an SM) from
//     its shared-memory copy, and from global memory for the rest, newest
//     first, and writes float4s.  A cluster barrier at the end keeps every
//     block's shared memory alive until its peers have read its partial.
// Which of the 256 px VAE's resblock shapes stay on chip (batch 1 or 8
// alike, since a cluster covers one batch element): (128, 128) (16-channel
// slices), (64, 256), (32, 512), (64, 512) entirely; (128, 256) 69 % and
// (256, 128) 31 % of each block's chunk, the rest read a second time
// (mostly from L2 at batch 1).
// No float atomics and a fixed merge order: a map gives the same bits on
// every run, and the partition depends on (H*W, C, G) only, so an image's
// result does not depend on the batch it is in.  Sum and sum-of-squares in
// one f32 pass would cancel over 2.6e5 elements; Welford/Chan does not.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_CLUSTER = 16;           // blocks per cluster, at most
constexpr int MIN_BLOCK_PX = 256;         // pixels per block, at least
constexpr int TILE_SHARED = 92 * 1024;    // x on chip, two blocks an SM
constexpr int TILE_ALONE = 160 * 1024;    // x on chip, one block an SM
constexpr int LOADS = 4;                  // global reads in flight a thread
constexpr int MAX_DEVICES = 64;           // cards whose settings are kept

struct Plan {
  int cs;       // channels per slice
  int ns;       // slices
  int cl;       // blocks per cluster (one cluster per batch element, slice)
  int threads;  // per block
  int chunk;    // pixels per block
  int kmax;     // pixels per thread, at most
  int kcap;     // of those, kept in shared memory
  size_t smem;
};

// the fewest whole groups (cg channels each) that make at least `want`
// channels, a multiple of 4, and divide c
int slice_channels(int c, int cg_, int want) {
  want = want < c ? want : c;
  for (int d = 4; d < c; d += 4)
    if (c % d == 0 && d % cg_ == 0 && d >= want) return d;
  return c;
}

Plan make_plan(int hw, int c, int groups) {
  Plan p;
  const int cg_ = c / groups;
  // 32-channel slices (a 128-byte run per pixel).  A map of at most 4
  // such slices makes at most 4 clusters, i.e. 4 GPCs at batch 1: it takes
  // 16-channel slices if one still fits on chip in 16 blocks, else blocks
  // of up to 1024 threads, one an SM, that keep 160 KB each on chip.
  const int cs32 = slice_channels(c, cg_, 32);
  const int cs16 = slice_channels(c, cg_, 16);
  int max_threads = 512, tile = TILE_SHARED;
  p.cs = cs32;
  if (c / cs32 <= 4) {
    if (cs16 < cs32 && (long long)hw * cs16 * 4 <= (long long)MAX_CLUSTER *
                                                         TILE_SHARED) {
      p.cs = cs16;
    } else {
      max_threads = MAX_THREADS;
      tile = TILE_ALONE;
    }
  }
  p.ns = c / p.cs;
  const int q4 = p.cs / 4;
  const int gps = p.cs / cg_;
  const int blocks = (hw + MIN_BLOCK_PX - 1) / MIN_BLOCK_PX;
  p.cl = blocks < 1 ? 1 : blocks > MAX_CLUSTER ? MAX_CLUSTER : blocks;
  p.chunk = (hw + p.cl - 1) / p.cl;
  // 256 threads, doubled while each would still get over 8 float4s
  p.threads = 256;
  while (p.threads < max_threads && (long long)p.chunk * q4 > 8LL * p.threads)
    p.threads *= 2;
  const int lanes = p.threads / q4;
  p.kmax = (p.chunk + lanes - 1) / lanes;
  const int cap = tile / (p.threads * 16);
  p.kcap = p.kmax < cap ? p.kmax : cap;
  p.smem = (size_t)p.kcap * p.threads * 16 +
           sizeof(float) * ((size_t)lanes * (1 + 2 * p.cs) + 1 + 5 * gps);
  return p;
}

// (n, mean, m2) <- (n, mean, m2) (+) (nb, meanb, m2b)   (Chan et al.).
// Branch-free: counts are whole numbers, so tot >= 1 unless both are
// empty; an empty side leaves the other as it was (wb = 0, or the copy).
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2,
                                           float nb, float meanb, float m2b) {
  const float tot = n + nb;
  const float wb = __fdividef(nb, fmaxf(tot, 1.f));
  const float delta = meanb - mean;
  const float mean_m = fmaf(delta, wb, mean);
  const float m2_m = m2 + m2b + delta * delta * n * wb;
  mean = n == 0.f ? meanb : mean_m;
  m2 = n == 0.f ? m2b : m2_m;
  n = tot;
}

// The lanes of each aligned group of `width` (a power of two) merge their
// values in a binary tree, lane l taking in lane l + s when l % 2s == 0,
// partners `stride` lanes of the warp apart.  Both partners merge (lower,
// upper), so every lane of the group ends with the same bits.
__device__ __forceinline__ void warp_merge(float& n, float& mean, float& m2,
                                           int idx, int width, int stride) {
  for (int s = 1; s < width; s *= 2) {
    const float no = __shfl_xor_sync(0xffffffffu, n, s * stride);
    const float mo = __shfl_xor_sync(0xffffffffu, mean, s * stride);
    const float qo = __shfl_xor_sync(0xffffffffu, m2, s * stride);
    const bool upper = idx & s;
    float nl = upper ? no : n, ml = upper ? mo : mean, ql = upper ? qo : m2;
    chan_merge(nl, ml, ql, upper ? n : no, upper ? mean : mo,
               upper ? m2 : qo);
    n = nl;
    mean = ml;
    m2 = ql;
  }
}

__device__ __forceinline__ int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// one more pixel; 1/n depends on the count only, off the data's chain
__device__ __forceinline__ void welford(float& n, float (&mean)[4],
                                        float (&m2)[4], float4 v) {
  const float vals[4] = {v.x, v.y, v.z, v.w};
  n += 1.f;
  const float inv = __fdividef(1.f, n);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float d = vals[j] - mean[j];
    mean[j] += d * inv;
    m2[j] += d * (vals[j] - mean[j]);
  }
}

__device__ __forceinline__ void cp_async16(float4* smem, const float4* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
gn_silu_fused(const float* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, float* __restrict__ out, int hw,
              int c, int cs, int cg_, int chunk, int kcap, float eps) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nt = blockDim.x;
  const int q4 = cs / 4;                 // float4s of a pixel's slice
  const int lanes = nt / q4;             // pixels in flight per block
  const int gps = cs / cg_;              // groups per slice
  const int cl = gridDim.x;              // the cluster spans blockIdx.x
  const int rank = blockIdx.x;
  const int slice = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, quad = tid % q4, lane = tid / q4;
  const bool active = lane < lanes;

  extern __shared__ float4 smem4[];
  float4* tile = smem4;                                    // [kcap][nt]
  float* s_cnt = reinterpret_cast<float*>(tile + (size_t)kcap * nt);
  float* s_mean = s_cnt + lanes + 1;                       // [lanes][cs]
  float* s_m2 = s_mean + lanes * cs;                       // [lanes][cs]
  float* part = s_m2 + lanes * cs;                         // [gps][3]
  float* stat = part + 3 * gps;                            // [gps][2]

  // this thread's pixels: p0 + lane + k * lanes, k < kn; the first kc of
  // them go through shared memory
  const int c4 = c / 4;
  const int p0 = rank * chunk;
  const int npx = max(min(p0 + chunk, hw) - p0, 0);
  const int kn = active && lane < npx ? (npx - lane + lanes - 1) / lanes : 0;
  const int kc = min(kn, kcap);
  const size_t step = (size_t)lanes * c4;
  const size_t off = ((size_t)b * hw + p0 + lane) * c4 + slice * q4 + quad;
  const float4* xb = reinterpret_cast<const float4*>(x) + off;
  float4* ob = reinterpret_cast<float4*>(out) + off;

  for (int k = 0; k < kc; ++k) cp_async16(tile + k * nt + tid, xb + k * step);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  float n = 0.f;
  float mean[4] = {0.f, 0.f, 0.f, 0.f};
  float m2[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = kc; k0 < kn; k0 += LOADS) {   // LOADS reads in flight
    float4 v[LOADS];
#pragma unroll
    for (int i = 0; i < LOADS; ++i)
      if (k0 + i < kn) v[i] = __ldg(xb + (k0 + i) * step);
#pragma unroll
    for (int i = 0; i < LOADS; ++i)
      if (k0 + i < kn) welford(n, mean, m2, v[i]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll 8
  for (int k = 0; k < kc; ++k) welford(n, mean, m2, tile[k * nt + tid]);

  // Statistics, in a fixed order: binary trees over pixel lanes, then
  // over a group's channels, then over the cluster's blocks.  (1) Where q4
  // divides 32 a warp holds 32 / q4 whole lanes: their tree by shuffles.
  // (2) One row per lane group to shared memory; per channel, lanes of a
  // warp merge the rows (lane r takes rows r, r + 32, .. in order, then a
  // shuffle tree).  (3) Per group, its channels the same way, into the
  // block's partial.
  const int l0 = 32 % q4 == 0 ? 32 / q4 : 1;
  for (int s = 1; s < l0; s *= 2) {
    const bool upper = lane & s;
    const float no = __shfl_xor_sync(0xffffffffu, n, s * q4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float mo = __shfl_xor_sync(0xffffffffu, mean[j], s * q4);
      const float qo = __shfl_xor_sync(0xffffffffu, m2[j], s * q4);
      float nl = upper ? no : n, ml = upper ? mo : mean[j];
      float ql = upper ? qo : m2[j];
      chan_merge(nl, ml, ql, upper ? n : no, upper ? mean[j] : mo,
                 upper ? m2[j] : qo);
      mean[j] = ml;
      m2[j] = ql;
    }
    n += no;
  }
  const int rows = lanes / l0;
  if (active && (lane & (l0 - 1)) == 0) {
    const int r = lane / l0;
    if (quad == 0) s_cnt[r] = n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s_mean[r * cs + 4 * quad + j] = mean[j];
      s_m2[r * cs + 4 * quad + j] = m2[j];
    }
  }
  __syncthreads();
  // (2), (3), (4): a warp pass holds 32 / w trees of width w side by side
  const int warp = tid / 32, wl = tid % 32, nwarps = nt / 32;
  const int row_w = pow2_at_least(min(rows, 32));
  for (int e = warp * (32 / row_w) + wl / row_w; e - wl / row_w < cs;
       e += nwarps * (32 / row_w)) {
    const int r0 = wl % row_w;
    float rn = 0.f, rm = 0.f, rq = 0.f;
    if (e < cs)
      for (int r = r0; r < rows; r += 32)
        chan_merge(rn, rm, rq, s_cnt[r], s_mean[r * cs + e],
                   s_m2[r * cs + e]);
    warp_merge(rn, rm, rq, r0, row_w, 1);
    if (r0 == 0 && e < cs) {      // row 0 of channel e, in place
      s_mean[e] = rm;
      s_m2[e] = rq;
      if (e == 0) s_cnt[lanes] = rn;      // the block's pixel count
    }
  }
  __syncthreads();
  const float bn = s_cnt[lanes];
  const int chan_w = pow2_at_least(min(cg_, 32));
  for (int gi = warp * (32 / chan_w) + wl / chan_w; gi - wl / chan_w < gps;
       gi += nwarps * (32 / chan_w)) {
    const int j0 = wl % chan_w;
    float gn = 0.f, gm = 0.f, gq = 0.f;
    if (gi < gps)
      for (int j = j0; j < cg_; j += 32)
        chan_merge(gn, gm, gq, bn, s_mean[gi * cg_ + j], s_m2[gi * cg_ + j]);
    warp_merge(gn, gm, gq, j0, chan_w, 1);
    if (j0 == 0 && gi < gps) {
      part[3 * gi] = gn;
      part[3 * gi + 1] = gm;
      part[3 * gi + 2] = gq;
    }
  }

  // (4) Cluster: per group, lane r reads rank r's partial out of its shared
  // memory (distributed shared memory), and the ranks merge in the same
  // kind of tree; every block gets the same bits.
  cluster.sync();
  const int rank_w = pow2_at_least(cl);
  for (int gi = warp * (32 / rank_w) + wl / rank_w; gi - wl / rank_w < gps;
       gi += nwarps * (32 / rank_w)) {
    const int r = wl % rank_w;
    float gn = 0.f, gm = 0.f, gq = 0.f;
    if (gi < gps && r < cl) {
      const float* rp = cluster.map_shared_rank(part, r) + 3 * gi;
      gn = rp[0];
      gm = rp[1];
      gq = rp[2];
    }
    warp_merge(gn, gm, gq, r, rank_w, 1);
    if (r == 0 && gi < gps) {
      stat[2 * gi] = gm;
      stat[2 * gi + 1] = rsqrtf(gq / gn + eps);
    }
  }
  // done reading the peers; they wait for that before they exit
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();

  // y = x * a + b with a = rstd * scale, b = bias - mean * a; silu(y)
  if (active) {
    float a[4], sh[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = 4 * quad + j;
      const int ch = slice * cs + e;
      a[j] = stat[2 * (e / cg_) + 1] * __ldg(scale + ch);
      sh[j] = __ldg(bias + ch) - stat[2 * (e / cg_)] * a[j];
    }
    auto apply = [&](float4 v) {
      float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float y = fmaf(vals[j], a[j], sh[j]);
        vals[j] = __fdividef(y, 1.f + __expf(-y));
      }
      return make_float4(vals[0], vals[1], vals[2], vals[3]);
    };
#pragma unroll 8
    for (int k = 0; k < kc; ++k) ob[k * step] = apply(tile[k * nt + tid]);
    // newest first: the pixels read last for the statistics are the
    // likeliest still in L2
    for (int k0 = kn - 1; k0 >= kc; k0 -= LOADS) {
      float4 v[LOADS];
#pragma unroll
      for (int i = 0; i < LOADS; ++i)
        if (k0 - i >= kc) v[i] = __ldg(xb + (k0 - i) * step);
#pragma unroll
      for (int i = 0; i < LOADS; ++i)
        if (k0 - i >= kc) ob[(k0 - i) * step] = apply(v[i]);
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

std::mutex allow_lock;

// Let the kernel take `smem` bytes of shared memory and clusters of 16 on
// the current device.  Kernel attributes hold for one device, so what was
// allowed is kept per device.  The attribute only ever grows; the lock
// keeps two threads from setting it in turn and shrinking it.
cudaError_t allow(size_t smem) {
  static size_t allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(allow_lock);
  if (allowed[dev] == 0)
    e = cudaFuncSetAttribute(gn_silu_fused,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && smem > allowed[dev]) {
    e = cudaFuncSetAttribute(gn_silu_fused,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess) allowed[dev] = smem;
  }
  return e;
}

// grid (cl, slices, b), one cluster of cl blocks along x
cudaLaunchConfig_t config(const Plan& p, int b, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cl, p.ns, b);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // one block an SM where the SMs allow it: a 16-block cluster packed two
  // to an SM would leave half a GPC's SMs, and their bandwidth, idle
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference =
      cudaClusterSchedulingPolicySpread;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cfg;
}

}  // namespace

extern "C" {

int groupnorm_silu_max_channels() { return 4 * 256; }

// The partition of a (hw, c) map at `groups` groups: out[0..6] = channels
// per slice, slices, blocks per cluster, threads per block, pixels per
// block, pixels per thread, of those kept in shared memory; out[7] =
// shared memory per block in bytes.
void groupnorm_silu_plan(int hw, int c, int groups, long long* out) {
  const Plan p = make_plan(hw, c, groups);
  out[0] = p.cs;
  out[1] = p.ns;
  out[2] = p.cl;
  out[3] = p.threads;
  out[4] = p.chunk;
  out[5] = p.kmax;
  out[6] = p.kcap;
  out[7] = (long long)p.smem;
}

// One launch; returns its cudaGetLastError() (or the error of setting the
// kernel's attributes).
int groupnorm_silu_launch(const float* x, const float* scale,
                          const float* bias, float* out, int b, int hw, int c,
                          int groups, float eps, cudaStream_t stream) {
  const Plan p = make_plan(hw, c, groups);
  cudaError_t e = allow(p.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = config(p, b, stream, attr);
  e = cudaLaunchKernelEx(&cfg, gn_silu_fused, x, scale, bias, out, hw, c,
                         p.cs, c / groups, p.chunk, p.kcap, eps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of this shape's plan the device can hold at once (0:
// the launch would fail).
int groupnorm_silu_max_clusters(int hw, int c, int groups) {
  const Plan p = make_plan(hw, c, groups);
  int n = 0;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = config(p, 1, 0, attr);
  if (allow(p.smem) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, gn_silu_fused, &cfg) != cudaSuccess)
    n = 0;
  return n;
}

}  // extern "C"
