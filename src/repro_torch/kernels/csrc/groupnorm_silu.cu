// Fused GroupNorm + SiLU over NHWC feature maps, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `groupnorm_silu` (body `_gn_kernel`) of
// repro/kernels/groupnorm_silu.py:
//   y = silu((x - mean_g) * rsqrt(var_g + eps) * scale[c] + bias[c])
// with the statistics of each (batch element, channel group) taken in f32
// over all H*W pixels and the group's C/G channels.
//
// Inputs: x (B, H*W, C) f32 contiguous (NHWC), scale/bias (C,) f32.
// Output: like x.  Requires C % 4 == 0, C <= 4 * THREADS, G | C.
//
// Bound on the card: memory.  One read and one write of x (the statistics
// need a second read, which this design pays: 3 passes over x's bytes, or
// 1.5x the bound).  A few operations per element, far below the f32 rate.
//
// The TPU kernel holds one whole (H, W, C) map per grid step in VMEM and
// reduces it there; at 256x256x128 f32 that is 33.5 MB, and one program per
// batch element would leave 131 of 132 SMs idle at batch 1.  Here:
//   1. gn_partial_stats: one block per (chunk of pixel rows, batch element).
//      Each thread owns one float4 of channels and a pixel lane; a warp
//      reads whole pixel rows, so loads are coalesced 16-byte accesses.
//      Each thread keeps a Welford (count, mean, M2) per channel; the block
//      merges them per group (Chan's formula, fixed order) into one partial
//      per (batch, chunk, group).
//   2. gn_merge: one block per (group, batch element) merges the chunk
//      partials with the same formula, in a fixed tree order, into mean and
//      1/sqrt(var + eps).
//   3. gn_apply: elementwise normalise, affine and SiLU, float4 in and out.
// No float atomics and a fixed merge order: a map gives the same bits on
// every run, and the chunking depends on H*W and C only, so an image's
// result does not depend on the batch it is in.  Sum and sum-of-squares in
// one f32 pass would cancel over 2.6e5 elements; Welford/Chan does not.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MERGE_THREADS = 128;
constexpr int CHUNK_ELEMS = 16384;   // floats of x per stats block

// (n, mean, m2) <- (n, mean, m2) (+) (nb, meanb, m2b)   (Chan et al.)
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2,
                                           float nb, float meanb, float m2b) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb;
    mean = meanb;
    m2 = m2b;
    return;
  }
  const float tot = n + nb;
  const float wb = nb / tot;
  const float delta = meanb - mean;
  mean = mean + delta * wb;
  m2 = m2 + m2b + delta * delta * n * wb;
  n = tot;
}

__global__ void __launch_bounds__(THREADS)
gn_partial_stats(const float* __restrict__ x, float* __restrict__ part,
                 int hw, int c, int groups, int chunk_px, int n_chunks) {
  extern __shared__ float smem[];                 // (lanes, c) x 2
  const int q4 = c / 4;
  const int lanes = THREADS / q4;                 // pixel lanes per block
  const int quad = threadIdx.x % q4;
  const int lane = threadIdx.x / q4;
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int p0 = chunk * chunk_px;
  const int p1 = min(p0 + chunk_px, hw);
  const float4* xb =
      reinterpret_cast<const float4*>(x) + (size_t)b * hw * q4;

  float n = 0.f;
  float mean[4] = {0.f, 0.f, 0.f, 0.f};
  float m2[4] = {0.f, 0.f, 0.f, 0.f};
  if (lane < lanes) {
    for (int p = p0 + lane; p < p1; p += lanes) {
      const float4 v = __ldg(xb + (size_t)p * q4 + quad);
      const float vals[4] = {v.x, v.y, v.z, v.w};
      n += 1.f;
      const float inv = 1.f / n;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = vals[j] - mean[j];
        mean[j] += d * inv;
        m2[j] += d * (vals[j] - mean[j]);
      }
    }
  }
  float* s_mean = smem;
  float* s_m2 = smem + lanes * c;
  if (lane < lanes) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s_mean[lane * c + quad * 4 + j] = mean[j];
      s_m2[lane * c + quad * 4 + j] = m2[j];
    }
  }
  __syncthreads();

  // per group: merge (lane, channel) stats in lane-major, channel order
  const int cg = c / groups;
  const int span = p1 - p0;
  for (int g = threadIdx.x; g < groups; g += THREADS) {
    float gn = 0.f, gmean = 0.f, gm2 = 0.f;
    for (int l = 0; l < lanes; ++l) {
      const float nl = l < span ? (float)((span - l + lanes - 1) / lanes) : 0.f;
      for (int ch = g * cg; ch < (g + 1) * cg; ++ch)
        chan_merge(gn, gmean, gm2, nl, s_mean[l * c + ch], s_m2[l * c + ch]);
    }
    float* out = part + (((size_t)b * n_chunks + chunk) * groups + g) * 3;
    out[0] = gn;
    out[1] = gmean;
    out[2] = gm2;
  }
}

__global__ void __launch_bounds__(MERGE_THREADS)
gn_merge(const float* __restrict__ part, float* __restrict__ stats,
         int n_chunks, int groups, float eps) {
  __shared__ float s_n[MERGE_THREADS];
  __shared__ float s_mean[MERGE_THREADS];
  __shared__ float s_m2[MERGE_THREADS];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int ch = t; ch < n_chunks; ch += MERGE_THREADS) {
    const float* p = part + (((size_t)b * n_chunks + ch) * groups + g) * 3;
    chan_merge(n, mean, m2, p[0], p[1], p[2]);
  }
  s_n[t] = n;
  s_mean[t] = mean;
  s_m2[t] = m2;
  __syncthreads();
  for (int s = MERGE_THREADS / 2; s > 0; s >>= 1) {
    if (t < s) {
      chan_merge(n, mean, m2, s_n[t + s], s_mean[t + s], s_m2[t + s]);
      s_n[t] = n;
      s_mean[t] = mean;
      s_m2[t] = m2;
    }
    __syncthreads();
  }
  if (t == 0) {
    float* out = stats + ((size_t)b * groups + g) * 2;
    out[0] = mean;
    out[1] = 1.f / sqrtf(m2 / n + eps);
  }
}

__global__ void __launch_bounds__(THREADS)
gn_apply(const float* __restrict__ x, const float* __restrict__ stats,
         const float* __restrict__ scale, const float* __restrict__ bias,
         float* __restrict__ out, int hw, int c, int groups) {
  const int q4 = c / 4;
  const int cg = c / groups;
  const int b = blockIdx.y;
  const int per_b = hw * q4;
  const float4* xb = reinterpret_cast<const float4*>(x) + (size_t)b * per_b;
  float4* ob = reinterpret_cast<float4*>(out) + (size_t)b * per_b;
  const float* st = stats + (size_t)b * groups * 2;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < per_b;
       i += gridDim.x * THREADS) {
    const int c0 = (i % q4) * 4;
    const float4 v = __ldg(xb + i);
    float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = c0 + j;
      const int g = ch / cg;
      const float y = (vals[j] - __ldg(st + 2 * g)) * __ldg(st + 2 * g + 1) *
                          __ldg(scale + ch) +
                      __ldg(bias + ch);
      vals[j] = y / (1.f + expf(-y));
    }
    ob[i] = make_float4(vals[0], vals[1], vals[2], vals[3]);
  }
}

int chunk_pixels(int c) { return CHUNK_ELEMS / c > 0 ? CHUNK_ELEMS / c : 1; }

}  // namespace

extern "C" {

// Chunks of pixel rows per map: the partials buffer holds
// b * groupnorm_silu_chunks(hw, c) * groups * 3 floats, stats b * groups * 2.
int groupnorm_silu_chunks(int hw, int c) {
  const int px = chunk_pixels(c);
  return (hw + px - 1) / px;
}

int groupnorm_silu_max_channels() { return 4 * THREADS; }

// Returns cudaGetLastError() after the three launches.
int groupnorm_silu_launch(const float* x, const float* scale,
                          const float* bias, float* out, float* part,
                          float* stats, int b, int hw, int c, int groups,
                          float eps, cudaStream_t stream) {
  const int px = chunk_pixels(c);
  const int n_chunks = (hw + px - 1) / px;
  const int lanes = THREADS / (c / 4);
  const size_t smem = (size_t)2 * lanes * c * sizeof(float);
  gn_partial_stats<<<dim3(n_chunks, b), THREADS, smem, stream>>>(
      x, part, hw, c, groups, px, n_chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gn_merge<<<dim3(groups, b), MERGE_THREADS, 0, stream>>>(part, stats,
                                                          n_chunks, groups,
                                                          eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int per_b = hw * (c / 4);
  int blocks = (per_b + THREADS - 1) / THREADS;
  if (blocks > 4096) blocks = 4096;
  gn_apply<<<dim3(blocks, b), THREADS, 0, stream>>>(x, stats, scale, bias,
                                                    out, hw, c, groups);
  return (int)cudaGetLastError();
}

}  // extern "C"
