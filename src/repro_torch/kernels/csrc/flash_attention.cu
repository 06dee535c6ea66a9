// Online-softmax (flash) attention forward on Hopper's tensor cores, at f32
// accuracy (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` of
// repro/kernels/flash_attention.py: softmax(q k^T / sqrt(D)) v over
// (B, S, H, D) f32 tensors, with a padded-length mask and the end-aligned
// causal option (row r sees keys <= r + Sk - Sq).  Masked logits carry the
// same -1e30 sentinel as the TPU kernel; the running max, sum and
// accumulator stay in f32.
//
// What bounds it.  4*B*H*Sq*Sk*D flops of products, against 25 MB of
// q/k/v/o at the DiT-B/2 shapes: operations.  On the CUDA cores that is the
// 67 TFLOP/s f32 rate.  The tensor cores take TF32 (10-bit mantissa), and a
// single TF32 product is off by ~1e-3 from f32 here, 40x the kernels'
// 2e-5 tolerance.  So every product is split (3xTF32): x = hi + lo with
// hi = rna_tf32(x) and lo = rna_tf32(x - hi) (round to nearest, as
// cvt.rna.tf32.f32, see to_tf32; x - hi is exact in f32), and
// a.b = lo_a.hi_b + hi_a.lo_b + hi_a.hi_b, the small terms first,
// into one f32 accumulator; lo.lo (2^-22 relative) is dropped.  Three
// TF32 products against 495 TFLOP/s dense is still 2.4x the f32 rate.
//
// Design:
//   * mma.sync.aligned.m16n8k8 TF32 for both products, one warp owning 16
//     query rows.  wgmma (64-row warpgroup tiles from shared memory) is the
//     next step: TF32 wgmma takes only K-major operands, so P.V would need
//     V transposed into a keys-contiguous shared tile and P staged through
//     shared memory; with mma.sync, P stays in registers: the S
//     accumulator's layout (thread holds keys 2t, 2t+1 of each 8-key
//     n-tile) becomes P.V's A fragment by numbering the 8 keys of a k-step
//     so that A's column t is key 2t and column t+4 is key 2t+1; the V
//     fragment reads rows 2t and 2t+1 to match.  No shuffle, no shared
//     round trip.
//   * Q is pre-scaled by log2(e)/sqrt(D) and split once; its hi/lo
//     fragments stay in registers (D <= 64) or in the warp's own slice of
//     shared memory (D = 128, where registers would spill).  Softmax runs
//     in base 2 (exp2f).
//   * K/V tiles of 64 keys go through a two-stage ring in shared memory
//     filled by 16-byte cp.async (rows past Sk zero-filled): the tiles of
//     step i + 1 land while those of step i are computed, with one
//     __syncthreads per step (one stage when a single step covers Sk).  K rows
//     are padded to D + 8 floats and V rows to D + 4, so that the fragment
//     loads, 8 bytes of K (key g, dims 2t, 2t + 1) and 4 of V (key 2t,
//     dim g), hit distinct banks.
//   * The operand splits cost more instructions than the mmas (5 integer
//     and float ops per element, and each warp splits every K/V fragment
//     it reads); each 3xTF32 product runs all lo.hi mmas of a row of
//     n-tiles, then all hi.lo, then all hi.hi, so that consecutive
//     mma.syncs never wait on one accumulator.
//   * Occupancy: a block is qw row groups (16 rows, one warp each) x kw
//     key slots.  qw = 4 where that gives at least half the SMs a block,
//     else halved; then kw fills the block to 4 warps: the kw warps of a
//     row group take every kw-th key tile and hand their (max, sum,
//     accumulator) to slot 0 through shared memory, which merges them in
//     slot order.  At S=256, H=12: B=1 runs 96 blocks of 2 x 2 warps, each
//     warp two tiles; B=2, 4 and 8 4 x 1.
//   * Causal: a block stops after the last tile its last row can see.
// Inputs may be strided views (the DiT passes q, k, v as slices of one
// fused qkv tensor); only the last axis must be contiguous, and rows must
// be 16-byte aligned (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BK = 64;          // keys per tile
constexpr int ROWS = 16;        // query rows per warp (the mma's M)
constexpr int MAX_WARPS = 4;
constexpr int NK = BK / 8;      // 8-key n-tiles of S (k-steps of P.V)
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Shape {
  static constexpr int LDK = D + 8;           // padded smem rows (floats)
  static constexpr int LDV = D + 4;
  static constexpr int STAGE = BK * (LDK + LDV);          // K then V
  static constexpr int KS = D / 8;            // k-steps of Q.K^T, n-tiles of O
  static constexpr int NB = KS < 8 ? KS : 8;  // n-tiles of O per P.V batch
  static constexpr bool Q_IN_REGS = D <= 64;
  static constexpr int Q_FLOATS_PER_WARP = Q_IN_REGS ? 0 : KS * 2 * 32 * 4;
  static constexpr int MERGE = 4 + 4 * KS;    // m, l, acc of a lane
};

// cvt.rna.tf32.f32 done on the bits: add half an ulp of the 10-bit
// mantissa to the magnitude and clear the 13 low bits (round to nearest,
// ties away).  Bit for bit the same as the PTX cvt for finite x, in 2
// integer instructions; ptxas expands the cvt with a NaN guard (compare
// and select), which made the kernel 30 % more instructions
// (tools/kernel_diag.py).  The compiler cannot fold x - hi through
// integer ops either.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32, rounded to nearest
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[n0 + i] += a.b[i] for N independent n-tiles at f32 accuracy: all
// lo.hi, then all hi.lo, then all hi.hi, so that consecutive mma.syncs never
// wait on each other's accumulator
template <int N, int M>
__device__ __forceinline__ void mma_3xtf32(float (&d)[M][4], const int n0,
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const float (&b)[N][2]) {
  uint32_t bh[N][2], bl[N][2];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    split(b[i][0], bh[i][0], bl[i][0]);
    split(b[i][1], bh[i][1], bl[i][1]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[n0 + i], al, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[n0 + i], ah, bl[i][0], bl[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[n0 + i], ah, bh[i][0], bh[i][1]);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

// K and V tiles t0 .. t0 + kw - 1 (those < n_tiles) into the kw slots at
// `stage`, as one commit group; key rows >= sk are zero-filled
template <int D>
__device__ __forceinline__ void load_tiles(float* stage, const float* kb,
                                           const float* vb, long long k_ss,
                                           long long v_ss, int t0, int kw,
                                           int n_tiles, int sk) {
  using S = Shape<D>;
  constexpr int C4 = D / 4;
  for (int slot = 0; slot < kw && t0 + slot < n_tiles; ++slot) {
    float* ks = stage + slot * S::STAGE;
    float* vs = ks + BK * S::LDK;
    const int k0 = (t0 + slot) * BK;
    for (int e = threadIdx.x; e < BK * C4; e += blockDim.x) {
      const int r = e / C4, c = 4 * (e % C4);
      const bool ok = k0 + r < sk;
      cp_async16(ks + r * S::LDK + c, ok ? kb + (k0 + r) * k_ss + c : kb,
                 ok);
      cp_async16(vs + r * S::LDV + c, ok ? vb + (k0 + r) * v_ss + c : vb,
                 ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int D>
__global__ void __launch_bounds__(32 * MAX_WARPS)
flash_fwd_tc(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int n_heads,
             int sq, int sk, long long q_sb, long long q_ss, long long q_sh,
             long long k_sb, long long k_ss, long long k_sh, long long v_sb,
             long long v_ss, long long v_sh, float qscale, int causal,
             int kw) {
  using S = Shape<D>;
  constexpr int LDK = S::LDK, LDV = S::LDV, KS = S::KS, NB = S::NB;
  extern __shared__ float4 smem4[];
  float* kv = reinterpret_cast<float*>(smem4);   // [stage][K | V][BK][LD*]

  // warp = (key slot kwi) x (row group qw): kw warps share 16 rows and
  // take every kw-th key tile, merged at the end
  const int qwarps = blockDim.x / 32 / kw;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qw = warp % qwarps, kwi = warp / qwarps;
  const int g = lane / 4, t4 = lane % 4;         // mma groupID, thread in group
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * qwarps * ROWS;     // the block's first row
  const int r0 = q0 + qw * ROWS;                 // the warp's first row
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  int n_tiles = (sk + BK - 1) / BK;
  if (causal) {
    const int last = min(q0 + qwarps * ROWS, sq) - 1 + sk - sq;
    n_tiles = min(n_tiles, last / BK + 1);
  }
  const int n_iter = (n_tiles + kw - 1) / kw;
  const int stages = n_iter > 1 ? 2 : 1;
  load_tiles<D>(kv, kb, vb, k_ss, v_ss, 0, kw, n_tiles, sk);

  // Q's A fragments, pre-scaled and split.  The 8 dims of k-step kk are
  // numbered so that A's column t4 is dim 8kk + 2t4 and column t4 + 4 is
  // dim 8kk + 2t4 + 1 (the sum over dims does not care); K's fragment is
  // then one 8-byte load: a0 (g, 2t4), a1 (g + 8, 2t4), a2 (g, 2t4 + 1),
  // a3 (g + 8, 2t4 + 1)
  uint32_t qh_r[S::Q_IN_REGS ? KS : 1][4], ql_r[S::Q_IN_REGS ? KS : 1][4];
  uint4* qsm = reinterpret_cast<uint4*>(kv + stages * kw * S::STAGE) +
               warp * (S::Q_FLOATS_PER_WARP / 4);   // [kk][hi | lo][lane]
  {
    const bool ok0 = r0 + g < sq, ok1 = r0 + g + 8 < sq;
    const float* row0 = qb + (long long)(r0 + g) * q_ss;
    const float* row1 = qb + (long long)(r0 + g + 8) * q_ss;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = 8 * kk + 2 * t4;
      const float a[4] = {ok0 ? row0[c] * qscale : 0.f,
                          ok1 ? row1[c] * qscale : 0.f,
                          ok0 ? row0[c + 1] * qscale : 0.f,
                          ok1 ? row1[c + 1] * qscale : 0.f};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(a[i], hi[i], lo[i]);
      if constexpr (S::Q_IN_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qh_r[kk][i] = hi[i];
          ql_r[kk][i] = lo[i];
        }
      } else {
        qsm[(2 * kk) * 32 + lane] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        qsm[(2 * kk + 1) * 32 + lane] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
  }

  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m[2] = {MASKED, MASKED};   // rows g and g + 8
  float l[2] = {0.f, 0.f};         // this thread's share of the row sums

  for (int it = 0; it < n_iter; ++it) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();     // tiles of it visible to all; it - 1 no longer read
    if (it + 1 < n_iter)
      load_tiles<D>(kv + ((it + 1) & 1) * kw * S::STAGE, kb, vb, k_ss, v_ss,
                    (it + 1) * kw, kw, n_tiles, sk);
    const int t = it * kw + kwi;
    if (t >= n_tiles) continue;
    const float* ks = kv + ((it & (stages - 1)) * kw + kwi) * S::STAGE;
    const float* vs = ks + BK * LDK;

    // S = Q K^T: n-tile j holds keys 8j + 2t4, 8j + 2t4 + 1 of rows g, g + 8
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (S::Q_IN_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[i] = qh_r[kk][i];
          al[i] = ql_r[kk][i];
        }
      } else {
        const uint4 hv = qsm[(2 * kk) * 32 + lane];
        const uint4 lv = qsm[(2 * kk + 1) * 32 + lane];
        ah[0] = hv.x; ah[1] = hv.y; ah[2] = hv.z; ah[3] = hv.w;
        al[0] = lv.x; al[1] = lv.y; al[2] = lv.z; al[3] = lv.w;
      }
      float kf[NK][2];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float2 x = *reinterpret_cast<const float2*>(
            ks + (8 * j + g) * LDK + 8 * kk + 2 * t4);
        kf[j][0] = x.x;
        kf[j][1] = x.y;
      }
      mma_3xtf32<NK>(s, 0, ah, al, kf);
    }

    const int k0 = t * BK;
    if (causal || k0 + BK > sk) {
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = k0 + 8 * j + 2 * t4 + (i & 1);
          const int row = r0 + g + 8 * (i >> 1);
          if (col >= sk || (causal && row + sk - sq < col)) s[j][i] = MASKED;
        }
    }

    // online softmax in base 2; the row max over the quad of a row
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = MASKED;
#pragma unroll
      for (int j = 0; j < NK; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float corr = exp2f(m[hr] - m_new);
      m[hr] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        s[j][2 * hr] = exp2f(s[j][2 * hr] - m_new);
        s[j][2 * hr + 1] = exp2f(s[j][2 * hr + 1] - m_new);
        rs += s[j][2 * hr] + s[j][2 * hr + 1];
      }
      l[hr] = l[hr] * corr + rs;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        acc[n][2 * hr] *= corr;
        acc[n][2 * hr + 1] *= corr;
      }
    }

    // O += P V; k-step j covers keys 8j..8j+7, A column t4 = key 2t4 and
    // column t4 + 4 = key 2t4 + 1, so P's fragment is S's accumulator
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      uint32_t ph[4], pl[4];
      split(s[j][0], ph[0], pl[0]);
      split(s[j][2], ph[1], pl[1]);
      split(s[j][1], ph[2], pl[2]);
      split(s[j][3], ph[3], pl[3]);
      const float* vp = vs + (8 * j + 2 * t4) * LDV + g;
#pragma unroll
      for (int n0 = 0; n0 < KS; n0 += NB) {
        float vf[NB][2];
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          vf[n][0] = vp[8 * (n0 + n)];
          vf[n][1] = vp[LDV + 8 * (n0 + n)];
        }
        mma_3xtf32<NB>(acc, n0, ph, pl, vf);
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  if (kw > 1) {
    // key slots 1.. hand (m, l, acc) to slot 0 through shared memory
    // ([slot - 1][qw][field][lane]); slot 0 merges them in slot order
    constexpr int MS = S::MERGE;
    __syncthreads();     // every warp is done with the K/V stages
    float* mrg = kv + qw * MS * 32;
    const int stride = qwarps * MS * 32;
    if (kwi > 0) {
      float* p = mrg + (kwi - 1) * stride + lane;
      p[0] = m[0];
      p[32] = m[1];
      p[64] = l[0];
      p[96] = l[1];
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) p[(4 + 4 * n + i) * 32] = acc[n][i];
    }
    __syncthreads();
    if (kwi > 0) return;
    for (int o = 1; o < kw; ++o) {
      const float* p = mrg + (o - 1) * stride + lane;
      float ca[2], cb[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float mo = p[32 * hr];
        const float m_new = fmaxf(m[hr], mo);
        ca[hr] = exp2f(m[hr] - m_new);
        cb[hr] = exp2f(mo - m_new);
        m[hr] = m_new;
        l[hr] = l[hr] * ca[hr] + p[64 + 32 * hr] * cb[hr];
      }
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[n][i] = acc[n][i] * ca[i >> 1] +
                      p[(4 + 4 * n + i) * 32] * cb[i >> 1];
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + g + 8 * hr;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[hr], 1e-30f);
    float* orow = o + (((long long)b * sq + row) * n_heads + h) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < KS; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(acc[n][2 * hr] * inv, acc[n][2 * hr + 1] * inv);
  }
}

constexpr int MAX_DEVICES = 64;       // cards whose settings are kept

// the current device's SM count, looked up once per device (132 where it
// cannot be read)
int sm_count() {
  static std::atomic<int> count[MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return 132;
  int n = count[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      n = 132;
    count[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

constexpr size_t SMEM_MAX = 232448;   // a block's shared memory on sm_90

struct Layout {
  int qw, kw;      // row groups x key slots = warps per block
  size_t smem;
};

template <int D>
size_t smem_bytes(int qw, int kw, int sk) {
  using S = Shape<D>;
  const int n_tiles = (sk + BK - 1) / BK;
  const int stages = (n_tiles + kw - 1) / kw > 1 ? 2 : 1;
  return sizeof(float) * ((size_t)stages * kw * S::STAGE +
                          (size_t)qw * kw * S::Q_FLOATS_PER_WARP);
}

// 4 row groups a block, halved while that would give under half the SMs a
// block; then the block is filled to 4 warps with key slots, as far as the
// key tiles and shared memory allow.  Measured at S=256, H=12 against
// every other layout (tools/kernel_diag.py): warps sharing a K/V tile
// beat more, smaller blocks down to half a wave.
template <int D>
Layout layout(int b, int h, int sq, int sk) {
  const int n_tiles = (sk + BK - 1) / BK;
  auto blocks = [&](int qw) {
    return (long long)b * h * ((sq + ROWS * qw - 1) / (ROWS * qw));
  };
  Layout L{MAX_WARPS, 1, 0};
  while (L.qw > 1 && 2 * blocks(L.qw) < sm_count()) L.qw /= 2;
  for (int kw = MAX_WARPS / L.qw; kw > 1; kw /= 2)
    if (kw <= n_tiles && smem_bytes<D>(L.qw, kw, sk) <= SMEM_MAX) {
      L.kw = kw;
      break;
    }
  L.smem = smem_bytes<D>(L.qw, L.kw, sk);
  return L;
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int b,
           int h, int sq, int sk, const long long* st, float scale,
           int causal, cudaStream_t stream) {
  // the attribute holds for one device: set once on each (always to the
  // same value, so threads that race set it alike)
  static std::atomic<bool> ready[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(flash_fwd_tc<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    ready[dev].store(true, std::memory_order_release);
  }
  const Layout L = layout<D>(b, h, sq, sk);
  dim3 grid((sq + ROWS * L.qw - 1) / (ROWS * L.qw), h, b);
  flash_fwd_tc<D><<<grid, 32 * L.qw * L.kw, L.smem, stream>>>(
      q, k, v, o, h, sq, sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale * LOG2E, causal, L.kw);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 inputs (flux-dev's MMDiT: head dim 128, up to 4352 tokens)
//
// The TPU kernel at bf16 loads bf16 tiles, upcasts them to f32, forms
// S = Q K^T * scale and P in f32, accumulates P V in f32 and writes the
// output in bf16.  Here:
//   * Q K^T on mma.sync m16n8k16 bf16 with f32 accumulation: the bf16
//     inputs are exact, so S is the TPU kernel's product up to the order of
//     summation.  The scale (times log2 e: softmax in base 2) multiplies the
//     f32 accumulator, never a bf16 operand.
//   * P V on the same instruction, P rounded to bf16: a relative error of
//     at most 2^-9 on each P entry, as the plain version's bf16
//     probabilities carry.  P split into bf16 hi + lo (two products, P
//     near f32; tools/kernel_diag.py builds it) came no closer to the f32
//     plain version at the bf16 output (1.6e-3 either way at gen_fast's
//     shape) and took 22 % longer.  The row sums l stay the f32 sums of
//     P, as on the TPU.
//   * A warp owns 16 query rows, a block four warps (64 rows) sharing K/V
//     tiles of 64 keys that stream through a two-stage cp.async ring
//     (16-byte copies, rows past Sk zero-filled).  Rows are padded by 8
//     bf16 (16 bytes), so that K's 4-byte fragment loads (key g, dims
//     2t, 2t + 1) and V's ldmatrix rows (8 x 16 bytes) hit distinct banks.
//   * Q's A fragments (16 rows x D) are loaded once from device memory into
//     registers.  S's accumulator is P's A fragment after packing to bf16:
//     n-tiles 2j and 2j + 1 of S (keys 16j .. 16j + 15) are k-step j of P V.
//     V's B fragments (keys 2t, 2t + 1 of dim g) come from
//     ldmatrix.x4.trans, four 8 x 8 tiles a call.
// What bounds it: operations, 4 B H Sq Sk D flops against the 989 TFLOP/s
// dense bf16 rate (q/k/v/o are 0.14 GB at (4, 4352, 24, 128)).
// ---------------------------------------------------------------------------

namespace bf16fa {

constexpr int BK = 64;           // keys per tile
constexpr int WARPS = 4;         // row groups of 16 a block
constexpr int NK = BK / 8;       // 8-key n-tiles of S
constexpr int KP = BK / 16;      // 16-key k-steps of P V

template <int D>
struct Shape {
  static constexpr int LD = D + 8;        // padded smem row (bf16)
  static constexpr int TILE = BK * LD;    // one K or V tile (bf16)
  static constexpr int STAGE = 2 * TILE;  // K then V
  static constexpr int KS = D / 16;       // k-steps of Q K^T
  static constexpr int NO = D / 8;        // 8-dim n-tiles of O
  static constexpr size_t SMEM = 2 * STAGE * sizeof(__nv_bfloat16);
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one bf16x2 register, round to nearest even; `lo` in the
// low half (the smaller column of a fragment)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

// K and V tile t into `stage` as one commit group; rows >= sk zero-filled
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* stage,
                                          const __nv_bfloat16* kb,
                                          const __nv_bfloat16* vb,
                                          long long k_ss, long long v_ss,
                                          int t, int sk) {
  using S = Shape<D>;
  constexpr int C8 = D / 8;                  // 16-byte chunks a row
  __nv_bfloat16* ks = stage;
  __nv_bfloat16* vs = stage + S::TILE;
  const int k0 = t * BK;
  for (int e = threadIdx.x; e < BK * C8; e += blockDim.x) {
    const int r = e / C8, c = 8 * (e % C8);
    const bool ok = k0 + r < sk;
    cp_async16(ks + r * S::LD + c, ok ? kb + (k0 + r) * k_ss + c : kb, ok);
    cp_async16(vs + r * S::LD + c, ok ? vb + (k0 + r) * v_ss + c : vb, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int D>
__global__ void __launch_bounds__(32 * WARPS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int n_heads, int sq, int sk,
               long long q_sb, long long q_ss, long long q_sh, long long k_sb,
               long long k_ss, long long k_sh, long long v_sb, long long v_ss,
               long long v_sh, float qscale, int causal) {
  using S = Shape<D>;
  constexpr int LD = S::LD, KS = S::KS, NO = S::NO;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(smem4);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * WARPS * ROWS;
  const int r0 = q0 + warp * ROWS;
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  int n_tiles = (sk + BK - 1) / BK;
  if (causal) {
    const int last = min(q0 + WARPS * ROWS, sq) - 1 + sk - sq;
    n_tiles = min(n_tiles, last / BK + 1);
  }
  load_tile<D>(kv, kb, vb, k_ss, v_ss, 0, sk);

  // Q's A fragments: a0 (g, 2t4..), a1 (g + 8, 2t4..), a2 (g, 2t4 + 8..),
  // a3 (g + 8, 2t4 + 8..) of each 16-dim k-step; rows past sq are zero
  uint32_t qf[KS][4];
  {
    const bool ok0 = r0 + g < sq, ok1 = r0 + g + 8 < sq;
    const __nv_bfloat16* row0 = qb + (long long)(r0 + g) * q_ss;
    const __nv_bfloat16* row1 = qb + (long long)(r0 + g + 8) * q_ss;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = 16 * kk + 2 * t4;
      qf[kk][0] = ok0 ? *reinterpret_cast<const uint32_t*>(row0 + c) : 0u;
      qf[kk][1] = ok1 ? *reinterpret_cast<const uint32_t*>(row1 + c) : 0u;
      qf[kk][2] = ok0 ? *reinterpret_cast<const uint32_t*>(row0 + c + 8) : 0u;
      qf[kk][3] = ok1 ? *reinterpret_cast<const uint32_t*>(row1 + c + 8) : 0u;
    }
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m[2] = {MASKED, MASKED};   // rows g and g + 8
  float l[2] = {0.f, 0.f};         // this thread's share of the row sums

  for (int t = 0; t < n_tiles; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();     // tile t visible to all; tile t - 1 no longer read
    if (t + 1 < n_tiles)
      load_tile<D>(kv + ((t + 1) & 1) * S::STAGE, kb, vb, k_ss, v_ss, t + 1,
                   sk);
    const __nv_bfloat16* ks = kv + (t & 1) * S::STAGE;
    const __nv_bfloat16* vs = ks + S::TILE;

    // S = Q K^T: n-tile j holds keys 8j + 2t4, 8j + 2t4 + 1 of rows g, g + 8
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const __nv_bfloat16* kp = ks + (8 * j + g) * LD + 16 * kk + 2 * t4;
        mma_bf16(s[j], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }

    const int k0 = t * BK;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] *= qscale;
        if (causal || k0 + BK > sk) {
          const int col = k0 + 8 * j + 2 * t4 + (i & 1);
          const int row = r0 + g + 8 * (i >> 1);
          if (col >= sk || (causal && row + sk - sq < col)) s[j][i] = MASKED;
        }
      }

    // online softmax in base 2; the row max over the quad of a row
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = MASKED;
#pragma unroll
      for (int j = 0; j < NK; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float corr = exp2f(m[hr] - m_new);
      m[hr] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        s[j][2 * hr] = exp2f(s[j][2 * hr] - m_new);
        s[j][2 * hr + 1] = exp2f(s[j][2 * hr + 1] - m_new);
        rs += s[j][2 * hr] + s[j][2 * hr + 1];
      }
      l[hr] = l[hr] * corr + rs;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * hr] *= corr;
        acc[n][2 * hr + 1] *= corr;
      }
    }

    // O += P V over k-steps of 16 keys
#pragma unroll
    for (int kp = 0; kp < KP; ++kp) {
      uint32_t pa[4];
      pa[0] = pack(s[2 * kp][0], s[2 * kp][1]);
      pa[1] = pack(s[2 * kp][2], s[2 * kp][3]);
      pa[2] = pack(s[2 * kp + 1][0], s[2 * kp + 1][1]);
      pa[3] = pack(s[2 * kp + 1][2], s[2 * kp + 1][3]);
      // lanes 8m .. 8m + 7 address the rows of 8 x 8 tile m: keys
      // 16 kp + (lane % 8) + 8 ((lane / 8) % 2), dims 8 n + 8 (lane / 16)
      const __nv_bfloat16* vrow =
          vs + (16 * kp + (lane % 8) + 8 * ((lane / 8) % 2)) * LD +
          8 * (lane / 16);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vrow + 8 * n);
        mma_bf16(acc[n], pa, vf[0], vf[1]);
        mma_bf16(acc[n + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const int row = r0 + g + 8 * hr;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[hr], 1e-30f);
    __nv_bfloat16* orow =
        o + (((long long)b * sq + row) * n_heads + h) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * hr] * inv,
                                acc[n][2 * hr + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int sq, int sk, const long long* st, float scale,
           int causal, cudaStream_t stream) {
  using S = Shape<D>;
  static std::atomic<bool> ready[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(flash_fwd_bf16<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)S::SMEM);
    if (e != cudaSuccess) return (int)e;
    ready[dev].store(true, std::memory_order_release);
  }
  dim3 grid((sq + ROWS * WARPS - 1) / (ROWS * WARPS), h, b);
  flash_fwd_bf16<D><<<grid, 32 * WARPS, S::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      h, sq, sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

}  // namespace bf16fa

}  // namespace

extern "C" {

// strides: 9 element strides (batch, seq, head) of q, k, v in that order.
// o is a contiguous (b, sq, h, d) tensor.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unsupported head dim.
int flash_attention_launch(const float* q, const float* k, const float* v,
                           float* o, int b, int h, int sq, int sk, int d,
                           const long long* strides, float scale, int causal,
                           cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, b, h, sq, sk, strides, scale, causal,
                        stream);
    case 64:
      return launch<64>(q, k, v, o, b, h, sq, sk, strides, scale, causal,
                        stream);
    case 128:
      return launch<128>(q, k, v, o, b, h, sq, sk, strides, scale, causal,
                         stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The same over bf16 q, k, v (row strides multiples of 8 elements, rows
// 16-byte aligned) into a contiguous bf16 o; head dims 64 and 128.
int flash_attention_bf16_launch(const void* q, const void* k, const void* v,
                                void* o, int b, int h, int sq, int sk, int d,
                                const long long* strides, float scale,
                                int causal, cudaStream_t stream) {
  switch (d) {
    case 64:
      return bf16fa::launch<64>(q, k, v, o, b, h, sq, sk, strides, scale,
                                causal, stream);
    case 128:
      return bf16fa::launch<128>(q, k, v, o, b, h, sq, sk, strides, scale,
                                 causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The block layout the launcher picks on the current device: out[0] = row
// groups (16 query rows each), out[1] = key slots, out[2] = shared memory
// bytes.  Returns cudaErrorInvalidValue for an unsupported head dim.
int flash_attention_layout(int b, int h, int sq, int sk, int d,
                           long long* out) {
  Layout L;
  switch (d) {
    case 32: L = layout<32>(b, h, sq, sk); break;
    case 64: L = layout<64>(b, h, sq, sk); break;
    case 128: L = layout<128>(b, h, sq, sk); break;
    default: return (int)cudaErrorInvalidValue;
  }
  out[0] = L.qw;
  out[1] = L.kw;
  out[2] = (long long)L.smem;
  return 0;
}

}  // extern "C"
