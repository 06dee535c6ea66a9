// Online-softmax (flash) attention forward, f32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` of
// repro/kernels/flash_attention.py: softmax(q k^T / sqrt(D)) v over
// (B, S, H, D) tensors, with a padded-length mask and the end-aligned
// causal option (row r sees keys <= r + Sk - Sq).  Masked logits carry the
// same -1e30 sentinel as the TPU kernel; the running max, sum and
// accumulator stay in f32.
//
// The TPU kernel keeps a (block_q x D) accumulator in VMEM across a
// sequential k-block grid axis.  Here one block of 256 threads owns 64
// query rows of one (batch, head) and loops over the key axis itself, in
// tiles of 64 keys staged in shared memory with Q:
//   * the threads form a 16 x 16 grid; thread (ty, tx) holds a 4 x 4 tile
//     of scores (rows 4ty.., keys tx + 16j) and a 4 x D/16 tile of the
//     output (rows 4ty.., dims D/16 tx..) in registers, so every float4
//     read from shared memory feeds 4 to 16 FMAs (register blocking, as in
//     an SGEMM);
//   * the max, exponentials and rescale of the online softmax run once per
//     tile; row statistics are reduced over the 16 threads of a row with
//     warp shuffles;
//   * P goes through shared memory between the two products; rows are
//     padded by 4 floats so that the strided accesses of a quarter warp
//     fall in distinct banks.
// Inputs may be strided views (the DiT passes q, k, v as slices of one
// fused qkv tensor); only the last axis must be contiguous.
//
// Bound on the card at the DiT-B/2 shapes: operations, 4*B*H*Sq*Sk*D f32
// FMA-counted flops against the 67 TFLOP/s f32 rate (plain FMA, no tensor
// cores — wgmma/TMA are later work).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16 thread grid
constexpr int LP = BK + 4;      // padded row stride of P (floats)
constexpr float MASKED = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 4) + (size_t)BQ * LP);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int n_heads,
          int sq, int sk, long long q_sb, long long q_ss, long long q_sh,
          long long k_sb, long long k_ss, long long k_sh, long long v_sb,
          long long v_ss, long long v_sh, float scale, int causal) {
  constexpr int LD = D + 4;       // padded row stride of Q, K, V (floats)
  constexpr int C4 = D / 4;       // float4 chunks per row
  constexpr int DV = D / 16;      // output dims per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [BQ][LD], pre-scaled
  float* ks = qs + BQ * LD;                      // [BK][LD]
  float* vs = ks + BK * LD;                      // [BK][LD]
  float* ps = vs + BK * LD;                      // [BQ][LP]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  for (int e = tid; e < BQ * C4; e += THREADS) {
    const int r = e / C4, c = e % C4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < sq)
      x = reinterpret_cast<const float4*>(qb + (long long)(q0 + r) * q_ss)[c];
    *reinterpret_cast<float4*>(qs + r * LD + 4 * c) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }

  float m[4], l[4], acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DV; ++d) acc[i][d] = 0.f;
  }

  const int n_tiles = (sk + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();              // last tile's reads of ks, vs, ps are done
    for (int e = tid; e < BK * C4; e += THREADS) {
      const int r = e / C4, c = e % C4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < sk) {
        kv = reinterpret_cast<const float4*>(kb + (long long)(k0 + r) * k_ss)[c];
        vv = reinterpret_cast<const float4*>(vb + (long long)(k0 + r) * v_ss)[c];
      }
      *reinterpret_cast<float4*>(ks + r * LD + 4 * c) = kv;
      *reinterpret_cast<float4*>(vs + r * LD + 4 * c) = vv;
    }
    __syncthreads();

    // S = Q K^T on this thread's rows 4ty + i and keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask, then the online softmax (row stats over the 16 tx threads)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = MASKED;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        bool ok = col < sk;
        if (causal) ok = ok && row + (sk - sq) >= col;
        if (!ok) s[i][j] = MASKED;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < DV; ++d) acc[i][d] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(4 * ty + i) * LP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // O += P V on rows 4ty + i and dims DV tx ..
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * LP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DV];
        const float* vrow = vs + (j + jj) * LD + DV * tx;
        if constexpr (DV % 4 == 0) {
#pragma unroll
          for (int d = 0; d < DV; d += 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + d);
            vv[d] = x.x;
            vv[d + 1] = x.y;
            vv[d + 2] = x.z;
            vv[d + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int d = 0; d < DV; ++d) vv[d] = vrow[d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                        : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int d = 0; d < DV; ++d) acc[i][d] = fmaf(p, vv[d], acc[i][d]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = o + (((long long)b * sq + row) * n_heads + h) * D + DV * tx;
#pragma unroll
    for (int d = 0; d < DV; ++d) orow[d] = acc[i][d] * inv;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int b,
           int h, int sq, int sk, const long long* st, float scale,
           int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_fwd<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, h, sq, sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale, causal);
  return (int)cudaGetLastError();
}

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

}  // extern "C"
