// Fused affine-free LayerNorm + adaLN modulation, one warp per token row,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `adaln_modulate` (body `_adaln_kernel`) of
// repro/kernels/adaln.py:
//   y = (x - mean) * rsqrt(var + eps) * (1 + scale[b]) + shift[b]
// with mean and the centred variance of each (b, t) row taken in f32.
//
// Inputs: x (B, T, D) f32 contiguous; shift/scale (B, D) f32 with a
// contiguous last axis and any row stride (the DiT passes chunks of its
// adaLN projection, row stride 6 * D).  Output: like x.  Requires
// D % 4 == 0, D <= 4 * 32 * MAX_NV (1536), 16-byte aligned pointers and row
// strides that are multiples of 4.
//
// Bound on the card: memory, one read and one write of x (2 x 256 x 768 x
// 4 B = 1.6 MB at B = 1, 0.47 us at 3.35 TB/s); a handful of operations
// per element.  At B = 1 the whole call is a few hundred nanoseconds of
// DRAM time, so launch and latency decide.
//
// The TPU kernel normalises a (block_t, D) tile per grid step in VMEM.
// Here one warp owns a row and keeps it in registers as float4s: lane l
// holds float4 columns l, l + 32, .. (NV of them; 6 at D = 768, no masked
// lane).  The mean is four per-lane column sums (the x, y, z, w of the
// lane's float4s, so the dependent chain is NV long, not 4 NV), combined
// as (x + y) + (z + w), then a fixed __shfl_xor butterfly (16, 8, 4, 2, 1),
// so every lane holds the same bits; the variance is the same over
// (x - mean)^2 from the registers (the reference's two-pass formula, not
// E[x^2] - mean^2).  Nothing depends on B or on where a row sits in the
// grid: a row gives the same bits alone and in a batch.  The warp loads
// its row and its image's shift and scale at once, 3 NV float4 loads in
// flight a lane: at B = 1 one memory round trip is most of the kernel,
// and reading shift and scale after the statistics would add a second.
// The launcher picks warps per block (kernels/adaln.py); one plain
// launch, no shared memory, no barrier.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_NV = 12;          // float4 per lane: D <= 1536

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

template <int NV>
__global__ void __launch_bounds__(256)
adaln_rows(const float* __restrict__ x, const float* __restrict__ shift,
           const float* __restrict__ scale, float* __restrict__ out,
           int n_rows, int t, int d, long long shift_sb, long long scale_sb,
           float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int d4 = d >> 2;
  const float fd = (float)d;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* xr = reinterpret_cast<const float4*>(x) + (size_t)row * d4;
  const int b = row / t;
  const float4* s4 = reinterpret_cast<const float4*>(shift + b * shift_sb);
  const float4* c4 = reinterpret_cast<const float4*>(scale + b * scale_sb);
  float4 v[NV], sh[NV], sc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {            // every load in flight at once
    const int c = lane + 32 * j;
    v[j] = c < d4 ? __ldg(xr + c) : zero;
    sh[j] = c < d4 ? __ldg(s4 + c) : zero;
    sc[j] = c < d4 ? __ldg(c4 + c) : zero;
  }
  // mean: four column sums a lane (x, y, z, w of its float4s, in column
  // order), (x + y) + (z + w), then the butterfly
  float4 a = v[0];
#pragma unroll
  for (int j = 1; j < NV; ++j) {
    a.x += v[j].x;
    a.y += v[j].y;
    a.z += v[j].z;
    a.w += v[j].w;
  }
  const float mean = warp_sum((a.x + a.y) + (a.z + a.w)) / fd;
  // centred variance the same way, from the registers; masked columns
  // add nothing
  float4 q = zero;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (lane + 32 * j < d4) {
      v[j].x -= mean;
      v[j].y -= mean;
      v[j].z -= mean;
      v[j].w -= mean;
      q.x = fmaf(v[j].x, v[j].x, q.x);
      q.y = fmaf(v[j].y, v[j].y, q.y);
      q.z = fmaf(v[j].z, v[j].z, q.z);
      q.w = fmaf(v[j].w, v[j].w, q.w);
    }
  }
  const float rstd =
      1.0f / sqrtf(warp_sum((q.x + q.y) + (q.z + q.w)) / fd + eps);
  float4* orow = reinterpret_cast<float4*>(out) + (size_t)row * d4;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = lane + 32 * j;
    if (c < d4) {
      float4 y;
      y.x = fmaf(v[j].x * rstd, 1.f + sc[j].x, sh[j].x);
      y.y = fmaf(v[j].y * rstd, 1.f + sc[j].y, sh[j].y);
      y.z = fmaf(v[j].z * rstd, 1.f + sc[j].z, sh[j].z);
      y.w = fmaf(v[j].w * rstd, 1.f + sc[j].w, sh[j].w);
      orow[c] = y;
    }
  }
}

template <int NV>
cudaError_t launch_nv(const float* x, const float* shift, const float* scale,
                      float* out, int n_rows, int t, int d,
                      long long shift_sb, long long scale_sb,
                      int warps_per_block, float eps, cudaStream_t stream) {
  const int blocks = (n_rows + warps_per_block - 1) / warps_per_block;
  adaln_rows<NV><<<blocks, warps_per_block * 32, 0, stream>>>(
      x, shift, scale, out, n_rows, t, d, shift_sb, scale_sb, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y = LN(x) * (1 + scale[b]) + shift[b] over x (b, t, d); shift_sb and
// scale_sb are the row strides of shift and scale in floats.  One launch;
// returns its cudaGetLastError(), or cudaErrorInvalidValue for a d or a
// layout the kernel does not take.
int adaln_launch(const float* x, const float* shift, const float* scale,
                 float* out, int b, int t, int d, long long shift_sb,
                 long long scale_sb, int warps_per_block, float eps,
                 cudaStream_t stream) {
  if (d <= 0 || d % 4 || d > 4 * 32 * MAX_NV || b <= 0 || t <= 0 ||
      warps_per_block < 1 || warps_per_block > 8 || shift_sb % 4 ||
      scale_sb % 4 ||
      ((uintptr_t)x | (uintptr_t)shift | (uintptr_t)scale | (uintptr_t)out) %
          16)
    return (int)cudaErrorInvalidValue;
  const int n_rows = b * t;
  const int nv = (d / 4 + 31) / 32;
  cudaError_t e;
  switch (nv) {
#define CASE(N)                                                              \
  case N:                                                                    \
    e = launch_nv<N>(x, shift, scale, out, n_rows, t, d, shift_sb, scale_sb, \
                     warps_per_block, eps, stream);                          \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6)
    CASE(7) CASE(8) CASE(9) CASE(10) CASE(11) CASE(12)
#undef CASE
    default:
      e = cudaErrorInvalidValue;
  }
  return (int)e;
}

}  // extern "C"
