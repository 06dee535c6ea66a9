#!/usr/bin/env python3
"""Diagnostics of the port's redesigned kernels K1-K6 on one NVIDIA GPU,
from variants of their sources.

    python3 tools/kernel_diag.py [--only k1|k2|k3|k4|k5|k6] [--out diag.json]

Run from the root of a checkout.  The variants are generated from
``src/repro_torch/kernels/csrc`` by text substitution, built with nvcc
into ``build/diag/`` and loaded with ctypes; nothing of the package
changes.

* K4 (``flash_attention.cu``): ``shipped``; ``cvt`` (the operand split
  through the PTX ``cvt.rna.tf32.f32``, as written first); ``hi`` (one
  TF32 product, hi.hi: wrong numbers, the 1x floor); ``raw`` (no split,
  the raw bits into three mmas: wrong numbers, the cost of 3x mmas alone).
  Each at q/k/v (B, 256, 12, 64), B = 1 and 8: device ms, max |error|
  against the plain version, and its SASS instruction mix.  Then the
  shipped kernel with its block layout forced (row groups x key slots)
  at B = 1, 2, 4, 8.
* K4 at bf16 (``flash_attention_bf16_launch``, ``--only k4bf16``): the
  shipped kernel (P rounded to bf16 for P·V) against ``hilo`` (P split
  into bf16 hi + lo, two products), at q/k/v (16, 1280, 24, 128) and
  (4, 4352, 24, 128), v strided as the single block hands it over:
  device ms and max |error| against the plain version on the same bf16
  inputs and against the plain version in f32.
* K6 (``groupnorm_silu.cu``): a traced copy (``%globaltimer`` at each
  phase of every block, and ``%smid``) under the shipped partition rule
  and three fixed ones (slices of >= 16 or >= 32 channels; blocks of up to
  512 threads and 92 KB of x on chip, or 1024 and 160 KB), at every
  resblock shape of the 256 px VAE, B = 1 and 8: device ms, and at B = 1
  the SMs the blocks ran on and the median time of each phase.
* K5 (``adaln.cu``): the shipped kernel against the Triton kernel it
  replaced (one program a row, ``BLOCK_D = next_pow2(D)``, kept here as
  ``triton``) and against ``pdl`` (the same kernel launched with
  programmatic dependent launch, ``griddepcontrol.wait`` before x is
  read), on x (B, 256, 768) with shift/scale as strided chunks of a
  (B, 6·768) projection, B = 1, 2, 4, 8: device ms, eager ms per call
  (host launch included), and device ms behind a (B·256, 768) x (768,
  768) matmul, where a dependent launch could hide its set-up.  Then the
  shipped kernel at 1, 2, 4 and 8 warps (rows) a block.
* K1 (``vdb_topk.cu``): the clustered one-launch scan against the
  two-pass template it replaced (``TEMPLATE_SOURCE`` below, with
  ``per_node``) and against ``argmax`` (the clustered scan with k rounds
  of warp arg-max over the running list and a tile instead of the bitonic
  sort and merge), at 2 planes x 4 nodes x 400 slots x 512 dims, k = 8,
  Q = 1..8 (the serving shapes), and at 4096 slots a node; the clustered
  scan's bits must equal the template's.  Then the clustered scan at
  every cluster size of {1, 2, 4, 8, 13, 16} (Q = 1 and 8 at 400 slots,
  Q = 8 at 4096; ``wide``: the shipped source, which stops at the
  portable 8, taking non-portable clusters of up to 16), with how many of
  its clusters fit on the card at once, and a traced copy of ``wide``
  (``%globaltimer`` at each phase of every block, ``%smid``) at 400
  slots, Q = 1 and 8, clusters of the plan's size, 8 and 16.
* K2 (``vdb_topk.cu``, ``vdb_topk_sharded_launch``): node-masked and
  global against the template, at Q = 1, 2, 8, 17 over 2 x 4 x 400 x 512
  and Q = 8 over 2 x 4 x 4096 x 512; the global scan also as design (b),
  one cluster per (plane, query tile) spanning every node's rows, with
  clusters of up to 8 and of 16.  Same bits as the template required.
* K3 (``vdb_topk_single_launch``): against the template's per-node scan
  of one plane and one node, Q = 1 and 8 over 400 x 512 and 4096 x 512;
  then with the db split into nodes of at most 128-1024 rows, one cluster
  each, merged as the global K2 merges nodes.
* Floors, always: an empty kernel's device and eager ms, and a plain
  copy of K5's rows with K5's grid at B = 1 and 8.

Device ms: a CUDA graph of 20 calls replayed 10 times between CUDA events
(inputs warm in L2).  Eager ms: the best of 5 runs of 50 back-to-back
calls between CUDA events (host launch cost included).  Needs a GPU;
fails without one.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "diag"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")
VAE_RESBLOCK_SHAPES = ((128, 128), (64, 256), (32, 512), (64, 512),
                       (128, 256), (256, 128))
GN_PHASES = ("copies issued + global-memory Welford", "copies land",
             "on-chip Welford", "lane shuffles", "rows and channels",
             "cluster barrier", "ranks (DSMEM)", "apply", "final barrier")
# name -> -D flags of the fixed K6 partition rules (slice channels at
# least, threads at most, KB of x on chip)
GN_RULES = {"shipped": (), "s16_t512_92": (16, 512, 92),
            "s32_t512_92": (32, 512, 92), "s32_t1024_160": (32, 1024, 160)}


def sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"kernel_diag: the source no longer has {old!r}")
    return src.replace(old, new)


def k4_source(variant: str) -> str:
    src = (CSRC / "flash_attention.cu").read_text()
    src = sub(src, "template <int D>\nLayout layout(int b, int h, int sq, int sk) {\n",
              """int g_force[2] = {0, 0};
template <int D>
Layout layout(int b, int h, int sq, int sk) {
  if (g_force[0]) {
    Layout F{g_force[0], g_force[1], 0};
    F.smem = smem_bytes<D>(F.qw, F.kw, sk);
    return F;
  }
""")
    src = sub(src, "int flash_attention_layout(", """void flash_attention_force(int qw, int kw) {
  g_force[0] = qw;
  g_force[1] = kw;
}
int flash_attention_layout(""")
    split = "  hi = to_tf32(x);\n  lo = to_tf32(x - __uint_as_float(hi));\n"
    if variant == "cvt":
        src = sub(src, split, """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
""")
    elif variant == "raw":
        src = sub(src, split, "  hi = __float_as_uint(x);\n  lo = 0u;\n")
    elif variant == "hi":
        src = sub(src, """  for (int i = 0; i < N; ++i) mma_tf32(d[n0 + i], al, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[n0 + i], ah, bl[i][0], bl[i][1]);
""", "")
    return src


def k4_bf16_source(variant: str) -> str:
    """``hilo``: P.V as two products, P's bf16 hi (the shipped rounding)
    and its bf16 lo (the f32 remainder), into one f32 accumulator."""
    src = (CSRC / "flash_attention.cu").read_text()
    if variant == "hilo":
        src = sub(src, "      pa[3] = pack(s[2 * kp + 1][2], s[2 * kp + 1][3]);\n",
                  """      pa[3] = pack(s[2 * kp + 1][2], s[2 * kp + 1][3]);
      uint32_t pl[4];
      {
        const float f[4][2] = {{s[2 * kp][0], s[2 * kp][1]},
                               {s[2 * kp][2], s[2 * kp][3]},
                               {s[2 * kp + 1][0], s[2 * kp + 1][1]},
                               {s[2 * kp + 1][2], s[2 * kp + 1][3]}};
        for (int i = 0; i < 4; ++i)
          pl[i] = pack(f[i][0] - __uint_as_float(pa[i] << 16),
                       f[i][1] - __uint_as_float(pa[i] & 0xffff0000u));
      }
""")
        src = sub(src, "        mma_bf16(acc[n], pa, vf[0], vf[1]);\n",
                  """        mma_bf16(acc[n], pl, vf[0], vf[1]);
        mma_bf16(acc[n + 1], pl, vf[2], vf[3]);
        mma_bf16(acc[n], pa, vf[0], vf[1]);
""")
    return src


def diag_k4_bf16(torch, libs, dev, gen) -> dict:
    """K4 at bf16, P as bf16 (shipped) against P as bf16 hi + lo."""
    from repro_torch.kernels import ref
    P, I = ctypes.c_void_p, ctypes.c_int
    out = {}
    for b, s, h, d in ((16, 1280, 24, 128), (4, 4352, 24, 128)):
        u = torch.randn((b, s, 7 * h * d), generator=gen).to(
            dev, torch.bfloat16)
        q = u[..., :h * d].reshape(b, s, h, d).contiguous()
        k = u[..., h * d:2 * h * d].reshape(b, s, h, d).contiguous()
        v = u[..., 2 * h * d:3 * h * d].reshape(b, s, h, d)
        want = ref.flash_attention_ref(q, k, v).float()
        want32 = ref.flash_attention_ref(q.float(), k.float(), v.float())
        torch.cuda.empty_cache()
        st = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                     *v.stride()[:3])
        o = torch.empty((b, s, h, d), device=dev, dtype=torch.bfloat16)
        for name in ("shipped", "hilo"):
            lib = libs[f"fa16_{name}"]
            fn = lib.flash_attention_bf16_launch
            fn.argtypes = [P] * 4 + [I] * 5 + [P, ctypes.c_float, I, P]

            def run():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), b, h, s, s, d, ctypes.cast(st, P),
                         d ** -0.5, 0, torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
            run()
            torch.cuda.synchronize()
            r = dict(ms=device_ms(torch, run, reps=10, replays=5),
                     err_plain=float((o.float() - want).abs().max()),
                     err_f32_plain=float((o.float() - want32).abs().max()),
                     sass=sass_mix(OUT / f"fa16_{name}.so",
                                   "flash_fwd_bf16ILi128E"))
            out[f"{name} {(b, s, h, d)}"] = r
            print(f"[k4bf16] {name:<8} {(b, s, h, d)}: {r['ms']:.4f} ms, err "
                  f"{r['err_plain']:.2e} vs plain, {r['err_f32_plain']:.2e} "
                  f"vs f32 plain; SASS {r['sass'].get('total')} "
                  f"instructions, top {r['sass'].get('top')}", flush=True)
        del u, q, k, v, o, want, want32
        torch.cuda.empty_cache()
    return out


def k6_source(rule) -> str:
    src = (CSRC / "groupnorm_silu.cu").read_text()
    src = sub(src, "namespace cg = cooperative_groups;", """namespace cg = cooperative_groups;
__device__ long long g_trace[4096][11];
__device__ __forceinline__ long long gtime() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define MARK(i) \\
  if (threadIdx.x == 0 && tb < 4096) g_trace[tb][i] = gtime();""")
    src = sub(src, "  const bool active = lane < lanes;\n", """  const bool active = lane < lanes;
  const int tb = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  MARK(0);
  if (threadIdx.x == 0 && tb < 4096) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_trace[tb][10] = sm;
  }
""")
    src = sub(src, '  asm volatile("cp.async.wait_all;\\n" ::: "memory");\n',
              '  MARK(1);\n  asm volatile("cp.async.wait_all;\\n" ::: "memory");\n'
              '  MARK(2);\n')
    src = sub(src, "  // Statistics, in a fixed order",
              "  MARK(3);\n  // Statistics, in a fixed order")
    src = sub(src, "  const int rows = lanes / l0;",
              "  MARK(4);\n  const int rows = lanes / l0;")
    src = sub(src, "  cluster.sync();\n",
              "  MARK(5);\n  cluster.sync();\n  MARK(6);\n")
    src = sub(src, "  // y = x * a + b with a", "  MARK(7);\n  // y = x * a + b with a")
    src = sub(src, '  asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");\n}',
              '  MARK(8);\n'
              '  asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");\n'
              '  MARK(9);\n}')
    src = sub(src, "int groupnorm_silu_max_channels() {", """int gn_trace_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
}
int groupnorm_silu_max_channels() {""")
    if rule:
        s, t, kb = rule
        src = sub(src, "  if (c / cs32 <= 4) {", f"""  max_threads = {t};
  tile = {kb} * 1024;
  p.cs = slice_channels(c, cg_, {s});
  if (false) {{""")
    return src


def k5_pdl_source() -> str:
    """adaln.cu launched with programmatic dependent launch."""
    src = (CSRC / "adaln.cu").read_text()
    src = sub(src, "           float eps) {\n",
              "           float eps) {\n"
              '  asm volatile("griddepcontrol.wait;\\n" ::: "memory");\n')
    return sub(src, """  adaln_rows<NV><<<blocks, warps_per_block * 32, 0, stream>>>(
      x, shift, scale, out, n_rows, t, d, shift_sb, scale_sb, eps);
""", """  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(warps_per_block * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, adaln_rows<NV>, x, shift, scale,
                                     out, n_rows, t, d, shift_sb, scale_sb,
                                     eps);
  if (e != cudaSuccess) return e;
""")


# The two-pass scan that the clustered K1, K2 and K3 replaced, as it
# shipped: one block per (64-row chunk, plane and node, tile of 16 queries)
# selects the chunk's top-k into scratch lists in device memory by k rounds
# of a warp arg-max; a second launch merges the lists of a node
# (per_node) or of every node of the plane, node-masked or not.  K3 was its
# per-node scan over one plane and one node.
TEMPLATE_SOURCE = """#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;       // capacity rows per block (one chunk)
constexpr int QTILE = 16;      // queries per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_K = 32;
constexpr float MASKED = -1e30f;         // masked-candidate sentinel
constexpr int EMPTY_SLOT = 0x7fffffff;   // past the end of a slab

// strict total order: higher score first, then lower global slot
__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

// warp-wide arg-best of (score, slot, owner); every lane gets the winner
__device__ __forceinline__ void warp_best(float& s, int& i, int& owner) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    int i2 = __shfl_xor_sync(0xffffffffu, i, off);
    int o2 = __shfl_xor_sync(0xffffffffu, owner, off);
    if (better(s2, i2, s, i) || (s2 == s && i2 == i && o2 < owner)) {
      s = s2;
      i = i2;
      owner = o2;
    }
  }
}

template <bool MASK_NODES>
__global__ void __launch_bounds__(THREADS)
scan_chunks(const float* __restrict__ q, const float* __restrict__ slabs,
            const uint8_t* __restrict__ valid,
            const int* __restrict__ node_ids, float* __restrict__ part_s,
            int* __restrict__ part_i, int n_nodes, int cap, int dim, int n_q,
            int k, int n_chunks) {
  extern __shared__ float4 q_s[];                 // (QTILE, dim/4)
  __shared__ float score_s[QTILE][ROWS];

  const int chunk = blockIdx.x;
  const int pn = blockIdx.y;                      // plane * n_nodes + node
  const int node = pn % n_nodes;
  const int q0 = blockIdx.z * QTILE;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d4 = dim / 4;

  // query tile -> shared memory (zero rows past the end)
  for (int e = threadIdx.x; e < QTILE * d4; e += THREADS) {
    int qi = e / d4, c = e % d4;
    q_s[e] = (q0 + qi < n_q)
        ? reinterpret_cast<const float4*>(q)[(size_t)(q0 + qi) * d4 + c]
        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // scores: each warp streams rows warp, warp + WARPS, ... of the chunk
  const float4* slab4 = reinterpret_cast<const float4*>(slabs) +
                        (size_t)pn * cap * d4;
  for (int r = warp; r < ROWS; r += WARPS) {
    const int col = chunk * ROWS + r;
    float acc[QTILE];
#pragma unroll
    for (int qi = 0; qi < QTILE; ++qi) acc[qi] = 0.f;
    if (col < cap) {
      const float4* row = slab4 + (size_t)col * d4;
      for (int c = lane; c < d4; c += 32) {
        float4 v = __ldg(row + c);
#pragma unroll
        for (int qi = 0; qi < QTILE; ++qi) {
          float4 x = q_s[qi * d4 + c];
          acc[qi] = fmaf(v.x, x.x, acc[qi]);
          acc[qi] = fmaf(v.y, x.y, acc[qi]);
          acc[qi] = fmaf(v.z, x.z, acc[qi]);
          acc[qi] = fmaf(v.w, x.w, acc[qi]);
        }
      }
    }
#pragma unroll
    for (int qi = 0; qi < QTILE; ++qi) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[qi] += __shfl_xor_sync(0xffffffffu, acc[qi], off);
    }
    if (lane < QTILE) {
      float s = 0.f;
#pragma unroll
      for (int qi = 0; qi < QTILE; ++qi)
        if (qi == lane) s = acc[qi];
      const int qg = q0 + lane;
      if (col >= cap) {
        s = -CUDART_INF_F;                        // empty: below masked
      } else {
        bool ok = valid[(size_t)node * cap + col] != 0;
        if (MASK_NODES) ok = ok && qg < n_q && node_ids[qg] == node;
        if (!ok) s = MASKED;
      }
      score_s[lane][r] = s;
    }
  }
  __syncthreads();

  // chunk top-k: one warp per query, two candidates per lane
  for (int qi = warp; qi < QTILE; qi += WARPS) {
    const int qg = q0 + qi;
    if (qg >= n_q) continue;
    float cs[2];
    int ci[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = lane + 32 * j;
      const int col = chunk * ROWS + r;
      cs[j] = score_s[qi][r];
      ci[j] = col < cap ? node * cap + col : EMPTY_SLOT;
    }
    const size_t base = (((size_t)pn * n_chunks + chunk) * n_q + qg) * k;
    for (int kk = 0; kk < k; ++kk) {
      const int pick = better(cs[0], ci[0], cs[1], ci[1]) ? 0 : 1;
      float s = cs[pick];
      int i = ci[pick];
      int owner = lane * 2 + pick;
      warp_best(s, i, owner);
      if (owner / 2 == lane) {                    // the winner drops out
        cs[owner % 2] = -CUDART_INF_F;
        ci[owner % 2] = EMPTY_SLOT;
      }
      if (lane == 0) {
        part_s[base + kk] = s;
        part_i[base + kk] = i;
      }
    }
  }
}

template <bool PER_NODE>
__global__ void __launch_bounds__(THREADS)
merge_lists(const float* __restrict__ part_s, const int* __restrict__ part_i,
            float* __restrict__ out_s, int* __restrict__ out_i, int n_planes,
            int n_nodes, int n_q, int k, int n_chunks) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int list = blockIdx.x * WARPS + warp;
  // PER_NODE: list = (plane * n_nodes + node) * n_q + q; else plane * n_q + q
  const int n_lists = (PER_NODE ? n_planes * n_nodes : n_planes) * n_q;
  if (list >= n_lists) return;
  const int q = list % n_q;
  const int group = list / n_q;                   // pn, or the plane
  const int first_pn = PER_NODE ? group : group * n_nodes;
  const int n_pn = PER_NODE ? 1 : n_nodes;
  const int per_pn = n_chunks * k;                // candidates of one (p, n)
  const int m = n_pn * per_pn;

  float last_s = CUDART_INF_F;                    // nothing taken yet
  int last_i = -1;
  for (int kk = 0; kk < k; ++kk) {
    float s = -CUDART_INF_F;
    int i = EMPTY_SLOT;
    for (int j = lane; j < m; j += 32) {
      const int pn = first_pn + j / per_pn;
      const int chunk = (j % per_pn) / k;
      const size_t at =
          (((size_t)pn * n_chunks + chunk) * n_q + q) * k + (j % k);
      const float cs = part_s[at];
      const int ci = part_i[at];
      if (better(last_s, last_i, cs, ci) && better(cs, ci, s, i)) {
        s = cs;
        i = ci;
      }
    }
    int owner = 0;
    warp_best(s, i, owner);
    if (lane == 0) {
      out_s[(size_t)list * k + kk] = s;
      out_i[(size_t)list * k + kk] = i;
    }
    last_s = s;
    last_i = i;
  }
}

template <bool PER_NODE, bool MASK_NODES>
int launch(const float* q, const float* slabs, const uint8_t* valid,
           const int* node_ids, float* part_s, int* part_i, float* out_s,
           int* out_i, int n_planes, int n_nodes, int cap, int dim, int n_q,
           int k, cudaStream_t stream) {
  const int n_chunks = (cap + ROWS - 1) / ROWS;
  const size_t smem = (size_t)QTILE * dim * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        scan_chunks<MASK_NODES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid1(n_chunks, n_planes * n_nodes, (n_q + QTILE - 1) / QTILE);
  scan_chunks<MASK_NODES><<<grid1, THREADS, smem, stream>>>(
      q, slabs, valid, node_ids, part_s, part_i, n_nodes, cap, dim, n_q, k,
      n_chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_lists = (PER_NODE ? n_planes * n_nodes : n_planes) * n_q;
  merge_lists<PER_NODE><<<(n_lists + WARPS - 1) / WARPS, THREADS, 0,
                          stream>>>(part_s, part_i, out_s, out_i, n_planes,
                                    n_nodes, n_q, k, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch lists: part_s / part_i of n_planes * n_nodes * template_chunks(cap)
// * n_q * k elements each.  Returns cudaGetLastError() after the launches.
int template_chunks(int cap) { return (cap + ROWS - 1) / ROWS; }

int template_launch(const float* q, const float* slabs, const uint8_t* valid,
                    const int* node_ids, float* part_s, int* part_i,
                    float* out_s, int* out_i, int n_planes, int n_nodes,
                    int cap, int dim, int n_q, int k, int per_node,
                    int mask_nodes, cudaStream_t stream) {
  if (per_node)
    return launch<true, false>(q, slabs, valid, node_ids, part_s, part_i,
                               out_s, out_i, n_planes, n_nodes, cap, dim, n_q,
                               k, stream);
  if (mask_nodes)
    return launch<false, true>(q, slabs, valid, node_ids, part_s, part_i,
                               out_s, out_i, n_planes, n_nodes, cap, dim, n_q,
                               k, stream);
  return launch<false, false>(q, slabs, valid, node_ids, part_s, part_i,
                              out_s, out_i, n_planes, n_nodes, cap, dim, n_q,
                              k, stream);
}

}  // extern "C"
"""


def k1_wide_source() -> str:
    """vdb_topk.cu whose clustered scan also takes clusters of 9-16 blocks
    (non-portable sizes), plus ``vdb_topk_pernode_max_clusters``: how many
    clusters of a plan the card holds at once."""
    src = (CSRC / "vdb_topk.cu").read_text()
    src = sub(src, "constexpr int MAX_CLUSTER = 8; ",
              "constexpr int MAX_CLUSTER = 16;")
    src = sub(src, """  cudaError_t e = cudaSuccess;
  if (smem > allowed) {""", """  static bool wide = false;
  cudaError_t e = cudaSuccess;
  if (!wide) {
    e = cudaFuncSetAttribute(scan_fused<QT, MODE>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    wide = true;
  }
  if (smem > allowed) {""")
    return sub(src, "}  // namespace\n\nextern \"C\" {\n", """template <int QT>
int pernode_max_clusters(int cl, int dim, int stages) {
  const size_t smem = scan_smem(QT, dim, stages);
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = scan_config(cl, 1, 1, smem, 0, attr);
  int n = 0;
  if (scan_allow<QT, PER_NODE>(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, scan_fused<QT, PER_NODE>, &cfg) !=
          cudaSuccess)
    n = 0;
  return n;
}

}  // namespace

extern "C" {

// How many clusters of that plan the device holds at once (0: none).
int vdb_topk_pernode_max_clusters(int qt, int cl, int dim, int stages) {
  switch (qt) {
    case 1: return pernode_max_clusters<1>(cl, dim, stages);
    case 2: return pernode_max_clusters<2>(cl, dim, stages);
    case 4: return pernode_max_clusters<4>(cl, dim, stages);
    case 8: return pernode_max_clusters<8>(cl, dim, stages);
    case 16: return pernode_max_clusters<16>(cl, dim, stages);
    default: return 0;
  }
}
""")


def k1_argmax_source() -> str:
    """vdb_topk.cu whose clustered scan takes a tile into a running list
    by k rounds of warp arg-max over both (two candidates a lane)."""
    src = (CSRC / "vdb_topk.cu").read_text()
    src = sub(src, "template <int QT, int MODE>\n__global__", """// warp-wide arg-best of (score, slot, owner); every lane gets the winner
__device__ __forceinline__ void warp_best(float& s, int& i, int& owner) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    int i2 = __shfl_xor_sync(0xffffffffu, i, off);
    int o2 = __shfl_xor_sync(0xffffffffu, owner, off);
    if (better(s2, i2, s, i) || (s2 == s && i2 == i && o2 < owner)) {
      s = s2;
      i = i2;
      owner = o2;
    }
  }
}

template <int QT, int MODE>
__global__""")
    return sub(src, """          warp_sort(cs, ci, lane);
          if (t == 0) {                   // the list is empty
            ls[j] = cs;
            li[j] = ci;
          } else {
            warp_merge(ls[j], li[j], cs, ci, lane);
          }
""", """          float as[2] = {ls[j], cs};
          int ai[2] = {li[j], ci};
          float ns = -CUDART_INF_F;
          int ni = EMPTY_SLOT;
          for (int kk = 0; kk < k; ++kk) {
            const int pick = better(as[0], ai[0], as[1], ai[1]) ? 0 : 1;
            float s = as[pick];
            int i = ai[pick];
            int owner = lane * 2 + pick;
            warp_best(s, i, owner);
            if (owner / 2 == lane) {
              as[owner % 2] = -CUDART_INF_F;
              ai[owner % 2] = EMPTY_SLOT;
            }
            if (lane == kk) {
              ns = s;
              ni = i;
            }
          }
          ls[j] = ns;
          li[j] = ni;
""")


K1_PHASES = ("issue copies", "tile 0 lands", "tile 0 scores",
             "tile 0 selection", "tile 1 lands", "tile 1 scores",
             "tile 1 selection / rest", "cluster barrier", "merge",
             "final barrier")


def k1_trace_source() -> str:
    """The wide vdb_topk.cu (:func:`k1_wide_source`) whose clustered scan
    records ``%globaltimer`` at each phase of every block (thread 0), and
    ``%smid``."""
    src = k1_wide_source()
    src = sub(src, "namespace cg = cooperative_groups;", """namespace cg = cooperative_groups;
__device__ long long g_trace[4096][13];
__device__ __forceinline__ long long gtime() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define MARK(i) \\
  if (threadIdx.x == 0 && tb < 4096) g_trace[tb][i] = gtime();""")
    src = sub(src, "  // group 0: the query tile (zeros past m) and tile 0; group s: tile s\n",
              """  const int tb = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  MARK(0);
  if (threadIdx.x == 0 && tb < 4096) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_trace[tb][12] = sm;
  }
""")
    src = sub(src, "  for (int t = 0; t < n_tiles; ++t) {\n",
              "  MARK(1);\n  for (int t = 0; t < n_tiles; ++t) {\n"
              "    if (t == 1) MARK(4);\n")
    src = sub(src, "    cp_async_wait(stages - 1);\n    __syncthreads();\n",
              "    cp_async_wait(stages - 1);\n    __syncthreads();\n"
              "    if (t < 2) MARK(2 + 3 * t);\n")
    src = sub(src, "    // the stage is free: copy tile t + stages into it\n",
              "    if (t < 2) MARK(3 + 3 * t);\n"
              "    // the stage is free: copy tile t + stages into it\n")
    src = sub(src, "  cp_async_wait(0);               // a block without rows still has copies\n",
              "  MARK(7);\n  cp_async_wait(0);\n")
    src = sub(src, "  cluster.sync();\n\n  // block (qi mod cl) takes",
              "  cluster.sync();\n  MARK(8);\n\n  // block (qi mod cl) takes")
    src = sub(src, "  cluster.sync();                 // keep the lists alive for the readers\n",
              "  MARK(9);\n  cluster.sync();\n  MARK(10);\n")
    src = sub(src, "// How many clusters of that plan the device holds at once",
              """int k1_trace_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
}
// How many clusters of that plan the device holds at once""")
    return src


tl = None   # triton.language, bound by triton_adaln (Triton resolves the
#             kernel's names through this module's globals)


def triton_adaln():
    """The Triton K5 that ``csrc/adaln.cu`` replaced: one program a token
    row, D padded to a power of two, 4 warps.  Returns a launcher with the
    shipped wrapper's signature."""
    global tl
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch
    import triton
    import triton.language as tl

    @triton.jit
    def _adaln_kernel(x_ptr, shift_ptr, scale_ptr, out_ptr, n_tokens, dim,
                      shift_sb, scale_sb, eps, BLOCK_D: tl.constexpr):
        row = tl.program_id(0)
        b = row // n_tokens
        cols = tl.arange(0, BLOCK_D)
        mask = cols < dim
        x = tl.load(x_ptr + row * dim + cols, mask=mask,
                    other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=0) / dim
        xc = tl.where(mask, x - mean, 0.0)
        var = tl.sum(xc * xc, axis=0) / dim
        rstd = 1.0 / tl.sqrt(var + eps)
        sh = tl.load(shift_ptr + b * shift_sb + cols, mask=mask, other=0.0)
        sc = tl.load(scale_ptr + b * scale_sb + cols, mask=mask, other=0.0)
        y = xc * rstd * (1.0 + sc) + sh
        tl.store(out_ptr + row * dim + cols, y, mask=mask)

    def launch(x, shift, scale, eps=1e-5):
        b, t, d = x.shape
        out = torch.empty_like(x)
        block_d = triton.next_power_of_2(d)
        with torch.cuda.device(x.device):
            _adaln_kernel[(b * t,)](x, shift, scale, out, t, d,
                                    shift.stride(0), scale.stride(0), eps,
                                    BLOCK_D=block_d,
                                    num_warps=4 if block_d <= 1024 else 8)
        return out
    return launch


def call_ms(torch, fn, iters: int = 50, runs: int = 5) -> float:
    """Eager ms per call: the best of ``runs`` runs of ``iters``
    back-to-back calls between CUDA events (host launch cost included;
    the best run is the one least disturbed by the host's other load)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


NOP_SOURCE = """#include <cuda_runtime.h>
__global__ void nop() {}
// one warp a row of 192 float4 (768 floats), 6 a lane: K5's loads and
// stores without its arithmetic
__global__ void copy_rows(const float4* x, float4* y) {
  const size_t base = (size_t)(blockIdx.x * (blockDim.x / 32) +
                               threadIdx.x / 32) * 192 + threadIdx.x % 32;
  float4 v[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) v[j] = __ldg(x + base + 32 * j);
#pragma unroll
  for (int j = 0; j < 6; ++j) y[base + 32 * j] = v[j];
}
extern "C" int nop_launch(int blocks, int threads, cudaStream_t s) {
  nop<<<blocks, threads, 0, s>>>();
  return (int)cudaGetLastError();
}
extern "C" int copy_rows_launch(const float4* x, float4* y, int rows,
                                int warps, cudaStream_t s) {
  copy_rows<<<rows / warps, warps * 32, 0, s>>>(x, y);
  return (int)cudaGetLastError();
}
"""


def launch_floor(torch, lib, dev) -> dict:
    """Device ms of an empty kernel (the launch floor a short kernel
    stands on) and its eager ms per call through ctypes; and device ms of
    a copy of K5's (B, 256, 768) rows with K5's grid (two warps a block,
    four at B=8): the floor of one memory round trip."""
    P = ctypes.c_void_p
    lib.nop_launch.argtypes = [ctypes.c_int, ctypes.c_int, P]
    lib.copy_rows_launch.argtypes = [P, P, ctypes.c_int, ctypes.c_int, P]

    def run(blocks=128, threads=64):
        return lambda: lib.nop_launch(
            blocks, threads, torch.cuda.current_stream().cuda_stream)
    out = dict(ms=device_ms(torch, run()), call_ms=call_ms(torch, run()))
    print(f"[floor] empty kernel (128 blocks of 64 threads): device "
          f"{out['ms']:.4f} ms, eager {out['call_ms']:.4f} ms a call",
          flush=True)
    for b in (1, 8):
        x = torch.randn((b, 256, 768), device=dev)
        y = torch.empty_like(x)
        warps = 2 if b <= 4 else 4
        ms = device_ms(torch, lambda: lib.copy_rows_launch(
            x.data_ptr(), y.data_ptr(), b * 256, warps,
            torch.cuda.current_stream().cuda_stream))
        assert torch.equal(x, y)
        out[f"copy B={b}"] = ms
        print(f"[floor] copy of ({b}, 256, 768), a warp a row: device "
              f"{ms:.4f} ms", flush=True)
    return out


def build(sources: dict) -> dict:
    """name -> source text; one nvcc each, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    procs = {}
    for name, text in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [str(nvcc), *FLAGS, "-o", str(OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
    return {name: ctypes.CDLL(str(OUT / f"{name}.so")) for name in sources}


def sass_mix(so: Path, kernel: str) -> dict:
    """Opcode counts of one kernel's SASS (``cuobjdump -sass``)."""
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        if kernel not in fn.split("\n")[0]:
            continue
        ops = collections.Counter()
        for line in fn.splitlines():
            m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                         line)
            if m:
                ops[m.group(1)] += 1
        return dict(total=sum(ops.values()), top=ops.most_common(8))
    return {}


def device_ms(torch, fn, reps: int = 20, replays: int = 10) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def diag_k5(torch, pdl_lib, dev, gen) -> dict:
    from repro_torch.kernels import adaln, ref
    shipped = adaln._lib()
    pdl_lib.adaln_launch.argtypes = shipped.adaln_launch.argtypes
    tri = triton_adaln()
    out = {}
    d = 768
    for b in (1, 2, 4, 8):
        x = (torch.randn((b, 256, d), generator=gen) * 2 + 0.5).to(dev)
        ada = torch.randn((b, 6 * d), generator=gen).to(dev)
        sh, sc = ada[:, :d], ada[:, d:2 * d]
        want = ref.adaln_modulate_ref(x, sh, sc)
        y = torch.empty_like(x)
        w = torch.randn((d, d), generator=gen).to(dev)
        mm = torch.empty((b * 256, d), device=dev)

        def raw(lib, wpb):
            def run():
                err = lib.adaln_launch(
                    x.data_ptr(), sh.data_ptr(), sc.data_ptr(), y.data_ptr(),
                    b, 256, d, sh.stride(0), sc.stride(0), wpb, 1e-5,
                    torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
            return run
        wpb = adaln.warps_per_block(b * 256)
        # cuda, triton: through their Python wrappers; raw, pdl: the bare
        # ctypes call of the shipped and the dependent-launch library
        variants = {"cuda": lambda: adaln.launch(x, sh, sc),
                    "triton": lambda: tri(x, sh, sc),
                    "raw": raw(shipped, wpb),
                    "pdl": raw(pdl_lib, wpb)}
        for name, fn in variants.items():
            fn()
            torch.cuda.synchronize()
            got = y if name in ("raw", "pdl") else fn()
            err = float((got - want).abs().max())

            def after_mm(fn=fn):
                torch.mm(x.view(-1, d), w, out=mm)
                fn()
            row = dict(ms=device_ms(torch, fn), call_ms=call_ms(torch, fn),
                       mm_ms=device_ms(torch, lambda: torch.mm(
                           x.view(-1, d), w, out=mm)),
                       mm_then_ms=device_ms(torch, after_mm), max_abs_err=err)
            out[f"{name} B={b}"] = row
            print(f"[k5] {name:<6} B={b}: device {row['ms']:.4f} ms, eager "
                  f"{row['call_ms']:.4f} ms/call, behind a matmul "
                  f"{row['mm_then_ms']:.4f} ms (matmul alone "
                  f"{row['mm_ms']:.4f}); err {err:.2e}", flush=True)
        variants["pdl"]()
        same = torch.equal(variants["cuda"](), y)
        print(f"[k5] pdl B={b}: same bits as the shipped kernel: {same}",
              flush=True)
        for wpb_ in (1, 2, 4, 8):
            ms = device_ms(torch, raw(shipped, wpb_))
            out[f"sweep {wpb_} B={b}"] = dict(ms=ms)
            print(f"[k5] {wpb_} warps a block, B={b}: {ms:.4f} ms"
                  + ("  (launcher's choice)" if wpb_ == wpb else ""),
                  flush=True)
    return out


def template_args(lib) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.template_launch.argtypes = [P] * 8 + [I] * 8 + [P]
    lib.template_chunks.argtypes = [I]


def two_pass(torch, lib, q, slabs, valid, nids, k, *, per_node=False,
             mask_nodes=False):
    """The template's two launches on preallocated scratch and outputs:
    (run, (scores, ids))."""
    dev = q.device
    n_idx, n_nodes, cap, d = slabs.shape
    qn = q.shape[0]
    chunks = lib.template_chunks(cap)
    part_s = torch.empty((n_idx * n_nodes * chunks * qn * k,), device=dev)
    part_i = torch.empty(part_s.shape, dtype=torch.int32, device=dev)
    shape = (n_idx, n_nodes, qn, k) if per_node else (n_idx, qn, k)
    o_s = torch.empty(shape, device=dev)
    o_i = torch.empty(shape, dtype=torch.int32, device=dev)

    def run():
        err = lib.template_launch(
            q.data_ptr(), slabs.data_ptr(), valid.data_ptr(),
            nids.data_ptr(), part_s.data_ptr(), part_i.data_ptr(),
            o_s.data_ptr(), o_i.data_ptr(), n_idx, n_nodes, cap, d, qn, k,
            int(per_node), int(mask_nodes),
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
    return run, (o_s, o_i)


def same(a, b) -> bool:
    return all(x.equal(y) for x, y in zip(a, b))


def unit_case(torch, gen, dev, shape, qn):
    slabs = torch.randn(shape, generator=gen)
    slabs /= slabs.norm(dim=-1, keepdim=True)
    q = torch.randn((qn, shape[-1]), generator=gen)
    q /= q.norm(dim=-1, keepdim=True)
    valid = torch.rand(shape[-3:-1] if len(shape) == 4 else shape[:1],
                       generator=gen) < 0.7
    return q.to(dev), slabs.to(dev), valid.to(dev)


def diag_k1(torch, template_lib, argmax_lib, wide_lib, dev, gen) -> dict:
    from repro_torch.kernels import vdb_topk
    lib = vdb_topk._lib()
    for lib_ in (argmax_lib, wide_lib):
        lib_.vdb_topk_pernode_launch.argtypes = \
            lib.vdb_topk_pernode_launch.argtypes
    wide_lib.vdb_topk_pernode_max_clusters.argtypes = [ctypes.c_int] * 4
    out = {}
    k = 8

    def clustered(q, slabs, valid, cl=None, lib_=lib):
        qn, cap = q.shape[0], slabs.shape[2]
        p = vdb_topk.pernode_plan(qn, cap, 512)
        if cl is not None:
            rows = -(-cap // cl)
            fixed = p["smem_bytes"] - p["stages"] * 4 * 32 * 512
            p = dict(p, cluster_blocks=cl, block_rows=rows, stages=min(
                4, -(-rows // 32), (vdb_topk.SMEM_LIMIT - fixed) // (
                    4 * 32 * 512)))
        o_s = torch.empty((2, 4, qn, k), device=dev)
        o_i = torch.empty((2, 4, qn, k), dtype=torch.int32, device=dev)

        def run():
            err = lib_.vdb_topk_pernode_launch(
                q.data_ptr(), slabs.data_ptr(), valid.data_ptr(),
                o_s.data_ptr(), o_i.data_ptr(), 2, 4, cap, 512, qn, k,
                p["query_tile"], p["cluster_blocks"], p["block_rows"],
                p["stages"], torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
        return run, (o_s, o_i), p

    for cap, qns in ((400, (1, 2, 3, 4, 5, 6, 7, 8)), (4096, (1, 8))):
        for qn in qns:
            q, slabs, valid = unit_case(torch, gen, dev, (2, 4, cap, 512), qn)
            bound = (slabs.numel() * 4 + q.numel() * 4 + valid.numel()
                     + 2 * 4 * qn * k * 8) / 3.35e12 * 1e3
            new, o_new, p = clustered(q, slabs, valid)
            old, o_old = two_pass(torch, template_lib, q, slabs, valid, q, k,
                                  per_node=True)
            am, o_am, _ = clustered(q, slabs, valid, lib_=argmax_lib)
            for fn in (new, old, am):
                fn()
            torch.cuda.synchronize()
            if not (same(o_new, o_old) and torch.equal(o_am[1], o_old[1])):
                raise SystemExit(f"k1: clustered != two-pass at cap {cap} "
                                 f"Q {qn}")
            row = dict(plan=p, bound_ms=bound)
            for name, fn in (("clustered", new), ("two-pass", old),
                             ("argmax", am)):
                row[name] = dict(ms=device_ms(torch, fn),
                                 call_ms=call_ms(torch, fn))
            out[f"cap {cap} Q={qn}"] = row
            print(f"[k1] cap {cap} Q={qn} (plan {p}): clustered "
                  f"{row['clustered']['ms']:.4f} ms, two-pass "
                  f"{row['two-pass']['ms']:.4f}, argmax "
                  f"{row['argmax']['ms']:.4f}, bound {bound:.4f}; eager "
                  f"{row['clustered']['call_ms']:.4f} / "
                  f"{row['two-pass']['call_ms']:.4f} ms a call; same bits",
                  flush=True)
            if (cap, qn) in ((400, 1), (400, 8), (4096, 8)):
                for cl in (1, 2, 4, 8, 13, 16):
                    fn, _, pc = clustered(q, slabs, valid, cl=cl,
                                          lib_=wide_lib)
                    ms = device_ms(torch, fn)
                    fit = wide_lib.vdb_topk_pernode_max_clusters(
                        pc["query_tile"], cl, 512, pc["stages"])
                    out[f"cap {cap} Q={qn} cluster {cl}"] = dict(
                        ms=ms, max_clusters=fit, plan=pc)
                    print(f"[k1]   cluster of {cl:>2} ({pc['block_rows']} "
                          f"rows a block, {pc['stages']} stages): {ms:.4f} "
                          f"ms; {fit} clusters fit at once", flush=True)
    return out


def diag_k2(torch, template_lib, wide_lib, dev, gen) -> dict:
    """K2 node-masked and global against the two-pass template, at Q = 1,
    2, 8, 17 over 2 x 4 x 400 x 512 and Q = 8 over 2 x 4 x 4096 x 512,
    k = 8, unit vectors, node ids drawn from the 4 nodes: device and eager
    ms (bare ctypes calls on preallocated outputs, the shipped global
    scan's list buffer included), bound (the whole slab; for node-masked
    also the named nodes' slabs alone), same bits as the template.  The
    global scan also as design (b), one cluster per (plane, query tile)
    over every node's rows (the per-node scan of one node spanning the
    plane), with clusters of the plan's size (up to 8) and of 16."""
    from repro_torch.kernels import vdb_topk
    lib = vdb_topk._lib()
    wide_lib.vdb_topk_pernode_launch.argtypes = \
        lib.vdb_topk_pernode_launch.argtypes
    out = {}
    k = 8
    for cap, qn in ((400, 1), (400, 2), (400, 8), (400, 17), (4096, 8)):
        q, slabs, valid = unit_case(torch, gen, dev, (2, 4, cap, 512), qn)
        nids = torch.randint(0, 4, (qn,), generator=gen,
                             dtype=torch.int32).to(dev)
        n_idx, n_nodes = 2, 4
        p = vdb_topk.pernode_plan(qn, cap, 512)
        n_tiles = -(-qn // p["query_tile"])
        lists_s = torch.empty((n_idx, n_nodes, qn, k), device=dev)
        lists_i = torch.empty(lists_s.shape, dtype=torch.int32, device=dev)
        tickets = torch.zeros((n_idx * n_tiles * p["cluster_blocks"],),
                              dtype=torch.int32, device=dev)
        fixed = (q.numel() * 4 + valid.numel() + qn * 4
                 + n_idx * qn * k * 8)
        named = len(set(nids.tolist()))
        bound = (slabs.numel() * 4 + fixed) / 3.35e12 * 1e3
        bound_named = (slabs.numel() * 4 * named // n_nodes + fixed) \
            / 3.35e12 * 1e3
        for mask in (True, False):
            o_s = torch.empty((n_idx, qn, k), device=dev)
            o_i = torch.empty(o_s.shape, dtype=torch.int32, device=dev)

            def new(mask=mask, o_s=o_s, o_i=o_i):
                err = lib.vdb_topk_sharded_launch(
                    q.data_ptr(), slabs.data_ptr(), valid.data_ptr(),
                    nids.data_ptr(), o_s.data_ptr(), o_i.data_ptr(),
                    lists_s.data_ptr(), lists_i.data_ptr(),
                    tickets.data_ptr(), n_idx, n_nodes, cap, 512, qn, k,
                    int(mask), p["query_tile"], p["cluster_blocks"],
                    p["block_rows"], p["stages"],
                    torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
            old, o_old = two_pass(torch, template_lib, q, slabs, valid, nids,
                                  k, mask_nodes=mask)
            fns = [("clustered", new, (o_s, o_i)), ("template", old, o_old)]
            if not mask:
                for name, lib_, cl in (("b", lib, None),
                                       ("b16", wide_lib, 16)):
                    pb = vdb_topk.pernode_plan(qn, n_nodes * cap, 512)
                    if cl is not None:
                        rows = -(-n_nodes * cap // cl)
                        fx = pb["smem_bytes"] - pb["stages"] * 4 * 32 * 512
                        pb = dict(pb, cluster_blocks=cl, block_rows=rows,
                                  stages=min(4, -(-rows // 32),
                                             (vdb_topk.SMEM_LIMIT - fx)
                                             // (4 * 32 * 512)))
                    b_s = torch.empty((n_idx, 1, qn, k), device=dev)
                    b_i = torch.empty(b_s.shape, dtype=torch.int32,
                                      device=dev)

                    def run_b(lib_=lib_, pb=pb, b_s=b_s, b_i=b_i):
                        err = lib_.vdb_topk_pernode_launch(
                            q.data_ptr(), slabs.data_ptr(), valid.data_ptr(),
                            b_s.data_ptr(), b_i.data_ptr(), n_idx, 1,
                            n_nodes * cap, 512, qn, k, pb["query_tile"],
                            pb["cluster_blocks"], pb["block_rows"],
                            pb["stages"],
                            torch.cuda.current_stream().cuda_stream)
                        assert err == 0, err
                    fns.append((name, run_b, (b_s[:, 0], b_i[:, 0])))
            for _, fn, _ in fns:
                fn()
            torch.cuda.synchronize()
            for name, _, got in fns:
                if not same(got, o_old):
                    raise SystemExit(f"k2: {name} != template at cap {cap} "
                                     f"Q {qn} mask {mask}")
            mode = "node-masked" if mask else "global"
            row = dict(plan=p, bound_ms=bound, nodes_named=named)
            if mask:
                row["bound_named_ms"] = bound_named
            for name, fn, _ in fns:
                row[name] = dict(ms=device_ms(torch, fn),
                                 call_ms=call_ms(torch, fn))
            out[f"{mode} cap {cap} Q={qn}"] = row
            print(f"[k2] {mode} cap {cap} Q={qn} ({named} nodes named): "
                  + ", ".join(f"{n} {row[n]['ms']:.4f} ms (eager "
                              f"{row[n]['call_ms']:.4f})"
                              for n, _, _ in fns)
                  + f"; bound {bound:.4f}"
                  + (f" (named nodes alone {bound_named:.4f})" if mask
                     else "") + "; same bits", flush=True)
    return out


def split_plan(vdb_topk, n_q: int, n: int, dim: int, node_rows: int) -> dict:
    """``vdb_topk.single_plan`` with nodes of at most ``node_rows`` rows
    in place of ``SINGLE_NODE_ROWS``."""
    seg = -(-n // -(-n // node_rows))
    return dict(vdb_topk.pernode_plan(n_q, seg, dim), split=-(-n // seg),
                segment=seg)


def diag_k3(torch, template_lib, dev, gen) -> dict:
    """K3 against the two-pass template at Q = 1 and 8 over 400 x 512 and
    4096 x 512, k = 8: device and eager ms, bound, same bits.  Then the
    shipped scan with the db split into nodes of at most 128-1024 rows
    (``split_plan``; one node: no merge across clusters), same bits
    each."""
    from repro_torch.kernels import vdb_topk
    lib = vdb_topk._lib()
    out = {}
    k = 8
    for n in (400, 4096):
        for qn in (1, 8):
            q, db, valid = unit_case(torch, gen, dev, (n, 512), qn)

            def clustered(node_rows):
                p = split_plan(vdb_topk, qn, n, 512, node_rows)
                o_s = torch.empty((qn, k), device=dev)
                o_i = torch.empty((qn, k), dtype=torch.int32, device=dev)
                l_s = torch.empty((p["split"], qn, k), device=dev)
                l_i = torch.empty(l_s.shape, dtype=torch.int32, device=dev)
                t = torch.zeros((-(-qn // p["query_tile"])
                                 * p["cluster_blocks"],),
                                dtype=torch.int32, device=dev)

                def run():
                    err = lib.vdb_topk_single_launch(
                        q.data_ptr(), db.data_ptr(), valid.data_ptr(),
                        o_s.data_ptr(), o_i.data_ptr(), l_s.data_ptr(),
                        l_i.data_ptr(), t.data_ptr(), n, 512, qn, k,
                        p["split"], p["segment"], p["query_tile"],
                        p["cluster_blocks"], p["block_rows"], p["stages"],
                        torch.cuda.current_stream().cuda_stream)
                    assert err == 0, err
                return run, (o_s, o_i), p
            new, o_new, p = clustered(vdb_topk.SINGLE_NODE_ROWS)
            old, o_old = two_pass(torch, template_lib, q, db[None, None],
                                  valid[None], q, k, per_node=True)
            new()
            old()
            torch.cuda.synchronize()
            o_old = (o_old[0][0, 0], o_old[1][0, 0])
            if not same(o_new, o_old):
                raise SystemExit(f"k3: clustered != template at {n} Q {qn}")
            bound = (db.numel() * 4 + q.numel() * 4 + n + qn * k * 8) \
                / 3.35e12 * 1e3
            row = dict(plan=p, bound_ms=bound)
            for name, fn in (("clustered", new), ("template", old)):
                row[name] = dict(ms=device_ms(torch, fn),
                                 call_ms=call_ms(torch, fn))
            out[f"{n} Q={qn}"] = row
            print(f"[k3] db ({n}, 512) Q={qn} (plan {p}): clustered "
                  f"{row['clustered']['ms']:.4f} ms, template "
                  f"{row['template']['ms']:.4f}, bound {bound:.4f}; eager "
                  f"{row['clustered']['call_ms']:.4f} / "
                  f"{row['template']['call_ms']:.4f} ms a call; same bits",
                  flush=True)
            seen = set()
            for node_rows in (1 << 20, 1024, 512, 256, 128):
                fn, o, pr = clustered(node_rows)
                if pr["split"] in seen:
                    continue
                seen.add(pr["split"])
                fn()
                torch.cuda.synchronize()
                if not same(o, o_old):
                    raise SystemExit(f"k3: split {pr['split']} != template "
                                     f"at {n} Q {qn}")
                ms = device_ms(torch, fn)
                out[f"{n} Q={qn} split {pr['split']}"] = dict(ms=ms, plan=pr)
                print(f"[k3]   {pr['split']:>2} node(s) of {pr['segment']} "
                      f"rows ({pr['cluster_blocks']} blocks of "
                      f"{pr['block_rows']}): {ms:.4f} ms; same bits",
                      flush=True)
    return out


def trace_k1(torch, lib, dev, gen) -> dict:
    """The traced clustered scan at the serving shape (2 x 4 x 400 x 512,
    k = 8), Q = 1 and 8, at the plan's cluster size and at 8 and 16:
    SMs used and the median us of each phase over the blocks."""
    import numpy as np

    from repro_torch.kernels import vdb_topk
    lib.vdb_topk_pernode_launch.argtypes = \
        vdb_topk._lib().vdb_topk_pernode_launch.argtypes
    lib.k1_trace_read.argtypes = [ctypes.c_void_p]
    out = {}
    cap, k = 400, 8
    slabs = torch.randn((2, 4, cap, 512), generator=gen).to(dev)
    valid = (torch.rand((4, cap), generator=gen) < 0.7).to(dev)
    for qn in (1, 8):
        q = torch.randn((qn, 512), generator=gen).to(dev)
        o_s = torch.empty((2, 4, qn, k), device=dev)
        o_i = torch.empty((2, 4, qn, k), dtype=torch.int32, device=dev)
        base = vdb_topk.pernode_plan(qn, cap, 512)
        for cl in (None, 8, 16):
            p = dict(base)
            if cl is not None:
                rows = -(-cap // cl)
                fixed = p["smem_bytes"] - p["stages"] * 4 * 32 * 512
                p.update(cluster_blocks=cl, block_rows=rows, stages=min(
                    4, -(-rows // 32), (vdb_topk.SMEM_LIMIT - fixed) // (
                        4 * 32 * 512)))
            for _ in range(3):       # warm; the last run is the one read
                err = lib.vdb_topk_pernode_launch(
                    q.data_ptr(), slabs.data_ptr(), valid.data_ptr(),
                    o_s.data_ptr(), o_i.data_ptr(), 2, 4, cap, 512, qn, k,
                    p["query_tile"], p["cluster_blocks"], p["block_rows"],
                    p["stages"], torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
            torch.cuda.synchronize()
            tr = np.zeros((4096, 13), dtype=np.int64)
            assert lib.k1_trace_read(tr.ctypes.data) == 0
            blocks = 8 * p["cluster_blocks"]
            tr = tr[:blocks]
            t0 = tr[:, 0].min()
            marks = tr[:, :11].astype(np.float64)
            two = p["block_rows"] > 32
            cols = list(range(11)) if two else [0, 1, 2, 3, 7, 8, 9, 10]
            names = (K1_PHASES if two else
                     K1_PHASES[:3] + ("tile 0 selection / rest",)
                     + K1_PHASES[7:])
            ph = np.median(np.diff(marks[:, cols], axis=1), axis=0) / 1e3
            row = dict(plan=p, sms=len(set(tr[:, 12].tolist())),
                       start_spread_us=float((tr[:, 0].max() - t0) / 1e3),
                       end_us=float((tr[:, 10].max() - t0) / 1e3),
                       phases_us=dict(zip(names, ph.tolist())))
            out[f"Q={qn} cluster {p['cluster_blocks']}"] = row
            print(f"[k1 trace] Q={qn} cluster {p['cluster_blocks']} "
                  f"({p['block_rows']} rows, {p['stages']} stages): "
                  f"{blocks} blocks on {row['sms']} SMs, starts spread "
                  f"{row['start_spread_us']:.2f} us, last block done "
                  f"{row['end_us']:.2f} us after the first start; median us: "
                  + ", ".join(f"{a} {b:.2f}" for a, b in
                              row["phases_us"].items()), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("k1", "k2", "k3", "k4", "k4bf16",
                                       "k5", "k6"), default=None)
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_diag: needs an NVIDIA GPU", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ref
    P, I = ctypes.c_void_p, ctypes.c_int
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    want = {args.only} if args.only else {"k1", "k2", "k3", "k4", "k4bf16",
                                           "k5", "k6"}
    k4 = ("shipped", "cvt", "hi", "raw") if "k4" in want else ()
    rules = tuple(GN_RULES) if "k6" in want else ()
    extra = {"nop": NOP_SOURCE}
    if "k5" in want:
        extra["adaln_pdl"] = k5_pdl_source()
    if want & {"k1", "k2", "k3"}:
        extra["vdb_template"] = TEMPLATE_SOURCE
    if want & {"k1", "k2"}:
        extra["vdb_wide"] = k1_wide_source()
    if "k1" in want:
        extra["vdb_argmax"] = k1_argmax_source()
        extra["vdb_trace"] = k1_trace_source()
    k4bf16 = ("shipped", "hilo") if "k4bf16" in want else ()
    libs = build({**{f"fa_{v}": k4_source(v) for v in k4},
                  **{f"fa16_{v}": k4_bf16_source(v) for v in k4bf16},
                  **{f"gn_{r}": k6_source(GN_RULES[r]) for r in rules},
                  **extra})
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    result = dict(card=card, k1={}, k2={}, k3={}, k4={}, k4bf16={}, k5={},
                  k6={})
    result["floor"] = launch_floor(torch, libs["nop"], dev)
    if "vdb_template" in libs:
        template_args(libs["vdb_template"])
    if "k5" in want:
        result["k5"] = diag_k5(torch, libs["adaln_pdl"], dev, gen)
    if k4bf16:
        result["k4bf16"] = diag_k4_bf16(torch, libs, dev, gen)
    if "k3" in want:
        result["k3"] = diag_k3(torch, libs["vdb_template"], dev, gen)
    if "k2" in want:
        result["k2"] = diag_k2(torch, libs["vdb_template"], libs["vdb_wide"],
                               dev, gen)
    if "k1" in want:
        result["k1"] = diag_k1(torch, libs["vdb_template"],
                               libs["vdb_argmax"], libs["vdb_wide"], dev, gen)
        result["k1_trace"] = trace_k1(torch, libs["vdb_trace"], dev, gen)

    qkv = torch.randn((8, 256, 3, 12, 64), generator=gen).to(dev)
    for v in k4:
        lib = libs[f"fa_{v}"]
        lib.flash_attention_launch.argtypes = [P] * 4 + [I] * 5 + [
            P, ctypes.c_float, I, P]
        mix = sass_mix(OUT / f"fa_{v}.so", "flash_fwd_tcILi64E")
        for b in (1, 8):
            q, k, vv = qkv[:b, :, 0], qkv[:b, :, 1], qkv[:b, :, 2]
            out = torch.empty((b, 256, 12, 64), device=dev)
            st = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                         *vv.stride()[:3])

            def run():
                err = lib.flash_attention_launch(
                    q.data_ptr(), k.data_ptr(), vv.data_ptr(), out.data_ptr(),
                    b, 12, 256, 256, 64, ctypes.cast(st, P), 0.125, 0,
                    torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
            run()
            torch.cuda.synchronize()
            e = float((out - ref.flash_attention_ref(q, k, vv)).abs().max())
            ms = device_ms(torch, run)
            result["k4"][f"{v} B={b}"] = dict(ms=ms, max_abs_err=e, sass=mix)
            print(f"[k4] {v:<8} B={b}: {ms:.4f} ms, err {e:.2e}; SASS "
                  f"{mix.get('total')} instructions, top {mix.get('top')}",
                  flush=True)

    for b in (1, 2, 4, 8) if k4 else ():
        lib = libs["fa_shipped"]
        lib.flash_attention_force.argtypes = [I, I]
        lib.flash_attention_layout.argtypes = [I] * 5 + [P]
        q, k, vv = qkv[:b, :, 0], qkv[:b, :, 1], qkv[:b, :, 2]
        out = torch.empty((b, 256, 12, 64), device=dev)
        st = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                     *vv.stride()[:3])
        for qw, kw in ((4, 1), (2, 1), (1, 1), (2, 2), (1, 2), (1, 4),
                       (0, 0)):
            lib.flash_attention_force(qw, kw)
            lay = (ctypes.c_longlong * 3)()
            lib.flash_attention_layout(b, 12, 256, 256, 64,
                                       ctypes.cast(lay, P))
            if lay[2] > 232448:        # more shared memory than a block has
                continue

            def run():
                err = lib.flash_attention_launch(
                    q.data_ptr(), k.data_ptr(), vv.data_ptr(), out.data_ptr(),
                    b, 12, 256, 256, 64, ctypes.cast(st, P), 0.125, 0,
                    torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
            ms = device_ms(torch, run)
            e = float((out - ref.flash_attention_ref(q, k, vv)).abs().max())
            name = f"{qw}x{kw}" if qw else "launcher's choice"
            result["k4"][f"layout {name} B={b}"] = dict(ms=ms, max_abs_err=e)
            print(f"[k4] layout {name:<17} B={b}: {ms:.4f} ms, err {e:.2e}",
                  flush=True)
        lib.flash_attention_force(0, 0)

    for rule in rules:
        lib = libs[f"gn_{rule}"]
        lib.groupnorm_silu_launch.argtypes = [P] * 4 + [I] * 4 + [
            ctypes.c_float, P]
        lib.gn_trace_read.argtypes = [P]
        lib.groupnorm_silu_plan.argtypes = [I, I, I, P]
        for b in (1, 8):
            for hw, c in VAE_RESBLOCK_SHAPES:
                x = torch.randn((b, hw, hw, c), generator=gen).to(dev)
                sc = torch.ones((c,), device=dev)
                out = torch.empty_like(x)

                def run():
                    err = lib.groupnorm_silu_launch(
                        x.data_ptr(), sc.data_ptr(), sc.data_ptr(),
                        out.data_ptr(), b, hw * hw, c, 32, 1e-5,
                        torch.cuda.current_stream().cuda_stream)
                    assert err == 0, err
                ms = device_ms(torch, run)
                row = dict(ms=ms)
                line = f"[k6] {rule:<14} ({b}, {hw}, {hw}, {c}): {ms:.4f} ms"
                if b == 1:
                    plan = (ctypes.c_longlong * 8)()
                    lib.groupnorm_silu_plan(hw * hw, c, 32,
                                            ctypes.cast(plan, P))
                    blocks = plan[1] * plan[2]
                    run()
                    torch.cuda.synchronize()
                    tr = np.zeros((4096, 11), dtype=np.int64)
                    assert lib.gn_trace_read(tr.ctypes.data) == 0
                    tr = tr[:blocks]
                    phases = np.median(np.diff(tr[:, :10], axis=1), axis=0)
                    row.update(blocks=blocks,
                               sms=len(set(tr[:, 10].tolist())),
                               phases_us=dict(zip(GN_PHASES,
                                                  (phases / 1e3).tolist())))
                    line += (f"; {blocks} blocks on {row['sms']} SMs; median "
                             "us: " + ", ".join(
                                 f"{k} {v:.2f}"
                                 for k, v in row["phases_us"].items()))
                result["k6"][f"{rule} ({b}, {hw}, {hw}, {c})"] = row
                print(line, flush=True)
                del x, out
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
