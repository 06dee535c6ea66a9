#!/usr/bin/env python3
"""Diagnostics of the port's redesigned kernels K1, K4, K5 and K6 on one
NVIDIA GPU, from variants of their sources.

    python3 tools/kernel_diag.py [--only k1|k4|k5|k6] [--out diag.json]

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
  two-pass scan it replaced (``vdb_topk_launch`` with ``per_node``, kept
  in the library) and against ``argmax`` (the clustered scan with k
  rounds of warp arg-max over the running list and a tile instead of the
  bitonic sort and merge), at 2 planes x 4 nodes x 400 slots x 512 dims,
  k = 8, Q = 1..8 (the serving shapes), and at 4096 slots a node; the
  clustered scan's bits must equal the two-pass scan's.  Then the
  clustered scan at every cluster size of {1, 2, 4, 8, 13, 16} (Q = 1
  and 8 at 400 slots, Q = 8 at 4096; ``wide``: the shipped source, which
  stops at the portable 8, taking non-portable clusters of up to 16),
  with how many of its clusters fit on the card at once, and a traced
  copy of ``wide`` (``%globaltimer`` at each phase
  of every block, ``%smid``) at 400 slots, Q = 1 and 8, clusters of the
  plan's size, 8 and 16.
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


def k1_wide_source() -> str:
    """vdb_topk.cu whose clustered scan also takes clusters of 9-16 blocks
    (non-portable sizes), plus ``vdb_topk_pernode_max_clusters``: how many
    clusters of a plan the card holds at once."""
    src = (CSRC / "vdb_topk.cu").read_text()
    src = sub(src, "constexpr int PN_MAX_CLUSTER = 8; ",
              "constexpr int PN_MAX_CLUSTER = 16;")
    src = sub(src, """  cudaError_t e = cudaSuccess;
  if (smem > allowed) {""", """  static bool wide = false;
  cudaError_t e = cudaSuccess;
  if (!wide) {
    e = cudaFuncSetAttribute(pernode_fused<QT>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    wide = true;
  }
  if (smem > allowed) {""")
    return sub(src, "}  // namespace\n\nextern \"C\" {\n", """template <int QT>
int pernode_max_clusters(int cl, int dim, int stages) {
  const size_t smem = pernode_smem(QT, dim, stages);
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = pernode_config(cl, 1, 1, smem, 0, attr);
  int n = 0;
  if (pernode_allow<QT>(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, pernode_fused<QT>, &cfg) !=
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
    src = sub(src, "  // group 0: the query tile (zeros past n_q) and tile 0; group s: tile s\n",
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
    with torch.cuda.graph(graph):
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


def diag_k1(torch, argmax_lib, wide_lib, dev, gen) -> dict:
    from repro_torch.kernels import vdb_topk
    lib = vdb_topk._lib()
    for lib_ in (argmax_lib, wide_lib):
        lib_.vdb_topk_pernode_launch.argtypes = \
            lib.vdb_topk_pernode_launch.argtypes
    wide_lib.vdb_topk_pernode_max_clusters.argtypes = [ctypes.c_int] * 4
    out = {}
    k = 8

    def case(cap, qn):
        slabs = torch.randn((2, 4, cap, 512), generator=gen)
        slabs /= slabs.norm(dim=-1, keepdim=True)
        q = torch.randn((qn, 512), generator=gen)
        q /= q.norm(dim=-1, keepdim=True)
        valid = torch.rand((4, cap), generator=gen) < 0.7
        return q.to(dev), slabs.to(dev), valid.to(dev)

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

    def two_pass(q, slabs, valid):
        qn, cap = q.shape[0], slabs.shape[2]
        chunks = lib.vdb_topk_chunks(cap)
        part_s = torch.empty((8 * chunks * qn * k,), device=dev)
        part_i = torch.empty(part_s.shape, dtype=torch.int32, device=dev)
        o_s = torch.empty((2, 4, qn, k), device=dev)
        o_i = torch.empty((2, 4, qn, k), dtype=torch.int32, device=dev)

        def run():
            err = lib.vdb_topk_launch(
                q.data_ptr(), slabs.data_ptr(), valid.data_ptr(),
                q.data_ptr(), part_s.data_ptr(), part_i.data_ptr(),
                o_s.data_ptr(), o_i.data_ptr(), 2, 4, cap, 512, qn, k, 1, 0,
                torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
        return run, (o_s, o_i)

    for cap, qns in ((400, (1, 2, 3, 4, 5, 6, 7, 8)), (4096, (1, 8))):
        for qn in qns:
            q, slabs, valid = case(cap, qn)
            bound = (slabs.numel() * 4 + q.numel() * 4 + valid.numel()
                     + 2 * 4 * qn * k * 8) / 3.35e12 * 1e3
            new, o_new, p = clustered(q, slabs, valid)
            old, o_old = two_pass(q, slabs, valid)
            am, o_am, _ = clustered(q, slabs, valid, lib_=argmax_lib)
            for fn in (new, old, am):
                fn()
            torch.cuda.synchronize()
            if not (torch.equal(o_new[0], o_old[0])
                    and torch.equal(o_new[1], o_old[1])
                    and torch.equal(o_am[1], o_old[1])):
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
    ap.add_argument("--only", choices=("k1", "k4", "k5", "k6"),
                    default=None)
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
    want = {args.only} if args.only else {"k1", "k4", "k5", "k6"}
    k4 = ("shipped", "cvt", "hi", "raw") if "k4" in want else ()
    rules = tuple(GN_RULES) if "k6" in want else ()
    extra = {"nop": NOP_SOURCE}
    if "k5" in want:
        extra["adaln_pdl"] = k5_pdl_source()
    if "k1" in want:
        extra["vdb_argmax"] = k1_argmax_source()
        extra["vdb_wide"] = k1_wide_source()
        extra["vdb_trace"] = k1_trace_source()
    libs = build({**{f"fa_{v}": k4_source(v) for v in k4},
                  **{f"gn_{r}": k6_source(GN_RULES[r]) for r in rules},
                  **extra})
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    result = dict(card=card, k1={}, k4={}, k5={}, k6={})
    result["floor"] = launch_floor(torch, libs["nop"], dev)
    if "k5" in want:
        result["k5"] = diag_k5(torch, libs["adaln_pdl"], dev, gen)
    if "k1" in want:
        result["k1"] = diag_k1(torch, libs["vdb_argmax"], libs["vdb_wide"],
                               dev, gen)
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
