#!/usr/bin/env python3
"""Diagnostics of the port's redesigned kernels K4 and K6 on one NVIDIA
GPU, from variants of their CUDA sources.

    python3 tools/kernel_diag.py [--only k4|k6] [--out diag.json]

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

Device ms: a CUDA graph of 20 calls replayed 10 times between CUDA events
(inputs warm in L2).  Needs a GPU; fails without one.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("k4", "k6"), default=None)
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
    k4 = () if args.only == "k6" else ("shipped", "cvt", "hi", "raw")
    rules = () if args.only == "k4" else tuple(GN_RULES)
    libs = build({**{f"fa_{v}": k4_source(v) for v in k4},
                  **{f"gn_{r}": k6_source(GN_RULES[r]) for r in rules}})
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    result = dict(card=card, k4={}, k6={})

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
