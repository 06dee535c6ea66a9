#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of CacheGenius on one NVIDIA GPU.

    python3 chip_smoke.py [--requests 8] [--out results.json] [--profile]

Run from the root of a checkout.  Phases, one status line each; any
failure exits nonzero (nothing is caught):

1. card and build — print the card's name and power limit
   (``nvidia-smi``) and PyTorch's float flags (the port sets its own:
   the backend turns TF32 off on the card, and the serve phase fails if
   it did not), build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` (one process per
   source, all at once); print each kernel's registers and spills
   (``-Xptxas -v``) and count K4's tensor-core (HMMA) instructions with
   ``cuobjdump``.
2. kernels — each of the six kernels against its plain PyTorch version
   on the same inputs on the card, at the main paths' shapes: the
   cluster scans (K1 per node, K2 masked/global) at Q=8 queries, 4 nodes
   x 400 slots x 512 dims, k=8, with a random case, an exact-tie case
   (slot ids equal) and an empty node, and the masked fill (a node with
   fewer valid rows than k, node ids outside [0, 4); Q = 1, 8, and 17
   with k = 32; slot ids equal); the single-slab scan (K3) at q (8, 512),
   db (400, 512), random, exact ties, every slot invalid and fewer valid
   rows than k (Q = 1, 8, 17); flash attention (K4) at
   DiT-B/2 shapes, B = 1, 2, 4, 8, with SDPA beside it; fused adaLN (K5)
   at B = 1 and 8 on the DiT's strided chunk views; GroupNorm+SiLU (K6)
   at every resblock shape of the 256 px VAE at B=8 and B=1 with its
   partition, plus the group shrink rule.  Prints error, tolerance,
   kernel / plain / library milliseconds (device, and eager per call)
   and the bound.
3. serve — ``build_system(n_nodes=4, res=256)`` over a dit-b2-width DiT
   (12 layers, 768 wide, 12 heads, patch 2, 256 tokens) and the full f8
   VAE at 256 px, random seeded weights; ``ServingEngine(max_batch=8)``
   drains the trace under score routing, then 8 more requests under
   centroid routing.
3b. latent-depth step-level serving — ``build_system(n_nodes=4,
   corpus_n=48, res=256, latent_depths=True)`` with the same backend,
   warmed with latents of a few scenes (see ``warm_latents``);
   ``ServingEngine.run`` over Poisson arrivals (50/s) of
   ``mixed_hit_trace(24, seed=3)`` at step level with 8 slots, then the
   same arrivals group-continuous on a fresh, identical system.
3c. standalone fleet — the serve phase's fleet reassembled without a
   cluster index (``use_cluster_index=False``): 8 requests, every
   Retrieve through K3.
3d. faults — ``build_system(n_nodes=4, res=256)`` with a journal per
   node and the ``chaos`` preset under a ``FaultInjector``;
   ``ServingEngine.run`` group-continuous over 24 bursty requests: zero
   loss; a crash, a journaled rejoin, corrupt, transient, stall and
   unstall events fired; the replayed db equals the crashed node's cache
   at the crash, bitwise; afterwards the card's cluster scan equals a
   CPU index's.  Then the interrupted run: half a trace, a crash of the
   busiest node, replay, rejoin, the rest, against an uninterrupted twin
   (routes, nodes, steps and db snapshots equal, images within
   ``IMAGE_REL_TOL``).  Prints the journal replay's and the rejoin's
   host ms.
3e. front door — a ``Gateway`` (FIFO, a ``FileResultStore``) over a
   fresh fleet; 3 tenants submit 24 jobs before ``start``; the worker
   thread's images equal a direct ``ServingEngine.run`` of the merged
   trace on an identical fleet (routes and nodes equal, images within
   ``IMAGE_REL_TOL``, bitwise reported); per-tenant p50/p95 and the Jain
   index.
3f. mesh scans — the cluster scans' inputs (4 nodes x 400 x 512,
   integer-valued) split over a node mesh of 2 and of 3 shards (4 nodes
   pad to 6: the third shard holds pad nodes only) on this card: each
   shard's K1 and K2 (node-masked, with shard-local node ids, and
   global) against the plain versions, slot ids equal; the host-merged
   lists against one device's K1/K2, slots and scores equal; the K1 scan
   wall of the mesh against one device.  Where the process sees two
   cards or more, the same with one shard per card.
3g. mesh serve — ``build_system(n_nodes=4, res=256, mesh_nodes=3)``
   with its three shards on this card serves the serve drive's 16
   requests (score, then centroid routing): routes, nodes, images and
   cache state equal the serve drive's, bitwise, and a mesh-1 twin's
   (a copy of the fleet as built).  Then on both, node 3 crashes and
   rejoins from its journal and a fifth node joins (5 nodes padded to 6,
   new shard boundaries); 8 more requests; mesh and twin equal bitwise.
   K1/K2 launch once per shard per micro-batch.  Prints the gathered
   list bytes, the slab bytes on the card against mesh 1, the memory
   allocated and the drive walls beside the twin's.
   Launch counts are zeroed right before each drive of 3-3e and 3g and
   read right after (and printed per shape for 3d-3e); a kernel of a
   drive's path with no launch fails.  The per-shape counts of those
   drives are then timed shape by shape and ranked by launches x
   (device - bound).
4. check — K1 against its plain version at every shape the drives ran
   and at each query tile (exact ties: slot ids equal); one K6 call, and
   one call of K1, K2 (both modes) and K3 at every shape the drives ran,
   is one kernel (its CUDA graph has one node);
   outputs are finite images of the right shape; the cluster
   scans and the standalone scans agree with CPU copies of the fleet;
   step level and group-continuous agree on routes, nodes, steps and
   cache state, images within a stated tolerance; the DiT and the VAE
   with their kernels agree with their plain versions on the card at
   full size and with the CPU at a small size.
5. flux — flux-dev (``src/repro/configs/flux_dev.py``) at full width and
   depth (19 double + 38 single blocks, d_model 3072, 24 heads of 128,
   ≈11.9 B parameters) built on the card in bf16 from a seeded CUDA
   generator, its zero-initialised layers perturbed: the gen_fast
   ``rf_edit`` generation (B=16, 512 px: the port's tokenizer and text
   encoder give ``txt``/``vec``, the full VAE encodes 16 reference
   images, 4 Euler steps at strength 0.6, a decode), then one step of
   the gen_1024 program (B=4, 4096 + 256 tokens) on the same weights
   with ``img_pos`` swapped; walls, ms per step, launches per kernel and
   shape (K4 bf16 57 a forward), peak memory.  The full-depth velocity
   must be finite (its difference from the plain path printed); a 2 + 2
   block MMDiT at full width holds its kernel path to its plain path
   within 2e-2 of scale, a small MMDiT (head dim 128, f32) the card to
   the CPU; K6 against its plain version at every shape the phase
   launched; K4 at bf16 at gen_fast's, gen_1024's and a head-dim-64
   shape against its plain version (2e-2) and the f32 plain version,
   with device, call, plain and SDPA ms and the bound.
   It runs after the mesh drives and before the per-shape timing and
   ranking of phase 4, which then include its shapes; its launch
   counts join the kernel line's.

The last two lines of standard output are one JSON object per kernel
(``{"kernels": [...]}``) and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM published peaks (data sheet; dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

# kernel tolerances (f32 vs f32, TF32 off): a kernel sums in another
# order than the plain version — dot products of 512 (scan) or 64
# (attention) terms and 768-wide row statistics (adaLN)
KERNEL_TOL = 2e-5
# the whole DiT (12 blocks, kernels vs plain): per-block rounding
# differences compound through the residual stream; relative to the
# output's largest magnitude
DIT_REL_TOL = 1e-4
# a VAE pass (kernels vs plain, or card vs CPU): per-resblock rounding of
# the statistics and the convolutions, relative to the output's scale
VAE_REL_TOL = 1e-4
# step-level vs group-continuous images: the DiT runs at batch 8 (slots)
# against batches of 1-8 (groups), and a GEMM picks its algorithm by batch
# size, so sums round differently through up to 30 DDIM steps and a VAE
# decode; relative to the image's largest magnitude
IMAGE_REL_TOL = 1e-3
# scenes warmed with archived latents before the latent-depth drive
LATENT_WARM_SCENES = 6
# the faults phase: the chaos preset scaled to this many group boundaries,
# over a bursty trace of CHAOS_REQUESTS (one group per burst of 2); the
# interrupted run serves INTERRUPTED_REQUESTS twice over fleets of
# TWIN_CORPUS corpus images
CHAOS_GROUPS = 10
CHAOS_REQUESTS = 24
INTERRUPTED_REQUESTS = 16
TWIN_CORPUS = 200
# the front-door phase: jobs, split evenly across tenants
FRONTDOOR_REQUESTS = 24
FRONTDOOR_TENANTS = 3

# dit-b2 at 256 px (src/repro/configs/dit_b2.py) over the full f8 VAE
# (FULL_VAE in src/repro/configs/diffusion_common.py)
DIT_B2 = dict(img_res=32, in_ch=4, patch=2, n_layers=12, d_model=768,
              n_heads=12, ctx_dim=512)
FULL_VAE = dict(in_ch=3, base_ch=128, ch_mult=(1, 2, 4), z_ch=4, n_res=2)
SERVE_RES = 256          # corpus and generated images, px
# (H = W, C) of the full VAE's resblocks at 256 px: encode, then decode
VAE_RESBLOCK_SHAPES = ((128, 128), (64, 256), (32, 512),
                       (64, 512), (128, 256), (256, 128))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(build_log: str):
    """(kernel, 'N registers, S smem, spills') per entry function of a
    ``-Xptxas -v`` log, names demangled where ``c++filt`` exists."""
    import re
    import shutil
    out, name = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), ""
        elif "spill stores" in line and name:
            spill = line.strip()
        elif "Used" in line and name:
            out.append([name, line.split(":", 1)[1].strip() + "; " + spill])
            name = None
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(n for n, _ in out),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        for row, dem in zip(out, names):
            row[0] = re.sub(r"\(.*", "", dem.replace(
                "(anonymous namespace)::", ""))
    return out


def tensor_core_check(build) -> str:
    """Count K4's tensor-core instructions (HMMA) in its SASS with
    ``cuobjdump``; fails if the kernel has none."""
    import os
    import shutil
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "cuobjdump"
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        return "flash_attention SASS: not checked (no cuobjdump)"
    sass = subprocess.run([tool, "-sass", str(build._target(
        "flash_attention"))], capture_output=True, text=True, check=True,
        timeout=120).stdout.splitlines()
    hmma = [ln for ln in sass if "HMMA" in ln]
    if not hmma:
        raise AssertionError("flash_attention has no HMMA instruction")
    kind = sorted({ln.split()[1] for ln in hmma if len(ln.split()) > 1})
    return (f"flash_attention SASS: {len(hmma)} tensor-core instructions "
            f"({', '.join(kind)})")


def call_ms(fn, iters: int = 50, runs: int = 5) -> float:
    """Time per call as the caller sees it: ``iters`` back-to-back eager
    calls between two CUDA events, so host launch cost counts wherever
    it exceeds the device time (inputs stay warm in L2); the best of
    ``runs`` such runs, the one least disturbed by the host's other
    load."""
    import torch
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


def device_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    the graph replayed ``replays`` times between two CUDA events — no
    host launch cost in the measurement (inputs stay warm in L2)."""
    import torch
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


def timed(row: dict, kernel, plain, library=None) -> dict:
    """Device and per-call times of a kernel, its plain version and the
    library call into ``row``."""
    row.update(ms=device_ms(kernel), plain_ms=device_ms(plain),
               library_ms=None if library is None else device_ms(library),
               call_ms=call_ms(kernel), plain_call_ms=call_ms(plain))
    return row


def bound(bytes_moved: float, flops: float):
    t_mem = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def scan_inputs(gen, *, ties: bool, dev):
    """Q=8 queries, 2 planes x 4 nodes x 400 slots x 512 dims; node 3
    empty.  ``ties``: integer-valued vectors with repeated rows, so equal
    scores are exact in any summation order."""
    import torch
    shape = (2, 4, 400, 512)
    if ties:
        slabs = torch.randint(-1, 2, shape, generator=gen).float()
        slabs[:, 0, 200:300] = slabs[:, 0, 0:100]
        slabs[:, 1, 7] = slabs[:, 1, 399]
        q = torch.randint(-1, 2, (8, 512), generator=gen).float()
    else:
        slabs = torch.randn(shape, generator=gen)
        slabs /= slabs.norm(dim=-1, keepdim=True)
        q = torch.randn((8, 512), generator=gen)
        q /= q.norm(dim=-1, keepdim=True)
    valid = torch.rand((4, 400), generator=gen) < 0.7
    valid[3] = False
    nids = torch.tensor([0, 1, 2, 3, 0, 1, 2, 2], dtype=torch.int32)
    return [t.to(dev) for t in (q, slabs, valid, nids)]


def check_topk(name, got, want, full, offset, tol, exact: bool = False):
    """Kernel top-k vs plain top-k.  Masked candidates: ``-inf`` in the
    plain version, the ``-1e30`` sentinel in the kernel.  Slot ids must be
    equal; with ``exact`` false (inputs whose scores round differently in
    another summation order), except at a near-tie, where the slot the
    kernel chose must score within ``tol`` of the plain score at that
    rank.  ``exact`` is for integer-valued inputs, where every score and
    every tie is exact, so the order of tied slots is checked too."""
    import torch
    s_k, i_k = got
    s_p, i_p = want
    masked = torch.isneginf(s_p)
    if not bool((s_k[masked] <= -1e29).all()):
        raise AssertionError(f"{name}: masked candidate scored as a hit")
    err = float((s_k[~masked] - s_p[~masked]).abs().max()) \
        if bool((~masked).any()) else 0.0
    if err > tol:
        raise AssertionError(f"{name}: max |score err| {err} > {tol}")
    diff = i_k != i_p.to(i_k.dtype)
    if exact and bool(diff.any()):
        raise AssertionError(f"{name}: {int(diff.sum())} slot ids differ on "
                             "exact scores")
    if bool(diff.any()):
        chosen = torch.gather(full, -1, (i_k.long() - offset))
        gap = float((chosen[diff] - s_p[diff]).abs().max())
        if not gap <= tol:
            raise AssertionError(f"{name}: {int(diff.sum())} slot ids differ "
                                 f"beyond a near-tie (gap {gap})")
    return err, int(diff.sum())


def check_scans(q, slabs, valid, nids, k: int, exact: bool):
    """K1 and K2 (masked and global) against their plain versions on one
    set of inputs (``exact``: integer-valued, slot ids must be equal);
    returns {kernel: (max |score err|, near-tie swaps)}."""
    import torch

    from repro_torch.kernels import ref, vdb_topk
    dev = q.device
    n_idx, n_nodes, cap, _ = slabs.shape
    nodes = torch.arange(n_nodes, device=dev)
    scores = torch.einsum("qd,incd->inqc", q, slabs)
    out = {"vdb_topk_pernode": check_topk(
        "vdb_topk_pernode", vdb_topk.launch_pernode(q, slabs, valid, k),
        ref.vdb_topk_pernode_ref(q, slabs, valid, k),
        torch.where(valid[None, :, None, :], scores, float("-inf")),
        (nodes * cap)[None, :, None, None], KERNEL_TOL, exact)}
    flat = scores.permute(0, 2, 1, 3)                # (P, Q, N, cap)
    for mask_nodes in (True, False):
        ok = valid[None, None]
        if mask_nodes:
            ok = ok & (nids.long()[None, :, None, None]
                       == nodes[None, None, :, None])
        full = torch.where(ok, flat, float("-inf")).reshape(
            n_idx, q.shape[0], n_nodes * cap)
        name = "vdb_topk_sharded" + ("" if mask_nodes else "(global)")
        out[name] = check_topk(
            name, vdb_topk.launch_sharded(q, slabs, valid, nids, k,
                                          mask_nodes=mask_nodes),
            ref.vdb_topk_sharded_ref(q, slabs, valid, nids, k,
                                     mask_nodes=mask_nodes),
            full, 0, KERNEL_TOL, exact)
    torch.cuda.synchronize()
    return out


# (node ids, k) of the masked-fill cases over scan_inputs' fleet (node 3
# empty, node 2 cut to 3 valid rows): a query on a node with fewer than k
# valid rows, on the empty node, and on node ids outside [0, 4)
FILL_CASES = (([2], 8), ([2, 3, 4, -1, 0, 2, 1, 3], 8),
              ([(j % 7) - 1 for j in range(17)], 32))


def check_fill_rule(gen, dev) -> dict:
    """K1 and K2 (both modes) on integer-valued inputs whose lists run out
    of real candidates, at Q = 1, 8 and 17 (two query tiles, k = 32):
    slot ids equal the plain version's, masked fill and out-of-range node
    ids included."""
    import torch
    out = {}
    for ids, k in FILL_CASES:
        q, slabs, valid, _ = scan_inputs(gen, ties=True, dev=dev)
        valid[2] = False
        valid[2, torch.tensor([5, 200, 399])] = True
        q = torch.randint(-1, 2, (len(ids), q.shape[1]),
                          generator=gen).float().to(dev)
        nids = torch.tensor(ids, dtype=torch.int32, device=dev)
        res = check_scans(q, slabs, valid, nids, k, exact=True)
        out[f"Q={len(ids)} k={k}"] = res
        log(f"[kernels] vdb_topk fill rule Q={len(ids)} k={k} (node ids "
            f"{ids}; node 2 has 3 valid rows, node 3 none): slot ids equal; "
            + ", ".join(f"{n} err {e:.2e}" for n, (e, _) in res.items()))
    return out


def run_kernel_checks(dev):
    import torch

    from repro_torch.kernels import ref, vdb_topk

    gen = torch.Generator().manual_seed(0)
    rows = []
    k = 8
    tie = check_scans(*scan_inputs(gen, ties=True, dev=dev), k, exact=True)
    q, slabs, valid, nids = scan_inputs(gen, ties=False, dev=dev)
    rnd = check_scans(q, slabs, valid, nids, k, exact=False)
    for case, res in (("exact ties", tie), ("random", rnd)):
        log(f"[kernels] vdb_topk {case} (node 3 empty; slot ids "
            + ("equal" if res is tie else "equal but at near-ties") + "): "
            + ", ".join(f"{n} err {e:.2e} ({d} near-tie swaps)"
                        for n, (e, d) in res.items())
            + f"; tol {KERNEL_TOL}")
    fill = check_fill_rule(gen, dev)
    n_idx, n_nodes, cap, d = slabs.shape
    qn = q.shape[0]
    log(f"[kernels] vdb_topk_pernode plan at Q={qn}: "
        f"{vdb_topk.pernode_plan(qn, cap, d)}")
    flops = 2.0 * qn * n_idx * n_nodes * cap * d
    base = q.numel() * 4 + slabs.numel() * 4 + valid.numel()
    b1 = bound(base + n_idx * n_nodes * qn * k * 8, flops)
    b2 = bound(base + qn * 4 + n_idx * qn * k * 8, flops)
    shape = f"q ({qn}, {d}), slabs {tuple(slabs.shape)}, k {k}"
    rows.append(timed(dict(
        name="vdb_topk_pernode", route="cuda",
        source="src/repro_torch/kernels/csrc/vdb_topk.cu",
        replaces="src/repro/kernels/vdb_topk.py:277",
        max_abs_err=max(rnd["vdb_topk_pernode"][0],
                        tie["vdb_topk_pernode"][0]),
        tol=KERNEL_TOL, bound_ms=b1[0], bound_by=b1[1], shape=shape),
        lambda: vdb_topk.launch_pernode(q, slabs, valid, k),
        lambda: ref.vdb_topk_pernode_ref(q, slabs, valid, k)))
    rows.append(timed(dict(
        name="vdb_topk_sharded", route="cuda",
        source="src/repro_torch/kernels/csrc/vdb_topk.cu",
        replaces="src/repro/kernels/vdb_topk.py:209",
        max_abs_err=max(e for res in [rnd, tie, *fill.values()]
                        for n, (e, _) in res.items()
                        if n != "vdb_topk_pernode"),
        tol=KERNEL_TOL, bound_ms=b2[0], bound_by=b2[1],
        shape=shape + ", node-masked"),
        lambda: vdb_topk.launch_sharded(q, slabs, valid, nids, k),
        lambda: ref.vdb_topk_sharded_ref(q, slabs, valid, nids, k)))

    rows.append(check_flash_attention(gen, dev))
    rows.append(check_adaln(gen, dev))
    rows.append(check_single_scan(gen, dev, k))
    rows.append(check_groupnorm_silu(gen, dev))
    for r in rows:
        log(f"[kernels] {r['name']:<17} device {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  library "
            + ("-" if r["library_ms"] is None else f"{r['library_ms']:.4f}")
            + f" ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']}); per "
            f"eager call {r['call_ms']:.4f} ms, plain "
            f"{r['plain_call_ms']:.4f} ms  [{r['shape']}]")
    return rows


def adaln_bound(b: int, t: int, d: int):
    """K5 bound: x read once and y written once, shift and scale read
    once; ~8 operations per element."""
    return bound((2 * b * t * d + 2 * b * d) * 4, 8.0 * b * t * d)


def check_adaln(gen, dev) -> dict:
    """K5 on x (B, 256, 768) with shift/scale as strided chunks of the
    (B, 6·768) adaLN projection, as every DiT block passes them, at B = 1
    (where most launches run) and B = 8: against the plain version, the
    same bits for an image alone and in the batch; device and eager ms.
    The row reported is B=8, with B=1 beside it."""
    import torch

    from repro_torch.kernels import adaln, ref
    t, dm = 256, 768
    x8 = (torch.randn((8, t, dm), generator=gen) * 2 + 0.5).to(dev)
    ada8 = torch.randn((8, 6 * dm), generator=gen).to(dev)
    per_batch = []
    for b in (1, 8):
        x, ada = x8[:b], ada8[:b]
        sh, sc = ada[:, :dm], ada[:, dm:2 * dm]
        got = adaln.launch(x, sh, sc)
        err = float((got - ref.adaln_modulate_ref(x, sh, sc)).abs().max())
        if err > KERNEL_TOL:
            raise AssertionError(f"adaln_modulate B={b}: err {err}")
        if not torch.equal(adaln.launch(x[-1:].contiguous(), sh[-1:],
                                        sc[-1:]), got[-1:]):
            raise AssertionError("adaln_modulate: an image alone gives "
                                 "other bits than in the batch")
        bd = adaln_bound(b, t, dm)
        per_batch.append(timed(dict(
            batch=b, max_abs_err=err, bound_ms=bd[0], bound_by=bd[1],
            warps_per_block=adaln.warps_per_block(b * t)),
            lambda: adaln.launch(x, sh, sc),
            lambda: ref.adaln_modulate_ref(x, sh, sc)))
    for r in per_batch:
        log(f"[kernels] adaln_modulate B={r['batch']} (x ({r['batch']}, {t}, "
            f"{dm}), shift/scale strided; {r['warps_per_block']} warps, a "
            f"row each, a block): err "
            f"{r['max_abs_err']:.2e}  device {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f}  bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}); eager {r['call_ms']:.4f} ms a call")
    row = dict(per_batch[-1])
    row.update(name="adaln_modulate", route="cuda",
               source="src/repro_torch/kernels/csrc/adaln.cu",
               replaces="src/repro/kernels/adaln.py:31",
               max_abs_err=max(r["max_abs_err"] for r in per_batch),
               tol=KERNEL_TOL, per_batch=per_batch,
               shape=f"x (8, {t}, {dm}), shift/scale (8, {dm}) strided")
    row["guard_us"] = guard_us(x8)
    log(f"[kernels] adaln_modulate: same bits for an image alone; tol "
        f"{KERNEL_TOL}; the launch's device guard costs "
        f"{row['guard_us']:.3f} us of host time a call (kernel wrappers "
        "launch on their tensors' card)")
    return row


def guard_us(t) -> float:
    """Host microseconds that ``_build.launch``'s device guard adds to a
    launch on the current device: the guard around a no-op against the
    no-op alone, best of 5 runs of 20000 calls each."""
    import timeit

    from repro_torch.kernels import _build

    def noop(*args):
        return 0

    def best(fn):
        return min(timeit.repeat(fn, number=20000, repeat=5)) / 20000 * 1e6
    return best(lambda: _build.launch(t, noop, 1, 2)) - best(
        lambda: noop(1, 2))


def fa_bound(b: int, sq: int, sk: int, h: int, d: int):
    """K4 bound: q, k, v read once and o written once; 4·B·H·Sq·Sk·D flops
    of products, run on the tensor cores as three TF32 products each
    (3xTF32, which keeps f32 accuracy), against the dense TF32 rate.
    Second value: the same products as f32 FMA on the CUDA cores, the
    bound of the CUDA-core kernel this one replaced, kept for reference."""
    byts = (2 * b * sq * h * d + 2 * b * sk * h * d) * 4
    flops = 4.0 * b * h * sq * sk * d
    t_mem = byts / HBM_BYTES_PER_S * 1e3
    t_tc = 3 * flops / TF32_FLOP_PER_S * 1e3
    tc = (t_mem, "bytes") if t_mem >= t_tc else (t_tc, "operations")
    return tc, bound(byts, flops)[0]


def check_flash_attention(gen, dev) -> dict:
    """K4 on q, k, v as the DiT hands them over (strided slices of one
    fused (B, T, 3, H, Dh) projection) at B = 1, 2, 4, 8: S=256, a ragged
    S=200 and causal rows against the plain version; device ms of kernel,
    plain and SDPA at each batch.  The row reported is B=8."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref
    t, h, hd = 256, 12, 64
    qkv = torch.randn((8, t, 3, h, hd), generator=gen).to(dev)
    per_batch = []
    for b in (1, 2, 4, 8):
        qq, kk, vv = qkv[:b, :, 0], qkv[:b, :, 1], qkv[:b, :, 2]
        err = 0.0
        for sq, sk, causal in ((t, t, False), (200, 200, False),
                               (100, t, True)):
            got = flash_attention.launch(qq[:, :sq], kk[:, :sk], vv[:, :sk],
                                         causal=causal)
            want = ref.flash_attention_ref(qq[:, :sq], kk[:, :sk],
                                           vv[:, :sk], causal=causal)
            e = float((got - want).abs().max())
            if e > KERNEL_TOL:
                raise AssertionError(f"flash_attention B={b} Sq={sq} Sk={sk}"
                                     f" causal={causal}: err {e}")
            err = max(err, e)
        (bd, by), bd_f32 = fa_bound(b, t, t, h, hd)
        qt, kt, vt = (x.transpose(1, 2) for x in (qq, kk, vv))
        per_batch.append(timed(dict(
            batch=b, max_abs_err=err, bound_ms=bd, bound_by=by,
            bound_f32_ms=bd_f32,
            layout=flash_attention.layout(b, h, t, t, hd)),
            lambda: flash_attention.launch(qq, kk, vv),
            lambda: ref.flash_attention_ref(qq, kk, vv),
            lambda: F.scaled_dot_product_attention(qt, kt, vt)))
    for r in per_batch:
        lay = r["layout"]
        log(f"[kernels] flash_attention B={r['batch']} (q/k/v ({r['batch']}, "
            f"{t}, {h}, {hd}) strided; {lay['row_groups']} x "
            f"{lay['key_slots']} warps a block): err {r['max_abs_err']:.2e}"
            f"  device {r['ms']:.4f} ms  plain {r['plain_ms']:.4f}  SDPA "
            f"{r['library_ms']:.4f}  bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}, 3xTF32; f32 FMA {r['bound_f32_ms']:.4f})")
    row = dict(per_batch[-1])
    row.update(name="flash_attention", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:82",
               max_abs_err=max(r["max_abs_err"] for r in per_batch),
               tol=KERNEL_TOL, per_batch=per_batch,
               shape=f"q/k/v (8, {t}, {h}, {hd}) strided")
    log(f"[kernels] flash_attention: every batch also at S=200 and causal; "
        f"tol {KERNEL_TOL}")
    return row


def single_scan_inputs(gen, case: str, dev, qn: int = 8):
    """K3 at a standalone node's size: q (qn, 512), db (400, 512).
    ``ties``: integer rows, rows 200-299 repeating rows 0-99; ``empty``:
    every slot invalid (a node that just joined); ``short``: integer rows,
    3 valid (fewer than k, so the list ends in masked rows)."""
    import torch
    if case in ("ties", "short"):
        db = torch.randint(-1, 2, (400, 512), generator=gen).float()
        db[200:300] = db[0:100]
        q = torch.randint(-1, 2, (qn, 512), generator=gen).float()
    else:
        db = torch.randn((400, 512), generator=gen)
        db /= db.norm(dim=-1, keepdim=True)
        q = torch.randn((qn, 512), generator=gen)
        q /= q.norm(dim=-1, keepdim=True)
    valid = torch.rand((400,), generator=gen) < 0.7
    if case == "empty":
        valid[:] = False
    if case == "short":
        valid[:] = False
        valid[torch.tensor([7, 250, 398])] = True
    return [t.to(dev) for t in (q, db, valid)]


def check_single_scan(gen, dev, k: int) -> dict:
    """K3 against its plain version: exact ties, an empty db, fewer valid
    rows than k (at Q = 1, 8 and 17 with k = 32: two query tiles), slot
    ids equal; random unit vectors, which it times."""
    import torch

    from repro_torch.kernels import ref, vdb_topk
    errs = {}
    for case, qn, kk in (("ties", 8, k), ("empty", 8, k), ("short", 1, k),
                         ("short", 8, k), ("short", 17, 32),
                         ("random", 8, k)):
        q, db, valid = single_scan_inputs(gen, case, dev, qn)
        full = torch.where(valid[None], q @ db.T, float("-inf"))
        name = case if case != "short" else f"short Q={qn} k={kk}"
        errs[name] = check_topk(f"vdb_topk {name}",
                                vdb_topk.launch_single(q, db, valid, kk),
                                ref.vdb_topk_ref(q, db, valid, kk), full, 0,
                                KERNEL_TOL, exact=case != "random")
    torch.cuda.synchronize()
    log("[kernels] vdb_topk (single slab) " + ", ".join(
        f"{c} err {e:.2e} ({d} near-tie swaps)" for c, (e, d) in errs.items())
        + f"; tol {KERNEL_TOL}")
    qn, d = q.shape
    b3 = bound(q.numel() * 4 + db.numel() * 4 + valid.numel() + qn * k * 8,
               2.0 * qn * db.shape[0] * d)
    return timed(dict(
        name="vdb_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/vdb_topk.cu",
        replaces="src/repro/kernels/vdb_topk.py:120",
        max_abs_err=max(e for e, _ in errs.values()), tol=KERNEL_TOL,
        bound_ms=b3[0], bound_by=b3[1],
        shape=f"q ({qn}, {d}), db {tuple(db.shape)}, k {k}, one index"),
        lambda: vdb_topk.launch_single(q, db, valid, k),
        lambda: ref.vdb_topk_ref(q, db, valid, k))


def kernels_per_call(fn) -> int:
    """Kernels one call of ``fn`` puts on the card: the call captured into a
    CUDA graph, whose nodes ``cuGraphGetNodes`` counts."""
    import ctypes

    import torch
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):     # set-up (attributes, a stream's
        fn()                          # ticket counters) outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        fn()
    libcuda = ctypes.CDLL("libcuda.so.1")
    libcuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_size_t)]
    n = ctypes.c_size_t(0)
    if libcuda.cuGraphGetNodes(graph.raw_cuda_graph(), None,
                               ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    return n.value


def pernode_inputs(gen, shape, *, ties: bool, dev):
    """K1/K2 inputs at a ``LAUNCHES_BY_SHAPE`` key (Q, P, N, cap, D, k),
    the last node empty.  ``ties``: integer-valued vectors, the second half of
    each node's rows repeating the first, so exact ties straddle the
    blocks of a cluster; else unit vectors."""
    import torch
    qn, n_idx, n_nodes, cap, d, _ = shape
    if ties:
        slabs = torch.randint(-1, 2, (n_idx, n_nodes, cap, d),
                              generator=gen).float()
        slabs[:, :, cap // 2:] = slabs[:, :, :cap - cap // 2]
        q = torch.randint(-1, 2, (qn, d), generator=gen).float()
    else:
        slabs = torch.randn((n_idx, n_nodes, cap, d), generator=gen)
        slabs /= slabs.norm(dim=-1, keepdim=True)
        q = torch.randn((qn, d), generator=gen)
        q /= q.norm(dim=-1, keepdim=True)
    valid = torch.rand((n_nodes, cap), generator=gen) < 0.7
    valid[-1] = False
    return [t.to(dev) for t in (q, slabs, valid)]


# query counts that give each query tile of the clustered scan (1, 2, 4,
# 8, 16) and two tiles
TILE_QS = (1, 2, 3, 4, 8, 16, 17)


def fill_node_ids(qn: int, n_nodes: int, dev):
    """Node ids cycling through the empty last node, node 0, ids outside
    [0, N) and the other nodes: lists that end in the masked fill."""
    import torch
    order = [n_nodes - 1, 0, n_nodes, -1, *range(1, n_nodes - 1)]
    return torch.tensor([order[j % len(order)] for j in range(qn)],
                        dtype=torch.int32, device=dev)


def check_scan_shapes(dev) -> dict:
    """K1, K2 (node-masked and global) and K3 against their plain versions
    at every shape the main-path drives launched them, and at each query
    tile (Q in ``TILE_QS``) at the serving fleet's slab (K1, K2) and at a
    standalone node's db (K3): exact ties that straddle the blocks of a
    cluster (slot ids equal; K2's node ids name the empty last node and
    ids outside [0, N), so lists end in the masked fill) and unit vectors
    (equal but at near-ties), scores within the tolerance."""
    import torch

    from repro_torch.kernels import ref, vdb_topk
    gen = torch.Generator().manual_seed(13)
    out = {}

    def record(kind, shape, drives, tile, res):
        err = max(e for r in res for e, _ in r.values())
        swaps = sum(d for _, d in res[1].values())
        out[(kind, shape)] = dict(drives=drives, tile=tile, err=err,
                                  near_tie_swaps=swaps)
        log(f"[check] {', '.join(res[0])} at {shape} ("
            + (f"drive shape of {', '.join(drives)}" if drives
               else "tile check") + f", query tile {tile}): exact ties "
            f"slot ids equal, unit vectors {swaps} near-tie swaps; err "
            f"{err:.2e} (tol {KERNEL_TOL})")

    names = ("vdb_topk_pernode", "vdb_topk_sharded")
    tiles = {(qn, 2, 4, 400, 512, 8) for qn in TILE_QS}
    for shape in sorted(set().union(*(SHAPES.get(n, {}) for n in names))
                        | tiles):
        qn, _, n_nodes, cap, d, k = shape
        res = []
        for ties in (True, False):
            q, slabs, valid = pernode_inputs(gen, shape, ties=ties, dev=dev)
            nids = fill_node_ids(qn, n_nodes, dev) if ties else \
                torch.randint(0, n_nodes, (qn,), generator=gen,
                              dtype=torch.int32).to(dev)
            res.append(check_scans(q, slabs, valid, nids, k, exact=ties))
        record("vdb_topk_pernode/sharded", shape,
               [n for n in names if shape in SHAPES.get(n, {})],
               vdb_topk.pernode_plan(qn, cap, d)["query_tile"], res)
    tiles = {(qn, 400, 512, 8) for qn in TILE_QS}
    for shape in sorted(set(SHAPES.get("vdb_topk", {})) | tiles):
        qn, n, d, k = shape
        res = []
        for ties in (True, False):
            q, slabs, valid = pernode_inputs(gen, (qn, 1, 2, n, d, k),
                                             ties=ties, dev=dev)
            db, ok = slabs[0, 0], valid[0]
            res.append({"vdb_topk": check_topk(
                f"vdb_topk at {shape} ties={ties}",
                vdb_topk.launch_single(q, db, ok, k),
                ref.vdb_topk_ref(q, db, ok, k),
                torch.where(ok[None], q @ db.T, float("-inf")), 0,
                KERNEL_TOL, exact=ties)})
        record("vdb_topk", shape,
               ["vdb_topk"] if shape in SHAPES.get("vdb_topk", {}) else [],
               vdb_topk.single_plan(qn, n, d)["query_tile"], res)
    torch.cuda.synchronize()
    return out


def one_launch_per_call(dev) -> dict:
    """One K6 call at each B=1 resblock shape, and one call of K1, of K2
    (node-masked and global) and of K3 at every shape the main-path drives
    launched it, must be exactly one kernel (no statistics, merge or
    scratch launches)."""
    import torch

    from repro_torch.kernels import groupnorm_silu, vdb_topk
    for hw, c in VAE_RESBLOCK_SHAPES:
        x = torch.randn((1, hw, hw, c), device=dev)
        one = torch.ones((c,), device=dev)
        n = kernels_per_call(lambda: groupnorm_silu.launch(x, one, one))
        if n != 1:
            raise AssertionError(f"groupnorm_silu {tuple(x.shape)} ran {n} "
                                 "kernels")
    gen = torch.Generator().manual_seed(12)
    k1 = sorted(SHAPES.get("vdb_topk_pernode", {}))
    for shape in k1:
        q, slabs, valid = pernode_inputs(gen, shape, ties=False, dev=dev)
        k = shape[-1]
        n = kernels_per_call(
            lambda: vdb_topk.launch_pernode(q, slabs, valid, k))
        if n != 1:
            raise AssertionError(f"vdb_topk_pernode at {shape} ran {n} "
                                 "kernels")
    k2 = sorted(SHAPES.get("vdb_topk_sharded", {}))
    for shape in k2:
        q, slabs, valid = pernode_inputs(gen, shape, ties=False, dev=dev)
        k = shape[-1]
        nids = torch.randint(0, shape[2], (shape[0],), generator=gen,
                             dtype=torch.int32).to(dev)
        for mask in (True, False):
            n = kernels_per_call(lambda: vdb_topk.launch_sharded(
                q, slabs, valid, nids, k, mask_nodes=mask))
            if n != 1:
                raise AssertionError(f"vdb_topk_sharded (mask_nodes={mask})"
                                     f" at {shape} ran {n} kernels")
    k3 = sorted(SHAPES.get("vdb_topk", {}))
    for qn, n_rows, d, k in k3:
        q = torch.randn((qn, d), generator=gen).to(dev)
        db = torch.randn((n_rows, d), generator=gen).to(dev)
        valid = (torch.rand((n_rows,), generator=gen) < 0.7).to(dev)
        n = kernels_per_call(lambda: vdb_topk.launch_single(q, db, valid, k))
        if n != 1:
            raise AssertionError(f"vdb_topk at {(qn, n_rows, d, k)} ran {n} "
                                 "kernels")
    return dict(groupnorm_silu=len(VAE_RESBLOCK_SHAPES),
                vdb_topk_pernode=len(k1), vdb_topk_sharded=len(k2),
                vdb_topk=len(k3))


def gn_bound(x):
    """K6 bound: one read and one write of x; ~10 operations per element
    (statistics, normalise, affine, SiLU)."""
    return bound(2 * x.numel() * 4 + 2 * x.shape[-1] * 4, 10.0 * x.numel())


def check_groupnorm_silu(gen, dev) -> dict:
    """K6 at every resblock shape of the 256 px VAE (three per encode,
    three per decode), at B=8 and B=1, plus the shrink rule (C=48: 24
    groups) and groups=8.  Every case against the plain version; device
    ms of kernel, plain and the library yardstick at each resblock shape.
    The row reported is the largest, (8, 256, 256, 128)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import groupnorm_silu, ref
    per_shape = []
    row = None
    for b in (8, 1):
        for hw, c in VAE_RESBLOCK_SHAPES:
            x = (torch.randn((b, hw, hw, c), generator=gen) * 2 + 0.5).to(dev)
            sc = (torch.randn((c,), generator=gen) * 0.3 + 1).to(dev)
            bi = (torch.randn((c,), generator=gen) * 0.3).to(dev)
            got = groupnorm_silu.launch(x, sc, bi)
            err = float((got - ref.groupnorm_silu_ref(x, sc, bi))
                        .abs().max())
            if err > KERNEL_TOL:
                raise AssertionError(f"groupnorm_silu {tuple(x.shape)}: "
                                     f"err {err}")
            g = groupnorm_silu.num_groups(c, 32)
            xc = x.permute(0, 3, 1, 2)      # the NCHW view, channels last
            bd = gn_bound(x)
            r = timed(dict(shape=tuple(x.shape), max_abs_err=err,
                           bound_ms=bd[0], bound_by=bd[1],
                           plan=groupnorm_silu.plan(hw * hw, c)),
                      lambda: groupnorm_silu.launch(x, sc, bi),
                      lambda: ref.groupnorm_silu_ref(x, sc, bi),
                      lambda: F.silu(F.group_norm(xc, g, sc, bi, 1e-5)))
            per_shape.append(r)
            if row is None or x.numel() > math.prod(row["shape"]):
                row = r
                again = groupnorm_silu.launch(x, sc, bi)
                alone = groupnorm_silu.launch(x[-1:].contiguous(), sc, bi)
                if not (torch.equal(again, got)
                        and torch.equal(alone, got[-1:])):
                    raise AssertionError("groupnorm_silu: bits differ "
                                         "between runs or batch sizes")
            del x, got, xc
    for shape, groups in (((1, 32, 32, 48), 32), ((2, 64, 64, 64), 8)):
        x = torch.randn(shape, generator=gen).to(dev)
        sc = torch.randn((shape[-1],), generator=gen).to(dev)
        bi = torch.randn((shape[-1],), generator=gen).to(dev)
        err = float((groupnorm_silu.launch(x, sc, bi, groups=groups)
                     - ref.groupnorm_silu_ref(x, sc, bi, groups=groups))
                    .abs().max())
        if err > KERNEL_TOL:
            raise AssertionError(f"groupnorm_silu {shape} groups={groups}: "
                                 f"err {err}")
        per_shape.append(dict(shape=shape, groups=groups, max_abs_err=err))
    torch.cuda.synchronize()
    for r in per_shape:
        p = r.get("plan")
        log(f"[kernels] groupnorm_silu {str(r['shape']):<22} err "
            f"{r['max_abs_err']:.2e}" + ("" if "ms" not in r else
            f"  device {r['ms']:.4f} ms  plain {r['plain_ms']:.4f}  "
            f"library(F.group_norm+F.silu) {r['library_ms']:.4f}  bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}); eager "
            f"{r['call_ms']:.4f} / {r['plain_call_ms']:.4f}; "
            f"{p['slices']} slices x {p['cluster_blocks']} blocks of "
            f"{p['threads']} threads, {p['thread_pixels_on_chip']}/"
            f"{p['thread_pixels']} of a thread's pixels on chip, "
            f"{p['smem_bytes']} B shared, {p['max_clusters']} clusters "
            f"fit at once"))
    log("[kernels] groupnorm_silu: same bits on a second run and for an "
        f"image alone; tol {KERNEL_TOL}")
    row.update(name="groupnorm_silu", route="cuda",
               source="src/repro_torch/kernels/csrc/groupnorm_silu.cu",
               replaces="src/repro/kernels/groupnorm_silu.py:36",
               max_abs_err=max(r["max_abs_err"] for r in per_shape),
               tol=KERNEL_TOL, per_shape=[dict(r) for r in per_shape],
               shape=f"{row['shape']} NHWC, "
               f"{groupnorm_silu.num_groups(row['shape'][-1], 32)} groups")
    return row


def shape_case(name: str, shape: tuple, gen, dev):
    """(kernel call, bound ms) of ``name`` at a shape key of
    ``kernels.LAUNCHES_BY_SHAPE``, on random inputs drawn on the card
    from ``gen`` (a generator of that card)."""
    import torch

    from repro_torch.kernels import adaln, flash_attention, groupnorm_silu
    from repro_torch.kernels import vdb_topk

    def rnd(*sz, dtype=torch.float32):
        return torch.randn(sz, generator=gen, device=dev, dtype=dtype)
    if name in ("vdb_topk_pernode", "vdb_topk_sharded"):
        qn, n_idx, n_nodes, cap, d, k = shape
        q, slabs = rnd(qn, d), rnd(n_idx, n_nodes, cap, d)
        valid = torch.rand((n_nodes, cap), generator=gen, device=dev) < 0.7
        nids = torch.randint(0, n_nodes, (qn,), generator=gen, device=dev,
                             dtype=torch.int32)
        base = (q.numel() + slabs.numel()) * 4 + valid.numel()
        flops = 2.0 * qn * n_idx * n_nodes * cap * d
        if name == "vdb_topk_pernode":
            return (lambda: vdb_topk.launch_pernode(q, slabs, valid, k),
                    bound(base + n_idx * n_nodes * qn * k * 8, flops)[0])
        return (lambda: vdb_topk.launch_sharded(q, slabs, valid, nids, k),
                bound(base + qn * 4 + n_idx * qn * k * 8, flops)[0])
    if name == "vdb_topk":
        qn, n, d, k = shape
        q, db = rnd(qn, d), rnd(n, d)
        valid = torch.rand((n,), generator=gen, device=dev) < 0.7
        return (lambda: vdb_topk.launch_single(q, db, valid, k),
                bound((q.numel() + db.numel()) * 4 + n + qn * k * 8,
                      2.0 * qn * n * d)[0])
    if name == "flash_attention":
        b, sq, sk, h, d, causal = shape
        q, k, v = rnd(b, sq, h, d), rnd(b, sk, h, d), rnd(b, sk, h, d)
        return (lambda: flash_attention.launch(q, k, v, causal=bool(causal)),
                fa_bound(b, sq, sk, h, d)[0][0])
    if name == "flash_attention_bf16":
        b, sq, sk, h, d, causal = shape
        q = rnd(b, sq, h, d, dtype=torch.bfloat16)
        k, v = (rnd(b, sk, h, d, dtype=torch.bfloat16) for _ in range(2))
        return (lambda: flash_attention.launch(q, k, v, causal=bool(causal)),
                fa_bf16_bound(b, sq, sk, h, d)[0])
    if name == "adaln_modulate":
        b, t, d = shape
        x, ada = rnd(b, t, d), rnd(b, 6 * d)
        return (lambda: adaln.launch(x, ada[:, :d], ada[:, d:2 * d]),
                adaln_bound(b, t, d)[0])
    if name == "groupnorm_silu":
        x, sc, bi = rnd(*shape), rnd(shape[-1]), rnd(shape[-1])
        return (lambda: groupnorm_silu.launch(x, sc, bi), gn_bound(x)[0])
    raise ValueError(name)


def rank_by_shape(dev) -> list:
    """Every kernel at every shape the main-path drives launched it
    (``SHAPES``), timed on the card; the redesign ranking is launches x
    (device - bound), summed over a kernel's shapes."""
    import torch
    gen = torch.Generator(dev).manual_seed(11)
    ranking = []
    for name in sorted(SHAPES):
        per = []
        for shape, n in sorted(SHAPES[name].items(), key=lambda kv: -kv[1]):
            fn, bd = shape_case(name, shape, gen, dev)
            # a graph of 20 calls keeps 20 outputs: fewer for large ones
            ms = device_ms(fn) if bd < 0.1 else device_ms(fn, reps=4,
                                                          replays=5)
            per.append(dict(shape=list(shape), launches=n, ms=ms, bound_ms=bd))
            log(f"[launches] {name} {shape} x {n}: device {ms:.4f} ms, "
                f"bound {bd:.4f} ms")
        ranking.append(dict(
            name=name, launches=sum(r["launches"] for r in per),
            over_bound_ms=sum(r["launches"] * (r["ms"] - r["bound_ms"])
                              for r in per),
            device_ms=sum(r["launches"] * r["ms"] for r in per),
            per_shape=per))
    ranking.sort(key=lambda r: -r["over_bound_ms"])
    for i, r in enumerate(ranking, 1):
        log(f"[rank] {i} {r['name']}: {r['launches']} launches over "
            f"{len(r['per_shape'])} shapes; x (device - bound) "
            f"{r['over_bound_ms']:.1f} ms, x device {r['device_ms']:.1f} ms")
    return ranking


# ---------------------------------------------------------------------------
# phase 3/4: the serving path
# ---------------------------------------------------------------------------


def make_models(dev):
    import torch

    from repro_torch.models.diffusion.dit import (DiT, DiTConfig,
                                                  perturb_zero_init_)
    from repro_torch.models.diffusion.vae import VAE, VAEConfig
    gen = torch.Generator().manual_seed(0)
    dit = DiT(DiTConfig(**DIT_B2), generator=gen)
    perturb_zero_init_(dit, gen)
    vae = VAE(VAEConfig(**FULL_VAE),
              generator=torch.Generator().manual_seed(1))
    return dit.to(dev).eval(), vae.to(dev).eval()


# kernel -> Counter(shape -> launches) over the main-path drives
SHAPES: dict = {}


def add_shapes() -> None:
    from collections import Counter

    from repro_torch import kernels
    for name, c in kernels.LAUNCHES_BY_SHAPE.items():
        SHAPES.setdefault(name, Counter()).update(c)


def drive(engine, prompts, first_seed: int, count_shapes: bool = True):
    """One run of the main path: counts zeroed just before, read just
    after (and, unless ``count_shapes`` is false, added to ``SHAPES``)."""
    import torch

    from repro_torch import kernels
    n0 = len(engine.system.stats.batch_wall_latencies)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for i, (p, tier) in enumerate(prompts):
        engine.submit(p, seed=first_seed + i, quality_tier=tier)
    done = engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    if count_shapes:
        add_shapes()
    walls = engine.system.stats.batch_wall_latencies[n0:]
    return done, counts, wall, walls


def stage_p50_ms(done) -> dict:
    """Median per-stage wall (ms) over a drive's requests."""
    import numpy as np
    walls = {}
    for c in done:
        for name, w in c.result.stage_walls.items():
            walls.setdefault(name, []).append(w)
    return {k: float(np.median(v)) * 1e3 for k, v in walls.items()}


def profile_drive(label: str, system, run) -> dict:
    """One more drive under ``torch.profiler``: device busy time against
    wall time, and the kernels that take the device time.  ``run()``
    drives ``system`` and returns ``(done, wall_seconds)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    before = dict(system.stats.route_counts)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        done, wall = run()
    mix = {k: v - before.get(k, 0)
           for k, v in system.stats.route_counts.items()
           if v - before.get(k, 0)}
    # device-side events only (kernels, copies): an operator's device time
    # is also its kernels' time, and would count twice
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
    out = dict(wall_ms=wall * 1e3, route_mix=mix,
               stage_p50_ms=stage_p50_ms(done),
               device_busy_ms=busy_us / 1e3,
               idle_share=1.0 - busy_us / 1e3 / (wall * 1e3),
               top=[dict(name=e.key[:90], count=e.count,
                         device_ms=e.self_device_time_total / 1e3)
                    for e in top])
    log(f"[profile] {label}: {len(done)} requests ({mix}): wall "
        f"{out['wall_ms']:.0f} ms, device busy {out['device_busy_ms']:.0f} "
        f"ms, idle share {out['idle_share']:.3f}; stage p50 ms "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["stage_p50_ms"].items()))
    for t in out["top"]:
        log(f"[profile]   {t['device_ms']:9.2f} ms  x{t['count']:<6} "
            f"{t['name']}")
    torch.cuda.synchronize()
    return out


def run_serve(dev, n_requests: int, profile: bool = False):
    import numpy as np
    import torch

    from repro_torch.core.embeddings import ProxyClipEmbedder
    from repro_torch.core.trace import RequestTrace
    from repro_torch.data.synthetic import render_caption
    from repro_torch.launch.serve import build_system
    from repro_torch.runtime.serving import DiffusionBackend, ServingEngine

    t0 = time.perf_counter()
    dit, vae = make_models(dev)
    emb = ProxyClipEmbedder(render_caption)
    backend = DiffusionBackend(dit, vae, lambda p: emb.embed_text([p])[0],
                               device=dev)
    system, _, _, _ = build_system(n_nodes=4, res=SERVE_RES,
                                   backend=backend, device=dev)
    engine = ServingEngine(system, max_batch=8)
    log(f"[serve] build_system(n_nodes=4, res={SERVE_RES}) + dit-b2/full-VAE "
        f"init {time.perf_counter() - t0:.1f}s; slabs "
        f"{tuple(system.cluster_index.shards[0][0].shape)}")
    reqs = [(r.prompt, r.quality_tier)
            for r in RequestTrace(seed=1).generate(n_requests + 8)]
    done, counts, wall, walls = drive(engine, reqs[:n_requests], 0)
    log(f"[serve] score routing: {len(done)} requests in {wall:.2f}s, "
        f"route mix {system.stats.route_counts}, hit rate "
        f"{system.stats.hit_rate:.3f}, per-micro-batch wall "
        + ", ".join(f"{w * 1e3:.0f}ms" for w in walls)
        + f"; launches {counts}")
    log("[serve] stage p50 ms: " + ", ".join(
        f"{k} {v:.1f}" for k, v in stage_p50_ms(done).items()))
    for name in ("vdb_topk_pernode", "flash_attention", "adaln_modulate"):
        if counts[name] == 0:
            raise AssertionError(f"score-routed drive never launched {name}")
    system.routing = "centroid"
    done2, counts2, wall2, walls2 = drive(
        engine, reqs[n_requests:n_requests + 8], n_requests)
    log(f"[serve] centroid routing: {len(done2)} requests in {wall2:.2f}s, "
        f"per-micro-batch wall "
        + ", ".join(f"{w * 1e3:.0f}ms" for w in walls2)
        + f"; launches {counts2}")
    if counts2["vdb_topk_sharded"] == 0:
        raise AssertionError("centroid-routed drive never launched "
                             "vdb_topk_sharded")
    system.routing = "score"
    # what the mesh drive (phase 3g) must give, bitwise
    record = dict(routes=[c.result.route.name for c in done + done2],
                  nodes=[c.result.node for c in done + done2],
                  images=[np.asarray(c.result.image) for c in done + done2],
                  state=cache_state(system), walls=walls + walls2)
    prof = None
    if profile:      # a fresh trace, so that the drive generates images
        fresh = [(r.prompt, r.quality_tier)
                 for r in RequestTrace(seed=2).generate(16)]
        prof = profile_drive(   # [::2] keeps (done, wall)
            "drain, score routing", system,
            lambda: drive(engine, fresh, 1000, count_shapes=False)[::2])

    res = backend.image_res
    for c in done + done2:
        img = np.asarray(c.result.image)
        if img.shape != (res, res, 3) or not np.isfinite(img).all():
            raise AssertionError(f"bad image {img.shape} for "
                                 f"{c.request.prompt!r}")
    launches = {k: counts[k] + counts2[k] for k in counts}
    summary = dict(
        requests=len(done) + len(done2), route_mix=system.stats.route_counts,
        hit_rate=system.stats.hit_rate, score_wall_s=wall,
        score_batch_walls_s=walls, centroid_wall_s=wall2,
        centroid_batch_walls_s=walls2, launches_score=counts,
        launches_centroid=counts2, stage_p50_ms=stage_p50_ms(done),
        profile=prof)
    return system, backend, launches, summary, record


def drive_run(engine, arrivals, count_shapes: bool = True, **kw):
    """One ``ServingEngine.run`` of the main path: counts zeroed just
    before, read just after (and added to ``SHAPES``)."""
    import torch

    from repro_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    done = engine.run(arrivals, **kw)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    if count_shapes:
        add_shapes()
    return done, counts, time.perf_counter() - t0


def warm_latents(system, reqs, n_scenes: int) -> None:
    """Set-up of the latent-depth drive.  Random weights generate images
    that no later prompt matches, so nothing the drive archives could be
    resumed.  Instead the fleet first archives, through the backend's own
    archive path (VAE encode and noised latents), rendered images of a
    colour-swapped variant of each of the trace's first ``n_scenes``
    scenes; then the finished images are evicted, as the LCU sweep's
    per-depth discount does under pressure, leaving their latents.  A
    request that matches such a scene resumes from a latent."""
    import numpy as np

    from repro_torch.data.synthetic import (COLORS, SceneSpec, caption_of,
                                            render_caption)
    colors = list(COLORS)
    specs = []
    for r in reqs:
        if not r.is_repeat and r.spec not in specs:
            specs.append(r.spec)
    res = system.backend.image_res
    first = len(system.blob_store)
    for j, sp in enumerate(specs[:n_scenes]):
        c = colors[(colors.index(sp.color) + 1) % len(colors)]
        prompt = caption_of(SceneSpec(sp.shape, c, sp.background, sp.size,
                                      sp.position))
        img = render_caption(prompt, res=res)
        node = int(system.classifier.assign(
            system.embedder.embed_image(img[None]))[0])
        system._archive(prompt, system.embedder.embed_text([prompt])[0],
                        img, node, t=0.0, seed=10_000 + j)
    gone = []
    for db in system.dbs:
        fin = np.flatnonzero(db.valid & (db.depth < 0)
                             & (db.payload_ids >= first))
        if len(fin):
            gone += [int(p) for p in db.evict_slots(fin)]
    for pid in gone:
        system.blob_store.delete(pid)
    system.scheduler.invalidate_payloads(gone)


def latent_system(backend, dev, reqs):
    from repro_torch.launch.serve import build_system
    system, _, _, _ = build_system(n_nodes=4, corpus_n=48, res=SERVE_RES,
                                   backend=backend, latent_depths=True,
                                   device=dev)
    warm_latents(system, reqs, LATENT_WARM_SCENES)
    return system


def cache_state(system):
    """What batching must never change: discrete cache state and stats."""
    return dict(
        valid=[db.valid.tolist() for db in system.dbs],
        payloads=[db.payload_ids.tolist() for db in system.dbs],
        depth=[db.depth.tolist() for db in system.dbs],
        source=[db.source_id.tolist() for db in system.dbs],
        blobs=len(system.blob_store), routes=dict(system.stats.route_counts),
        latent_resumes=system.stats.latent_resumes,
        total_steps=system.stats.total_steps)


def run_latent_step_level(dev, backend, profile: bool = False):
    """Phase 3b: latent-depth serving at step level, then the same
    arrivals group-continuous on a fresh, identical system; both are
    main-path drives.  ``profile`` repeats the step-level drive on a
    third identical system under the profiler."""
    import numpy as np

    from repro_torch.core.trace import mixed_hit_trace, poisson_arrivals
    from repro_torch.runtime.serving import ServingEngine
    reqs = mixed_hit_trace(24, seed=3)
    arrivals = poisson_arrivals(reqs, 50.0)
    t0 = time.perf_counter()
    s_stp = latent_system(backend, dev, reqs)
    s_grp = latent_system(backend, dev, reqs)
    log(f"[latent] two build_system(n_nodes=4, corpus_n=48, res="
        f"{SERVE_RES}, latent_depths={s_stp.latent_depths}) + "
        f"{LATENT_WARM_SCENES} warmed scenes: {time.perf_counter() - t0:.1f}s")
    eng = ServingEngine(s_stp, max_batch=8)
    d_stp, c_stp, w_stp = drive_run(eng, arrivals, step_level=True,
                                    slot_capacity=8)
    occ = eng.slot_occupancy
    log(f"[latent] step level: {len(d_stp)} requests in {w_stp:.2f}s, "
        f"{len(occ)} steps, occupancy p50 {np.percentile(occ, 50):.0f} "
        f"p95 {np.percentile(occ, 95):.0f} of 8; route mix "
        f"{s_stp.stats.route_counts}, latent resumes "
        f"{s_stp.stats.latent_resumes}, steps {s_stp.stats.total_steps}; "
        f"launches {c_stp}")
    for name in ("groupnorm_silu", "flash_attention", "adaln_modulate",
                 "vdb_topk_pernode"):
        if c_stp[name] == 0:
            raise AssertionError(f"step-level drive never launched {name}")
    if s_stp.stats.latent_resumes == 0:
        raise AssertionError("step-level drive resumed no latent")
    d_grp, c_grp, w_grp = drive_run(ServingEngine(s_grp, max_batch=8),
                                    arrivals)
    log(f"[latent] group-continuous: {len(d_grp)} requests in {w_grp:.2f}s;"
        f" launches {c_grp}")

    # what batching never changes: equal; images: within IMAGE_REL_TOL
    for a, b in zip(d_stp, d_grp):
        ra, rb = a.result, b.result
        if ((ra.fast_path, ra.route, ra.node, ra.steps, ra.resumed_from)
                != (rb.fast_path, rb.route, rb.node, rb.steps,
                    rb.resumed_from)):
            raise AssertionError(f"step level != group for "
                                 f"{a.request.prompt!r}")
    if cache_state(s_stp) != cache_state(s_grp):
        raise AssertionError("step level and group left different caches")
    rel, _ = images_rel_err([c.result.image for c in d_stp],
                            [c.result.image for c in d_grp],
                            backend.image_res)
    log(f"[check] step level == group-continuous: routes, nodes, steps, "
        f"resume depths and cache state equal; images max err {rel:.2e} of "
        f"scale (tol {IMAGE_REL_TOL})")
    prof = None
    if profile:
        s_prof = latent_system(backend, dev, reqs)
        eng = ServingEngine(s_prof, max_batch=8)
        prof = profile_drive(
            "latent-depth step level", s_prof,
            lambda: drive_run(eng, arrivals, count_shapes=False,
                              step_level=True, slot_capacity=8)[::2])
    return (c_stp, c_grp), dict(profile=prof,
        step_wall_s=w_stp, group_wall_s=w_grp, steps=len(occ),
        occupancy=occ, route_mix=s_stp.stats.route_counts,
        latent_resumes=s_stp.stats.latent_resumes,
        total_steps=s_stp.stats.total_steps, image_rel_err=rel,
        launches_step=c_stp, launches_group=c_grp)


def run_standalone(system, dev):
    """Phase 3c: the serve drive's fleet reassembled without a cluster
    index (one pgvector per node, the paper's design): every Retrieve
    scans each node's own db through K3.  Its rows must equal a CPU
    fleet's."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core.system import CacheGenius
    from repro_torch.core.trace import RequestTrace
    from repro_torch.core.vdb import VectorDB
    from repro_torch.runtime.serving import ServingEngine
    for db in system.dbs:
        db.unregister_cluster(system.cluster_index)
    fleet = CacheGenius(
        embedder=system.embedder, dbs=system.dbs,
        blob_store=system.blob_store, backend=system.backend,
        classifier=system.classifier, policy=system.policy,
        latency_model=system.latency_model, cost_model=system.cost_model,
        eviction=system.eviction,
        node_speeds=[n.speed for n in system.scheduler.nodes],
        use_cluster_index=False, device=dev)
    engine = ServingEngine(fleet, max_batch=8)
    reqs = [(r.prompt, r.quality_tier)
            for r in RequestTrace(seed=4).generate(8)]
    done, counts, wall, walls = drive(engine, reqs, 5000)
    log(f"[standalone] {len(done)} requests in {wall:.2f}s (no cluster "
        f"index, centroid routing), route mix {fleet.stats.route_counts}; "
        f"launches {counts}")
    if counts["vdb_topk"] == 0:
        raise AssertionError("standalone fleet never launched vdb_topk")
    if counts["vdb_topk_pernode"] or counts["vdb_topk_sharded"]:
        raise AssertionError("standalone fleet launched a cluster scan")
    # Retrieve rows on the card (K3) == a CPU copy of each db (plain)
    q = fleet.embedder.embed_text(
        [r.prompt for r in RequestTrace(seed=6).generate(8)])
    n0 = dict(kernels.LAUNCHES)
    for db in fleet.dbs:
        cpu = VectorDB.restore(db.dim, db.capacity, db.snapshot(),
                               device="cpu")
        for (s_g, l_g), (s_c, l_c) in zip(db.search_batch(q, fleet.topk),
                                          cpu.search_batch(q, fleet.topk)):
            if not np.array_equal(l_g, l_c) or not np.allclose(
                    s_g, s_c, rtol=0, atol=KERNEL_TOL):
                raise AssertionError("standalone card scan != CPU scan")
    torch.cuda.synchronize()
    log(f"[check] standalone Retrieve rows on the card match a CPU fleet "
        f"({dict(kernels.LAUNCHES)['vdb_topk'] - n0['vdb_topk']} K3 "
        f"launches compared)")

    # host clock per call: the per-call upload of one db's slab (both
    # indexes and the mask, from pageable host memory) against a whole
    # standalone search_batch of 8 queries
    db = fleet.dbs[0]

    def per_call_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    upload_ms = per_call_ms(lambda: [torch.from_numpy(a).to(dev) for a in (
        db.img_vecs, db.txt_vecs, db.valid)])
    search_ms = per_call_ms(lambda: db.search_batch(q, fleet.topk))
    log(f"[standalone] per call (host clock): slab upload {upload_ms:.3f} ms "
        f"({(db.img_vecs.nbytes * 2 + db.valid.nbytes) / 1e6:.2f} MB), "
        f"search_batch of 8 queries {search_ms:.3f} ms")
    return counts, dict(wall_s=wall, batch_walls_s=walls,
                        route_mix=fleet.stats.route_counts,
                        launches=counts, upload_ms=upload_ms,
                        search_batch_ms=search_ms)


def shape_counts() -> dict:
    """What the last drive launched, per kernel and shape (the counts are
    zeroed before every drive)."""
    from repro_torch import kernels
    return {name: {str(k): v for k, v in c.items()}
            for name, c in kernels.LAUNCHES_BY_SHAPE.items() if c}


def images_rel_err(got, want, res: int) -> tuple:
    """(largest error relative to the reference image's scale, bitwise
    equal) over pairs of finite ``(res, res, 3)`` images; fails above
    ``IMAGE_REL_TOL``."""
    import numpy as np
    rel, same = 0.0, True
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != (res, res, 3) or b.shape != a.shape \
                or not np.isfinite(a).all():
            raise AssertionError(f"bad image {a.shape} against {b.shape}")
        same = same and np.array_equal(a, b)
        rel = max(rel, float(np.abs(a - b).max()
                             / max(np.abs(b).max(), 1e-12)))
    if not rel <= IMAGE_REL_TOL:
        raise AssertionError(f"images differ: rel {rel} > {IMAGE_REL_TOL}")
    return rel, same


def same_snapshots(a: dict, b: dict, what: str) -> None:
    """Two ``VectorDB.snapshot()`` dicts, key by key and bitwise."""
    import numpy as np
    if set(a) != set(b):
        raise AssertionError(f"{what}: keys {sorted(a)} != {sorted(b)}")
    for k in a:
        if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]):
            raise AssertionError(f"{what}: {k} differs")


def run_faults(dev, backend, workdir: Path):
    """Phase 3d: the chaos preset over a 4-node fleet (journals in
    ``workdir``), group-continuous over a bursty trace; then the
    reference's interrupted-run property on the card."""
    import numpy as np
    import torch

    from repro_torch.core.trace import RequestTrace, bursty_arrivals
    from repro_torch.faults import (FaultInjector, FaultSchedule,
                                    attach_journals)
    from repro_torch.launch.serve import build_system
    from repro_torch.runtime.serving import ServingEngine

    t0 = time.perf_counter()
    system, _, _, _ = build_system(n_nodes=4, res=SERVE_RES,
                                   backend=backend, device=dev)
    journals = attach_journals(system, str(workdir / "chaos"),
                               snapshot_every=16)
    schedule = FaultSchedule.preset("chaos", nodes=4, horizon=CHAOS_GROUPS,
                                    seed=0)
    injector = FaultInjector(system, schedule, journals=journals)
    log(f"[faults] build_system(n_nodes=4, res={SERVE_RES}) + journals: "
        f"{time.perf_counter() - t0:.1f}s; schedule "
        + ", ".join(f"{e.kind}@{e.step}" for e in schedule.events))

    # the crash and the rejoin, observed: the crashed db's state at the
    # instant of the crash, the replayed db against it before it rejoins,
    # the replay's and the rejoin's host time
    seen = dict(crash={}, replay_ms=[], rejoin_ms=[], compared=0)
    crash, rejoin = system.crash_node, system.rejoin_node

    def crash_node(node):
        old = crash(node)
        seen["crash"][node] = old.snapshot()
        return old

    def rejoin_node(node, db=None):
        if db is None:
            raise AssertionError(f"node {node} rejoined cold")
        same_snapshots(db.snapshot(), seen["crash"][node],
                       f"replay of node {node}")
        seen["compared"] += 1
        torch.cuda.synchronize()
        t = time.perf_counter()
        rejoin(node, db)
        torch.cuda.synchronize()
        seen["rejoin_ms"].append((time.perf_counter() - t) * 1e3)

    system.crash_node, system.rejoin_node = crash_node, rejoin_node
    for j in journals.values():
        def timed_replay(*a, _replay=j.replay, **kw):
            t = time.perf_counter()
            db = _replay(*a, **kw)
            seen["replay_ms"].append((time.perf_counter() - t) * 1e3)
            return db
        j.replay = timed_replay

    reqs = list(RequestTrace(seed=7).generate(CHAOS_REQUESTS))
    # a burst every 5 s of the engine's clock (longer than a group takes):
    # one group per burst, so the run sees every scripted boundary
    arrivals = bursty_arrivals(reqs, burst_size=2, burst_gap=5.0)
    engine = ServingEngine(system, max_batch=8)
    done, counts, wall = drive_run(engine, arrivals,
                                   on_step=injector.on_step)
    by_shape = shape_counts()
    injector.finish()
    rep = injector.report()
    log(f"[faults] chaos, group-continuous: {len(done)} requests in "
        f"{wall:.2f}s, {rep['steps_seen']} boundaries; actions "
        f"{rep['actions']}; faults_injected {rep['faults_injected']}, "
        f"transient_retries {rep['transient_retries']}, corrupt_hits "
        f"{rep['corrupt_hits']}, degraded_serves {rep['degraded_serves']}; "
        f"route mix {system.stats.route_counts}; launches {counts}")
    log(f"[faults] launches by shape (chaos drive): {by_shape}")
    res = backend.image_res
    if len(done) != len(reqs) or any(
            c.result.image is None
            or np.asarray(c.result.image).shape != (res, res, 3)
            or not np.isfinite(np.asarray(c.result.image)).all()
            for c in done):
        raise AssertionError("chaos run lost a request or an image")
    acts = rep["actions"]
    for action in ("crash", "rejoin-journaled", "corrupt", "transient",
                   "stall", "unstall"):
        if acts.get(action, 0) < 1:
            raise AssertionError(f"chaos run: no {action} in {acts}")
    if rep["faults_injected"] == 0 or seen["compared"] != 1:
        raise AssertionError(f"chaos run: faults_injected "
                             f"{rep['faults_injected']}, replays compared "
                             f"{seen['compared']}")
    if not all(n.alive for n in system.scheduler.nodes):
        raise AssertionError("a node is still down after the chaos run")
    for name in ("vdb_topk_pernode", "flash_attention", "adaln_modulate",
                 "groupnorm_silu"):
        if counts[name] == 0:
            raise AssertionError(f"chaos drive never launched {name}")
    # generated images of random weights embed close together, so the
    # scores of the archived entries may tie within f32 rounding
    k1, swaps, gap = check_cluster_against_cpu(system, seed=8, strict=False)
    victim = next(iter(seen["crash"]))
    cur = system.dbs[victim]
    replay_ms = []
    for _ in range(5):
        t = time.perf_counter()
        journals[victim].replay(cur.dim, cur.capacity, name=cur.name,
                                use_pallas=cur.use_pallas, device=cur.device)
        replay_ms.append((time.perf_counter() - t) * 1e3)
    log(f"[check] chaos: zero loss; node {victim}'s replay equals its cache "
        f"at the crash, bitwise ({len(seen['crash'][victim]['valid'])} "
        f"slots, {int(seen['crash'][victim]['valid'].sum())} valid); after "
        f"the rejoin the card's cluster scan matches a CPU index ({k1} K1 "
        f"launches compared; {swaps} slots differ at near-ties, score gap "
        f"at most {gap:.2e})")
    log(f"[faults] host ms: journal replay of node {victim} in the run "
        f"{seen['replay_ms'][0]:.1f}, again x5 median "
        f"{float(np.median(replay_ms)):.1f}; rejoin with its restack "
        f"{seen['rejoin_ms'][0]:.1f}")
    chaos = dict(requests=len(done), wall_s=wall, report={
        k: v for k, v in rep.items() if k != "log"}, log=rep["log"],
        route_mix=system.stats.route_counts, launches=counts,
        launches_by_shape=by_shape, victim=victim,
        replay_in_run_ms=seen["replay_ms"][0], replay_ms=replay_ms,
        rejoin_ms=seen["rejoin_ms"][0], k1_compared=k1, near_tie_swaps=swaps,
        near_tie_gap=gap)
    interrupted, c_int = run_interrupted(dev, backend, workdir)
    return (counts, c_int), dict(chaos=chaos, interrupted=interrupted)


def run_interrupted(dev, backend, workdir: Path):
    """The reference's interrupted-run property on the card: serve half a
    trace, crash the busiest node, replay its journal (bitwise its cache
    at the crash), rejoin and finish; an uninterrupted twin serves the
    same trace.  Routes, nodes and steps equal, images within
    ``IMAGE_REL_TOL``, the dbs' snapshots equal."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.trace import RequestTrace
    from repro_torch.faults import attach_journals
    from repro_torch.launch.serve import build_system

    def fleet(name):
        system, _, _, _ = build_system(n_nodes=4, corpus_n=TWIN_CORPUS,
                                       res=SERVE_RES, backend=backend,
                                       device=dev)
        return system, attach_journals(system, str(workdir / name),
                                       snapshot_every=16)
    twin, _ = fleet("twin")
    system, journals = fleet("crashed")
    reqs = list(RequestTrace(seed=2).generate(INTERRUPTED_REQUESTS))
    cut = len(reqs) // 2
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    twin_res = [twin.serve(r.prompt, seed=i) for i, r in enumerate(reqs)]
    res = [system.serve(r.prompt, seed=i) for i, r in enumerate(reqs[:cut])]
    victim = max(range(4), key=lambda n: system.dbs[n].size)
    old = system.crash_node(victim)
    t = time.perf_counter()
    db = journals[victim].replay(old.dim, old.capacity, name=old.name,
                                 use_pallas=old.use_pallas, device=old.device)
    replay_ms = (time.perf_counter() - t) * 1e3
    same_snapshots(db.snapshot(), old.snapshot(), f"replay of node {victim}")
    db.attach_journal(journals[victim])
    torch.cuda.synchronize()
    t = time.perf_counter()
    system.rejoin_node(victim, db)
    torch.cuda.synchronize()
    rejoin_ms = (time.perf_counter() - t) * 1e3
    res += [system.serve(r.prompt, seed=cut + i)
            for i, r in enumerate(reqs[cut:])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    by_shape = shape_counts()
    add_shapes()
    for a, b in zip(twin_res, res):
        if ((a.fast_path or a.route.value, a.node, a.steps)
                != (b.fast_path or b.route.value, b.node, b.steps)):
            raise AssertionError("interrupted run != its twin")
    rel, bitwise = images_rel_err([r.image for r in res],
                                  [r.image for r in twin_res],
                                  backend.image_res)
    if twin.stats.route_counts != system.stats.route_counts:
        raise AssertionError("interrupted run: route counts differ")
    for i, (da, dc) in enumerate(zip(twin.dbs, system.dbs)):
        same_snapshots(dc.snapshot(), da.snapshot(), f"node {i} vs twin")
    if counts["flash_attention"] == 0 or counts["vdb_topk_pernode"] == 0:
        raise AssertionError(f"interrupted run launched {counts}")
    log(f"[faults] interrupted run: {len(reqs)} requests x 2 (twin, crash "
        f"at {cut}) in {wall:.2f}s; node {victim} replayed "
        f"({db.size} entries) in {replay_ms:.1f} ms, rejoin {rejoin_ms:.1f} "
        f"ms; route mix {system.stats.route_counts}; launches {counts}")
    log(f"[faults] launches by shape (interrupted run): {by_shape}")
    log(f"[check] interrupted run == uninterrupted twin: routes, nodes, "
        f"steps and every db snapshot equal; images max err {rel:.2e} of "
        f"scale (tol {IMAGE_REL_TOL}), bitwise {bitwise}")
    return dict(requests=2 * len(reqs), wall_s=wall, victim=victim,
                replay_ms=replay_ms, rejoin_ms=rejoin_ms,
                image_rel_err=rel, bitwise=bitwise,
                route_mix=system.stats.route_counts, launches=counts,
                launches_by_shape=by_shape), counts


def run_frontdoor(dev, backend, workdir: Path):
    """Phase 3e: a gateway (FIFO, results in a ``FileResultStore``) over a
    fresh 4-node fleet; three tenants submit every job before ``start``,
    so the dispatcher's worker thread serves the groups a direct
    ``ServingEngine.run`` of the merged trace serves on an identical
    fleet."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core.trace import (RequestTrace, merge_arrivals,
                                        trace_arrivals)
    from repro_torch.frontdoor import FileResultStore, Gateway
    from repro_torch.launch.frontdoor import jain_fairness
    from repro_torch.launch.serve import build_system
    from repro_torch.runtime.serving import ServingEngine, tenant_tier_stats

    def fleet():
        system, _, _, _ = build_system(n_nodes=4, res=SERVE_RES,
                                       backend=backend, device=dev)
        return system
    t0 = time.perf_counter()
    s_gw, s_direct = fleet(), fleet()
    log(f"[frontdoor] two build_system(n_nodes=4, res={SERVE_RES}): "
        f"{time.perf_counter() - t0:.1f}s")
    reqs = list(RequestTrace(seed=9).generate(FRONTDOOR_REQUESTS))
    per = len(reqs) // FRONTDOOR_TENANTS
    merged = merge_arrivals(*(
        trace_arrivals(reqs[i * per:(i + 1) * per], [0.0] * per,
                       tenant=f"tenant{i}", tier="standard",
                       seed_base=i * per)
        for i in range(FRONTDOOR_TENANTS)))
    gw = Gateway(ServingEngine(s_gw, max_batch=8), fair=False,
                 store=FileResultStore(str(workdir / "results")))
    handles = [gw.submit(r.prompt, tenant=r.tenant, tier=r.tier,
                         seed=r.seed, quality_tier=r.quality_tier)
               for r in merged]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    gw.start()
    try:
        for h in handles:
            h.wait(timeout=600)
    finally:
        gw.close(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if gw.dispatcher.running:
        raise AssertionError("the dispatcher did not stop")
    counts = dict(kernels.LAUNCHES)
    by_shape = shape_counts()
    add_shapes()
    for name in ("vdb_topk_pernode", "flash_attention", "adaln_modulate",
                 "groupnorm_silu"):
        if counts[name] == 0:
            raise AssertionError(f"the gateway's worker never launched "
                                 f"{name}")
    st = gw.stats()
    log(f"[frontdoor] gateway, worker thread: {st['jobs_served']} jobs of "
        f"{FRONTDOOR_TENANTS} tenants in {st['groups_served']} groups, "
        f"{wall:.2f}s; route mix {s_gw.stats.route_counts}; launches "
        f"{counts}")
    log(f"[frontdoor] launches by shape (gateway drive): {by_shape}")
    direct, c_direct, w_direct = drive_run(ServingEngine(s_direct,
                                                         max_batch=8), merged)
    by_shape_direct = shape_counts()
    log(f"[frontdoor] direct ServingEngine.run of the merged trace: "
        f"{len(direct)} requests in {w_direct:.2f}s; launches {c_direct}")
    log(f"[frontdoor] launches by shape (direct run): {by_shape_direct}")
    for h, c in zip(handles, direct):
        if (h.meta["route"], h.meta["node"]) != (
                c.result.fast_path or c.result.route.value, c.result.node):
            raise AssertionError(f"gateway != direct run for job "
                                 f"{h.job_id}")
    rel, bitwise = images_rel_err([h.image() for h in handles],
                                  [c.result.image for c in direct],
                                  backend.image_res)
    tagged = tenant_tier_stats(gw.engine.completed)
    if set(tagged) != {(f"tenant{i}", "standard")
                       for i in range(FRONTDOOR_TENANTS)}:
        raise AssertionError(f"tenant_tier_stats keys {sorted(tagged)}")
    served = [int(s["n"]) for s in tagged.values()]
    jain = jain_fairness(served)
    log(f"[check] gateway == direct run: routes and nodes equal, images "
        f"from the file store max err {rel:.2e} of scale (tol "
        f"{IMAGE_REL_TOL}), bitwise {bitwise}; one stats key per tenant")
    for (tenant, tier), s in tagged.items():
        log(f"[frontdoor] {tenant}/{tier}: n={s['n']} queue delay p50/p95 "
            f"{s['queue_delay_p50'] * 1e3:.1f}/"
            f"{s['queue_delay_p95'] * 1e3:.1f} ms, wall p50/p95 "
            f"{s['wall_p50'] * 1e3:.1f}/"
            f"{s['wall_p95'] * 1e3:.1f} ms, e2e p50/p95 "
            f"{s['e2e_p50'] * 1e3:.1f}/{s['e2e_p95'] * 1e3:.1f} ms")
    log(f"[frontdoor] Jain fairness {jain:.3f} over served per tenant "
        f"{served}")
    return (counts, c_direct), dict(
        jobs=st["jobs_served"], groups=st["groups_served"], wall_s=wall,
        direct_wall_s=w_direct, image_rel_err=rel, bitwise=bitwise,
        per_tenant={f"{t}/{tier}": v for (t, tier), v in tagged.items()},
        jain=jain, route_mix=s_gw.stats.route_counts, launches=counts,
        launches_direct=c_direct, launches_by_shape=by_shape,
        launches_by_shape_direct=by_shape_direct)


# ---------------------------------------------------------------------------
# phase 3f/3g: the node mesh
# ---------------------------------------------------------------------------


def host_ms(fn, n: int = 50) -> float:
    """Median host-clock time per call of ``fn``, which ends in a copy to
    the host (so each call waits for its device work)."""
    import numpy as np
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def mesh_scan_case(gen, dev, devs, k: int = 8) -> dict:
    """The drive fleet's scan inputs (4 nodes x 400 x 512, integer-valued,
    node 3 empty) split over a mesh on ``devs``: each shard's K1 and K2
    (node-masked with shard-local node ids, and global) against the plain
    versions on its device, slot ids equal; then the host-merged lists
    against one device's K1/K2 over the unsplit slab, slots and scores
    equal (a row's score does not depend on the split: a node's rows go
    to the same blocks, summed in the same order, whatever the shard).
    Returns the scan walls (host clock, lists brought back) of one
    device's K1 and of the mesh's."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops, vdb_topk
    from repro_torch.runtime import partition
    q, slabs, valid, nids = scan_inputs(gen, ties=True, dev=dev)
    mesh = len(devs)
    padded = partition.padded_nodes(4, mesh)
    n = padded // mesh
    full_s = torch.zeros((2, padded, 400, 512), device=dev)
    full_s[:, :4] = slabs
    full_v = torch.zeros((padded, 400), dtype=torch.bool, device=dev)
    full_v[:4] = valid
    shards = [(full_s[:, s * n:(s + 1) * n].contiguous().to(d),
               full_v[s * n:(s + 1) * n].contiguous().to(d))
              for s, d in enumerate(devs)]
    err = 0.0
    for s, (sl, va) in enumerate(shards):
        res = check_scans(q.to(sl.device), sl, va,
                          (nids - s * n).to(sl.device), k, exact=True)
        err = max([err] + [e for e, _ in res.values()])
    nid = nids.cpu().numpy()
    got = ops.vdb_topk_pernode_mesh(q, shards, k)
    one = [t.cpu().numpy() for t in vdb_topk.launch_pernode(q, slabs,
                                                            valid, k)]
    same = [np.array_equal(got[0][:, :4], one[0]),
            np.array_equal(got[1][:, :4], one[1])]
    for mask in (True, False):
        lists = ops.vdb_topk_sharded_mesh(q, shards, nid, k,
                                          mask_nodes=mask)
        merged = ops.merge_shard_topk(*lists, k)
        one2 = [t.cpu().numpy() for t in vdb_topk.launch_sharded(
            q, slabs, valid, nids, k, mask_nodes=mask)]
        same += [np.array_equal(merged[0], one2[0]),
                 np.array_equal(merged[1], one2[1])]
    if not all(same):
        raise AssertionError(f"mesh of {mesh} on {devs}: merged lists != "
                             f"one device's ({same})")
    walls = dict(
        one_device_ms=host_ms(lambda: [t.cpu().numpy() for t in
                                       vdb_topk.launch_pernode(
                                           q, slabs, valid, k)]),
        mesh_ms=host_ms(lambda: ops.vdb_topk_pernode_mesh(q, shards, k)))
    torch.cuda.synchronize()
    log(f"[mesh] scans over {mesh} shards on "
        f"{', '.join(str(d) for d in devs)} (4 nodes padded to {padded}): "
        f"each shard's K1/K2 = plain (slot ids equal, err {err:.2e}); "
        f"merged = one device's K1/K2, slots and scores; K1 scan wall "
        f"(lists on the host) {walls['mesh_ms']:.4f} ms against "
        f"{walls['one_device_ms']:.4f} ms on one device")
    return dict(devices=[str(d) for d in devs], padded=padded,
                max_abs_err=err, **walls)


def run_mesh_scans(dev) -> dict:
    """Phase 3f: mesh scans over 2 and 3 shards on this card, and, where
    the process sees two cards or more, one shard per card."""
    import torch
    gen = torch.Generator().manual_seed(17)
    out = {f"mesh{m}_one_card": mesh_scan_case(gen, dev, [dev] * m)
           for m in (2, 3)}
    n = torch.cuda.device_count()
    if n >= 2:
        for m in sorted({2, min(n, 4)}):
            devs = [torch.device("cuda", i) for i in range(m)]
            out[f"mesh{m}_one_card_each"] = mesh_scan_case(gen, dev, devs)
            out[f"mesh{m}_same_card"] = mesh_scan_case(gen, dev, [dev] * m)
    else:
        log("[mesh] one card: no mesh with a shard per card")
    return out


def journal_rejoin(system, journals, node: int) -> None:
    """Crash ``node`` and rejoin it with its journal's replay (the fault
    injector's journaled rejoin)."""
    system.crash_node(node)
    cur = system.dbs[node]
    db = journals[node].replay(cur.dim, cur.capacity, name=cur.name,
                               use_pallas=cur.use_pallas, device=cur.device)
    db.attach_journal(journals[node])
    system.rejoin_node(node, db)


def run_mesh_serve(dev, backend, record: dict, n_requests: int,
                   workdir: Path):
    """Phase 3g: ``build_system(n_nodes=4, res=256, mesh_nodes=3)`` with
    its three shards on this card serves the serve drive's requests
    (score, then centroid routing) and must give the serve drive's
    routes, nodes, images and cache state, bitwise.  A mesh-1 twin (a
    copy of the fleet as built, its index restacked on one shard) takes
    the same steps.  Then on both: node 3 crashes and rejoins from its
    journal, a fifth node joins (5 nodes, padded to 6: new shard
    boundaries), and 8 more requests are served; the two must agree
    bitwise.  K1/K2 launch once per shard per micro-batch."""
    import copy

    import numpy as np
    import torch

    from repro_torch.core.trace import RequestTrace
    from repro_torch.faults import attach_journals
    from repro_torch.launch.serve import build_system
    from repro_torch.runtime.serving import ServingEngine
    t0 = time.perf_counter()
    mesh, _, _, _ = build_system(n_nodes=4, res=SERVE_RES, backend=backend,
                                 device=dev, mesh_nodes=3,
                                 mesh_devices=[dev] * 3)
    # the twin shares the models and the embedder, and copies the rest
    twin = copy.deepcopy(mesh, memo={id(backend): backend,
                                     id(mesh.embedder): mesh.embedder})
    twin.mesh_nodes, twin.mesh = 1, None
    twin._restack_cluster()
    build_s = time.perf_counter() - t0
    ci = mesh.cluster_index
    bytes_mesh, bytes_one = (ci.per_device_slab_bytes(),
                             twin.cluster_index.per_device_slab_bytes())
    reqs = [(r.prompt, r.quality_tier)
            for r in RequestTrace(seed=1).generate(n_requests + 8)]
    more = [(r.prompt, r.quality_tier)
            for r in RequestTrace(seed=11).generate(8)]
    runs, launch_sum = {}, []
    for name, system in (("mesh", mesh), ("twin", twin)):
        engine = ServingEngine(system, max_batch=8)
        journals = attach_journals(system, str(workdir / f"mesh_{name}"),
                                   snapshot_every=16)
        done, c1, w1, b1 = drive(engine, reqs[:n_requests], 0)
        system.routing = "centroid"
        done2, c2, w2, b2 = drive(engine, reqs[n_requests:], n_requests)
        system.routing = "score"
        first = dict(routes=[c.result.route.name for c in done + done2],
                     nodes=[c.result.node for c in done + done2],
                     images=[np.asarray(c.result.image)
                             for c in done + done2],
                     state=cache_state(system))
        # a restack builds a new index, whose stats start at zero
        gathered = system.cluster_index.stats["allgather_bytes"]
        t1 = time.perf_counter()
        journal_rejoin(system, journals, 3)
        system.join_node()
        restack_ms = (time.perf_counter() - t1) * 1e3
        done3, c3, w3, b3 = drive(engine, more, 100)
        runs[name] = dict(
            first=first, routes=[c.result.route.name for c in done3],
            nodes=[c.result.node for c in done3],
            images=[np.asarray(c.result.image) for c in done3],
            state=cache_state(system), counts=(c1, c2, c3),
            walls=(w1, w2, w3), batch_walls=b1 + b2 + b3,
            restack_ms=restack_ms,
            allgather_bytes=(gathered,
                             system.cluster_index.stats["allgather_bytes"]))
        launch_sum += [c1, c2, c3]
    m, t = runs["mesh"], runs["twin"]
    for what, a, b in (("serve drive", m["first"], record),
                       ("mesh-1 twin", m["first"], t["first"]),
                       ("mesh-1 twin after crash, rejoin and join", m, t)):
        for key in ("routes", "nodes", "state"):
            if a[key] != b[key]:
                raise AssertionError(f"mesh drive != {what}: {key}")
        if len(a["images"]) != len(b["images"]) or not all(
                np.array_equal(x, y) for x, y in zip(a["images"],
                                                     b["images"])):
            raise AssertionError(f"mesh drive != {what}: images differ")
    images_rel_err(m["images"], t["images"], backend.image_res)
    ci = mesh.cluster_index
    if (ci.mesh_nodes, ci.n_nodes, ci.padded_nodes) != (3, 5, 6) or \
            ci.mesh.devices != (dev,) * 3:
        raise AssertionError(f"mesh after the join: {ci.mesh_nodes} "
                             f"shards, {ci.n_nodes} nodes, "
                             f"{ci.padded_nodes} padded")
    # K1 (score routing) and K2 (centroid routing) once per shard per
    # micro-batch: three times the twin's launches, drive by drive
    for c_m, c_t in zip(m["counts"], t["counts"]):
        for scan in ("vdb_topk_pernode", "vdb_topk_sharded"):
            if c_m[scan] != 3 * c_t[scan]:
                raise AssertionError(f"{scan}: {c_m[scan]} launches on the "
                                     f"mesh, {c_t[scan]} on one device")
    per_batch = {}
    for i, scan in enumerate(("vdb_topk_pernode", "vdb_topk_sharded")):
        if not t["counts"][i][scan]:
            raise AssertionError(f"the {('score', 'centroid')[i]}-routed "
                                 f"drive never launched {scan}")
        per_batch[scan] = m["counts"][i][scan] / t["counts"][i][scan]
    torch.cuda.synchronize()
    out = dict(
        build_s=build_s, launches_per_micro_batch=per_batch,
        allgather_bytes=dict(zip(("score_and_centroid", "after_join"),
                                 m["allgather_bytes"])),
        per_device_slab_bytes=dict(mesh3_one_card=bytes_mesh,
                                   mesh1=bytes_one,
                                   after_join=ci.per_device_slab_bytes()),
        memory_allocated=torch.cuda.memory_allocated(dev),
        walls_s=dict(mesh=m["walls"], twin=t["walls"],
                     serve_drive=record["walls"]),
        batch_walls_s=dict(mesh=m["batch_walls"], twin=t["batch_walls"]),
        restack_ms=dict(mesh=m["restack_ms"], twin=t["restack_ms"]),
        launches=dict(mesh=m["counts"], twin=t["counts"]),
        routes_after_join=m["routes"])
    log(f"[mesh] build_system(n_nodes=4, res={SERVE_RES}, mesh_nodes=3) on "
        f"{dev} x3 + a mesh-1 twin {build_s:.1f}s; drives (score, "
        f"centroid, after crash/rejoin/join) mesh "
        + ", ".join(f"{w:.2f}" for w in m["walls"]) + " s, twin "
        + ", ".join(f"{w:.2f}" for w in t["walls"]) + " s; routes, nodes, "
        "images and cache state = the serve drive's and the twin's, "
        f"bitwise; K1/K2 launches per micro-batch {per_batch}; "
        f"lists gathered {m['allgather_bytes'][0]} B over the first 16 "
        f"requests, {m['allgather_bytes'][1]} B after the join (twin "
        f"{t['allgather_bytes']}); slab bytes on the card "
        f"{bytes_mesh} (mesh 1: {bytes_one}; after the join "
        f"{out['per_device_slab_bytes']['after_join']}); memory allocated "
        f"{out['memory_allocated'] / 1e6:.1f} MB; crash + journal rejoin + "
        f"join {m['restack_ms']:.1f} ms (twin {t['restack_ms']:.1f})")
    total = {k: sum(c[k] for c in launch_sum) for k in launch_sum[0]}
    return total, out


def check_vaes(backend, dev) -> dict:
    """The full VAE with K6 against the plain VAE on the card, and a small
    VAE on the card against the CPU."""
    import torch

    from repro_torch.models.diffusion.vae import VAE, VAEConfig
    gen = torch.Generator().manual_seed(7)
    plain = VAE(backend.vae.cfg, use_pallas=False)
    plain.load_state_dict(backend.vae.state_dict())
    plain = plain.to(dev).eval()
    img = (torch.rand((2, SERVE_RES, SERVE_RES, 3), generator=gen) * 2
           - 1).to(dev)
    z = torch.randn((2, SERVE_RES // 8, SERVE_RES // 8, 4),
                    generator=gen).to(dev)
    out = {}
    with torch.no_grad():
        for name, a, b in (
                ("encode", backend.vae.encode(img)[0], plain.encode(img)[0]),
                ("decode", backend.vae.decode(z), plain.decode(z))):
            out[f"vae_full_{name}_rel_err"] = float(
                (a - b).abs().max() / b.abs().max())
        small = VAE(VAEConfig(in_ch=3, base_ch=32, ch_mult=(1, 2), z_ch=4,
                              n_res=1), generator=gen).eval()
        s_gpu = VAE(small.cfg)
        s_gpu.load_state_dict(small.state_dict())
        s_gpu = s_gpu.to(dev).eval()
        x = torch.rand((2, 32, 32, 3), generator=gen) * 2 - 1
        want = small.decode(small.encode(x)[0])
        got = s_gpu.decode(s_gpu.encode(x.to(dev))[0]).cpu()
        out["vae_small_cpu_rel_err"] = float(
            (got - want).abs().max() / want.abs().max())
    for k_, v in out.items():
        if not v <= VAE_REL_TOL:
            raise AssertionError(f"{k_} = {v} > {VAE_REL_TOL}")
    log("[check] VAE with K6 vs plain on the card (B=2, 256 px): encode "
        f"{out['vae_full_encode_rel_err']:.2e}, decode "
        f"{out['vae_full_decode_rel_err']:.2e}; small VAE card vs CPU "
        f"{out['vae_small_cpu_rel_err']:.2e} (of scale; tol {VAE_REL_TOL})")
    return out


def check_cluster_against_cpu(system, seed: int, strict: bool = True):
    """The fleet's cluster index on the card (K1) against a CPU index
    built from the same dbs (plain version): the same slot ids per query
    and node, scores within ``KERNEL_TOL``.  With ``strict`` false a slot
    may differ at a near-tie: the card's slot there must be valid and its
    own score (cosine in f64 from the db's rows) within ``KERNEL_TOL`` of
    the CPU list's at that rank.  Returns (K1 launches compared, slots
    that differed at a near-tie, the largest such score gap)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.core.cluster_index import ClusterIndex
    from repro_torch.core.trace import RequestTrace
    n0 = kernels.LAUNCHES["vdb_topk_pernode"]
    cpu_ci = ClusterIndex.from_dbs(system.dbs, device="cpu")
    swaps, gap = 0, 0.0
    try:
        prompts = [r.prompt for r in RequestTrace(seed=seed).generate(8)]
        qv = system.embedder.embed_text(prompts)
        rows_gpu = system.cluster_index.search_cluster_nodes(qv, system.topk)
        rows_cpu = cpu_ci.search_cluster_nodes(qv, system.topk)
        for qi, (per_q_g, per_q_c) in enumerate(zip(rows_gpu, rows_cpu)):
            for node, ((s_g, l_g), (s_c, l_c)) in enumerate(
                    zip(per_q_g, per_q_c)):
                what = (f"card scan != CPU scan at query {qi}, node {node}:"
                        f" card {list(l_g)} {list(s_g)}, CPU {list(l_c)} "
                        f"{list(s_c)}")
                if len(l_g) != len(l_c) or not np.allclose(
                        s_g, s_c, rtol=0, atol=KERNEL_TOL):
                    raise AssertionError(what)
                if np.array_equal(l_g, l_c):
                    continue
                if strict:
                    raise AssertionError(what)
                db = system.dbs[node]
                q = qv[qi].astype(np.float64)
                q /= np.linalg.norm(q)
                for r, (a, b) in enumerate(zip(l_g, l_c)):
                    if a == b:
                        continue
                    own = max(float(db.img_vecs[a] @ q),
                              float(db.txt_vecs[a] @ q))
                    if not db.valid[a] or not abs(own - s_c[r]) <= \
                            KERNEL_TOL:
                        raise AssertionError(f"{what}; slot {a} valid "
                                             f"{bool(db.valid[a])} scores "
                                             f"{own}")
                    swaps += 1
                    gap = max(gap, abs(own - float(s_c[r])))
    finally:
        for db in system.dbs:
            db.unregister_cluster(cpu_ci)
    n = kernels.LAUNCHES["vdb_topk_pernode"] - n0
    if n == 0:
        raise AssertionError("the card's cluster scan launched no K1")
    return n, swaps, gap


def check_against_references(system, backend, dev):
    import torch

    from repro_torch.models.diffusion.dit import (DiT, DiTConfig,
                                                  perturb_zero_init_)

    # retrieval: the card's index (kernels) vs a CPU index over the same
    # fleet (plain versions) — same candidates per node
    check_cluster_against_cpu(system, seed=5)

    # DiT at full size: kernels vs the plain path, same weights and inputs
    gen = torch.Generator().manual_seed(3)
    cfg = backend.dit.cfg
    x = torch.randn((8, cfg.img_res, cfg.img_res, cfg.in_ch),
                    generator=gen).to(dev)
    t = torch.tensor([999, 900, 700, 500, 300, 100, 10, 0], device=dev)
    ctx = torch.randn((8, cfg.ctx_dim), generator=gen).to(dev)
    plain = DiT(cfg._replace(use_pallas=False, use_pallas_adaln=False))
    plain.load_state_dict(backend.dit.state_dict())
    plain = plain.to(dev).eval()
    with torch.no_grad():
        a, b = backend.dit(x, t, ctx), plain(x, t, ctx)
    rel = float((a - b).abs().max() / b.abs().max())
    if not rel <= DIT_REL_TOL:
        raise AssertionError(f"DiT kernels vs plain on the card: rel {rel}")
    log(f"[check] DiT-B/2 (12 blocks, B=8) kernels vs plain on the card: "
        f"max err {rel:.2e} of scale (tol {DIT_REL_TOL})")

    # small DiT: the card (kernels) vs the CPU (plain versions)
    small = DiTConfig(img_res=8, in_ch=4, patch=2, n_layers=2, d_model=768,
                      n_heads=12, ctx_dim=512)
    g2 = torch.Generator().manual_seed(4)
    m_cpu = DiT(small, generator=g2)
    perturb_zero_init_(m_cpu, g2)
    m_gpu = DiT(small)
    m_gpu.load_state_dict(m_cpu.state_dict())
    m_gpu = m_gpu.to(dev).eval()
    xs = torch.randn((2, 8, 8, 4), generator=g2)
    ts = torch.tensor([17, 640])
    cs = torch.randn((2, 512), generator=g2)
    with torch.no_grad():
        want = m_cpu.eval()(xs, ts, cs)
        got = m_gpu(xs.to(dev), ts.to(dev), cs.to(dev)).cpu()
    rel2 = float((got - want).abs().max() / want.abs().max())
    if not rel2 <= DIT_REL_TOL:
        raise AssertionError(f"small DiT card vs CPU: rel {rel2}")
    log(f"[check] cluster scans match a CPU index; small DiT card vs CPU: "
        f"max err {rel2:.2e} of scale")
    return dict(dit_full_rel_err=rel, dit_small_cpu_rel_err=rel2)


# ---------------------------------------------------------------------------
# phase 5: flux-dev (src/repro/configs/flux_dev.py) at full width, bf16
# ---------------------------------------------------------------------------

BF16_FLOP_PER_S = 989e12
# K4 at bf16 against its plain version (the bf16 kernel tolerance of
# tests/test_kernels.py): P rounds to bf16 in the kernel and in the plain
# version's probabilities, at different points; also the MMDiT with the
# kernel against its plain path, relative to the output's scale
BF16_TOL = 2e-2
FLUX_STEPS = 4            # gen_fast's steps
FLUX_STRENGTH = 0.6
# q/k/v shapes (B, S, H, D) of K4 at bf16: gen_fast's and gen_1024's joint
# attention, and one at head dim 64
FA_BF16_SHAPES = ((16, 1280, 24, 128), (4, 4352, 24, 128),
                  (16, 1280, 48, 64))
# the small MMDiT held against the CPU: head dim 128 as at full width
FLUX_SMALL = dict(img_res=8, in_ch=4, patch=2, n_double=2, n_single=2,
                  d_model=256, n_heads=2, txt_len=16, txt_dim=64,
                  vec_dim=64)


def events_ms(fn, reps: int = 3) -> float:
    """Time per call of ``reps`` back-to-back eager calls between two CUDA
    events, after one warm-up: for calls of a millisecond or more, whose
    host launch cost is noise, and whose allocations are too large to
    capture ``device_ms``'s 20 calls in one CUDA graph."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def fa_bf16_bound(b: int, sq: int, sk: int, h: int, d: int):
    """K4 bound at bf16: q, k, v read once and o written once (2 bytes
    each); 4·B·H·Sq·Sk·D flops of products against the dense bf16 rate."""
    byts = (2 * b * sq * h * d + 2 * b * sk * h * d) * 2
    t_mem = byts / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * b * h * sq * sk * d / BF16_FLOP_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def check_flash_attention_bf16(gen, dev) -> dict:
    """K4 at bf16 at ``FA_BF16_SHAPES``, v a strided view as the single
    block hands it over (rows of 3·d + 4·d), against the plain version on
    the same bf16 inputs (``BF16_TOL``) and against the plain version in
    f32 from the same inputs; a ragged and a causal case; device ms of
    kernel, plain and SDPA.  The row reported is gen_fast's shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref
    bf = torch.bfloat16
    per_shape = []
    for b, s_, h, d in FA_BF16_SHAPES:
        width = 7 * h * d                      # linear1's row: 3d + 4d
        u = torch.randn((b, s_, width), generator=gen).to(dev, bf)
        q = u[..., :h * d].reshape(b, s_, h, d).contiguous()
        k = u[..., h * d:2 * h * d].reshape(b, s_, h, d).contiguous()
        v = u[..., 2 * h * d:3 * h * d].reshape(b, s_, h, d)   # strided
        got = flash_attention.launch(q, k, v)
        err = float((got.float() - ref.flash_attention_ref(q, k, v)
                     .float()).abs().max())
        err32 = float((got.float() - ref.flash_attention_ref(
            q.float(), k.float(), v.float())).abs().max())
        torch.cuda.empty_cache()
        for name, e in (("plain", err), ("f32 plain", err32)):
            if not e <= BF16_TOL:
                raise AssertionError(f"flash_attention_bf16 {(b, s_, h, d)} "
                                     f"vs {name}: err {e}")
        bd = fa_bf16_bound(b, s_, s_, h, d)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        r = dict(shape=(b, s_, h, d), max_abs_err=err, err_f32_plain=err32,
                 bound_ms=bd[0], bound_by=bd[1],
                 ms=device_ms(lambda: flash_attention.launch(q, k, v),
                              reps=10, replays=5),
                 call_ms=call_ms(lambda: flash_attention.launch(q, k, v),
                                 iters=10, runs=3),
                 plain_ms=events_ms(lambda: ref.flash_attention_ref(q, k, v)),
                 library_ms=device_ms(
                     lambda: F.scaled_dot_product_attention(qt, kt, vt),
                     reps=10, replays=5))
        per_shape.append(r)
        log(f"[kernels] flash_attention_bf16 q/k/v {r['shape']} (v strided): "
            f"err {err:.2e} vs plain, {err32:.2e} vs f32 plain (tol "
            f"{BF16_TOL})  device {r['ms']:.4f} ms  call "
            f"{r['call_ms']:.4f}  plain {r['plain_ms']:.4f}  SDPA "
            f"{r['library_ms']:.4f}  bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}, bf16 989 TFLOP/s)")
        del u, q, k, v, got, qt, kt, vt
        torch.cuda.empty_cache()
    for (b, sq, sk, h, d), causal in (((2, 1000, 1000, 4, 128), False),
                                      ((2, 700, 1000, 4, 128), True),
                                      ((2, 333, 333, 4, 64), True)):
        q = torch.randn((b, sq, h, d), generator=gen).to(dev, bf)
        k, v = (torch.randn((b, sk, h, d), generator=gen).to(dev, bf)
                for _ in range(2))
        got = flash_attention.launch(q, k, v, causal=causal)
        e = float((got.float() - ref.flash_attention_ref(
            q, k, v, causal=causal).float()).abs().max())
        if not e <= BF16_TOL:
            raise AssertionError(f"flash_attention_bf16 {(b, sq, sk, h, d)} "
                                 f"causal={causal}: err {e}")
        per_shape.append(dict(shape=(b, sq, sk, h, d), causal=causal,
                              max_abs_err=e))
        log(f"[kernels] flash_attention_bf16 q ({b}, {sq}, {h}, {d}), k/v "
            f"({b}, {sk}, ...) causal={causal}: err {e:.2e}")
    row = dict(per_shape[0])
    row.update(name="flash_attention_bf16", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:82",
               max_abs_err=max(r["max_abs_err"] for r in per_shape),
               tol=BF16_TOL, per_shape=per_shape,
               shape=f"q/k/v {per_shape[0]['shape']} bf16, v strided")
    return row


def flux_models(dev):
    """flux-dev's gen_fast and gen_1024 programs, the MMDiT built once on
    the card in bf16 from a CUDA generator (seeded) with its
    zero-initialised layers perturbed, the text encoder and the full
    VAE (f32)."""
    import torch

    from repro_torch.configs import get_arch, get_shape
    from repro_torch.models.diffusion.mmdit import perturb_zero_init_
    from repro_torch.models.diffusion.text_encoder import (TextEncoder,
                                                           TextEncoderConfig)
    from repro_torch.models.diffusion.vae import VAE, VAEConfig
    from repro_torch.runtime.steps import build_cell_program
    arch = get_arch("flux-dev")
    fast = build_cell_program(arch, get_shape("diffusion", "gen_fast"),
                              device=dev)
    big = build_cell_program(arch, get_shape("diffusion", "gen_1024"),
                             device=dev)
    t0 = time.perf_counter()
    net = fast.init_fn(seed=0)
    perturb_zero_init_(net, torch.Generator(dev).manual_seed(1))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    te = TextEncoder(TextEncoderConfig(max_len=256), device=dev,
                     generator=torch.Generator(dev).manual_seed(2)).eval()
    vae = VAE(VAEConfig(**FULL_VAE),
              generator=torch.Generator().manual_seed(3)).to(dev).eval()
    return fast, big, net, te, vae, build_s


def flux_conditioning(te, n: int, seed: int):
    """``txt`` (n, 256, 768) and ``vec`` (n, 512) from the port's hash
    tokenizer and text encoder over trace prompts, cast to bf16 as
    ``apply_mmdit`` casts them."""
    import torch

    from repro_torch.core.trace import RequestTrace
    from repro_torch.data.tokenizer import HashTokenizer
    prompts = [r.prompt for r in RequestTrace(seed=seed).generate(n)]
    tokens = HashTokenizer().encode_batch(prompts, max_len=te.cfg.max_len)
    ctx, pooled = te(torch.from_numpy(tokens).to(te.embed.device))
    return {"txt": ctx.to(torch.bfloat16), "vec": pooled.to(torch.bfloat16)}


def flux_counts(label: str, want_bf16: int) -> dict:
    """Read the launch counts after a flux drive; K4 at bf16 must have
    launched ``want_bf16`` times."""
    from repro_torch import kernels
    counts = dict(kernels.LAUNCHES)
    add_shapes()
    if counts["flash_attention_bf16"] != want_bf16:
        raise AssertionError(f"{label}: flash_attention_bf16 launched "
                             f"{counts['flash_attention_bf16']} times, "
                             f"want {want_bf16}")
    for name, c in kernels.LAUNCHES_BY_SHAPE.items():
        for shape, n in sorted(c.items()):
            log(f"[flux] {label} launches: {name} {shape} x {n}")
    return counts


def check_new_gn_shapes(c_shapes, dev) -> list:
    """K6 against its plain version at every shape the flux drive launched
    it, with the partition the kernel takes there."""
    import torch

    from repro_torch.kernels import groupnorm_silu, ref
    gen = torch.Generator(dev).manual_seed(31)
    out = []
    for shape in sorted(c_shapes):
        x = torch.randn(shape, generator=gen, device=dev) * 2 + 0.5
        c = shape[-1]
        sc = torch.randn((c,), generator=gen, device=dev) * 0.3 + 1
        bi = torch.randn((c,), generator=gen, device=dev) * 0.3
        err = float((groupnorm_silu.launch(x, sc, bi)
                     - ref.groupnorm_silu_ref(x, sc, bi)).abs().max())
        if err > KERNEL_TOL:
            raise AssertionError(f"groupnorm_silu {shape}: err {err}")
        p = groupnorm_silu.plan(shape[1] * shape[2], c)
        out.append(dict(shape=shape, max_abs_err=err, plan=p))
        log(f"[flux] groupnorm_silu {shape}: err {err:.2e} (tol "
            f"{KERNEL_TOL}); {p['slices']} slices x {p['cluster_blocks']} "
            f"blocks, {p['thread_pixels_on_chip']}/{p['thread_pixels']} of "
            f"a thread's pixels on chip")
        del x
        torch.cuda.empty_cache()
    return out


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max())


def run_flux(dev):
    """Phase 5: flux-dev at full width and depth in bf16 on the card.
    (b) the gen_fast ``rf_edit`` generation: conditioning from the text
    encoder (K4 f32), the full VAE encodes 16 reference images (K6),
    4 Euler steps at strength 0.6 (K4 bf16, 57 a step), a decode; (a)
    one step of the gen_1024 program on the same weights (``img_pos``
    swapped).  Then the checks: the full-depth velocity finite and
    against the plain path at gen_fast, a 2 + 2 block full-width MMDiT
    kernel against plain, a small MMDiT card against CPU, K6 at the new
    shapes, the K4 bf16 rows.  Returns (launch counts of both drives,
    summary, K4 bf16 row)."""
    import torch

    from repro_torch import kernels
    from repro_torch.models.diffusion.mmdit import (MMDiT, MMDiTConfig,
                                                    make_v_fn,
                                                    perturb_zero_init_)
    from repro_torch.models.diffusion.sampler import rf_edit
    bf = torch.bfloat16
    summary = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    fast, big, net, te, vae, build_s = flux_models(dev)
    n_params = sum(p.numel() for p in net.parameters())
    summary.update(build_s=build_s, params=n_params,
                   weights_gb=(torch.cuda.memory_allocated(dev) - mem0) / 1e9)
    log(f"[flux] flux-dev MMDiT built on the card in bf16: {n_params:,} "
        f"parameters, {build_s:.1f} s; {summary['weights_gb']:.2f} GB "
        "allocated with the text encoder and the VAE")
    cfg = net.cfg
    per_step = cfg.n_double + cfg.n_single      # K4 launches a forward
    b = fast.cell.global_batch
    res = fast.meta["latent"] * fast.meta["config"].vae.downsample
    gen = torch.Generator(dev).manual_seed(4)
    imgs = torch.rand((b, res, res, 3), generator=gen, device=dev) * 2 - 1
    noise = torch.randn((b, cfg.img_res, cfg.img_res, cfg.in_ch),
                        generator=gen, device=dev, dtype=bf)
    step_ms = []
    v_net = make_v_fn(net)

    def v_fn(x, t, ctx):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = v_net(x, t, ctx)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return v

    # (b) the gen_fast rf_edit generation
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        ctx = flux_conditioning(te, b, seed=21)
        mean, _ = vae.encode(imgs)
        z = rf_edit(v_fn, mean, ctx, steps=FLUX_STEPS,
                    strength=FLUX_STRENGTH, dtype=bf, noise=noise)
        out = vae.decode(z.float())
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    peak_b = torch.cuda.max_memory_allocated(dev)
    c_fast = flux_counts("gen_fast rf_edit", per_step * FLUX_STEPS)
    gn_fast = {s for s in kernels.LAUNCHES_BY_SHAPE["groupnorm_silu"]}
    if c_fast["flash_attention"] != te.cfg.n_layers:
        raise AssertionError(f"text encoder: {c_fast['flash_attention']} "
                             "f32 flash_attention launches")
    if tuple(out.shape) != (b, res, res, 3) or not bool(
            torch.isfinite(out).all()) or not bool(torch.isfinite(z).all()):
        raise AssertionError("flux rf_edit: output not finite or of the "
                             f"wrong shape {tuple(out.shape)}")
    summary["gen_fast"] = dict(
        wall_s=wall_b, step_ms=step_ms, peak_gb=peak_b / 1e9,
        launches={k: v for k, v in c_fast.items() if v})
    log(f"[flux] gen_fast rf_edit (B={b}, {res} px, latent "
        f"{cfg.img_res}, {cfg.n_img_tokens} + {cfg.txt_len} tokens, "
        f"{FLUX_STEPS} steps at strength {FLUX_STRENGTH}; encode, steps, "
        f"decode): wall {wall_b:.2f} s; ms per step "
        + ", ".join(f"{m:.1f}" for m in step_ms)
        + f"; K4 bf16 {c_fast['flash_attention_bf16']} launches "
        f"({per_step} a forward x {FLUX_STEPS}), K4 f32 (text encoder) "
        f"{c_fast['flash_attention']}, K6 {c_fast['groupnorm_silu']}; "
        f"peak {peak_b / 1e9:.2f} GB")

    # the full-depth velocity at the first step, kernel and plain path
    ts = torch.full((b,), FLUX_STRENGTH, dtype=bf, device=dev)
    x0 = (torch.tensor(1 - FLUX_STRENGTH, dtype=bf, device=dev)
          * mean.to(bf) + torch.tensor(FLUX_STRENGTH, dtype=bf,
                                       device=dev) * noise)
    with torch.no_grad():
        v_k = net(x0, ts, ctx)
        net.cfg = cfg._replace(use_pallas=False)
        v_p = net(x0, ts, ctx)
        net.cfg = cfg
    if not bool(torch.isfinite(v_k).all()):
        raise AssertionError("flux-dev velocity is not finite")
    summary["velocity_rel_err"] = rel_err(v_k, v_p)
    summary["velocity_scale"] = float(v_p.float().abs().max())
    log(f"[flux] full-depth velocity ({per_step} blocks, gen_fast): finite; "
        f"kernel vs plain path {summary['velocity_rel_err']:.2e} of scale "
        f"{summary['velocity_scale']:.3f}")
    del v_k, v_p, x0, mean, z, out, imgs

    # (a) one step of the gen_1024 program, on the same weights
    net.set_img_res(big.meta["latent"],
                    generator=torch.Generator(dev).manual_seed(5))
    (x_shape, x_dt), _, _, _ = big.arg_shapes
    g2 = torch.Generator(dev).manual_seed(6)
    x = torch.randn(x_shape, generator=g2, device=dev, dtype=x_dt)
    t = torch.full((x_shape[0],), 999, dtype=torch.int32, device=dev)
    t_prev = torch.tensor(979, dtype=torch.int32, device=dev)
    with torch.no_grad():
        ctx_a = flux_conditioning(te, x_shape[0], seed=22)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        x1 = big.step_fn(net, x, t, t_prev, ctx_a)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    peak_a = torch.cuda.max_memory_allocated(dev)
    c_big = flux_counts("gen_1024 step", per_step)
    if x1.dtype != bf or x1.shape != x.shape or not bool(
            torch.isfinite(x1).all()) or torch.equal(x1, x):
        raise AssertionError("gen_1024 step: output not finite, unchanged "
                             "or of the wrong shape")
    summary["gen_1024"] = dict(wall_s=wall_a, peak_gb=peak_a / 1e9,
                               launches={k: v for k, v in c_big.items()
                                         if v})
    log(f"[flux] gen_1024 program, one step (B={x_shape[0]}, latent "
        f"{x_shape[1]}, {net.cfg.n_img_tokens} + {cfg.txt_len} tokens): "
        f"wall {wall_a * 1e3:.1f} ms; K4 bf16 "
        f"{c_big['flash_attention_bf16']} launches; peak "
        f"{peak_a / 1e9:.2f} GB")
    del net, v_net, v_fn, x, x1, ctx, ctx_a
    torch.cuda.empty_cache()

    # a 2 + 2 block MMDiT at full width: kernel against the plain path
    g3 = torch.Generator(dev).manual_seed(7)
    cut = cfg._replace(n_double=2, n_single=2)
    m = MMDiT(cut, device=dev, dtype=bf, generator=g3).eval()
    perturb_zero_init_(m, g3)
    xs = torch.randn((b, cut.img_res, cut.img_res, cut.in_ch), generator=g3,
                     device=dev, dtype=bf)
    cs = {"txt": torch.randn((b, cut.txt_len, cut.txt_dim), generator=g3,
                             device=dev, dtype=bf),
          "vec": torch.randn((b, cut.vec_dim), generator=g3, device=dev,
                             dtype=bf)}
    tt = torch.rand((b,), generator=g3, device=dev).to(bf)
    with torch.no_grad():
        a = m(xs, tt, cs)
        m.cfg = cut._replace(use_pallas=False)
        p_ = m(xs, tt, cs)
    summary["mmdit_cut_rel_err"] = rel_err(a, p_)
    del m, a, p_
    torch.cuda.empty_cache()

    # a small MMDiT (head dim 128, f32): the card against the CPU
    small = MMDiTConfig(**FLUX_SMALL)
    g4 = torch.Generator().manual_seed(8)
    m_cpu = MMDiT(small, device="cpu", generator=g4).eval()
    perturb_zero_init_(m_cpu, g4)
    m_gpu = MMDiT(small, device=dev).eval()
    m_gpu.load_state_dict(m_cpu.state_dict())
    xs = torch.randn((2, 8, 8, 4), generator=g4)
    cs = {"txt": torch.randn((2, 16, 64), generator=g4),
          "vec": torch.randn((2, 64), generator=g4)}
    tt = torch.tensor([0.9, 0.2])
    with torch.no_grad():
        want = m_cpu(xs, tt, cs)
        got = m_gpu(xs.to(dev), tt.to(dev),
                    {k: v.to(dev) for k, v in cs.items()}).cpu()
    summary["mmdit_small_cpu_rel_err"] = rel_err(got, want)
    for name, tol in (("mmdit_cut_rel_err", BF16_TOL),
                      ("mmdit_small_cpu_rel_err", DIT_REL_TOL)):
        if not summary[name] <= tol:
            raise AssertionError(f"{name} = {summary[name]} > {tol}")
    log(f"[check] MMDiT 2 + 2 blocks at full width (bf16, B={b}) kernel "
        f"vs plain on the card: {summary['mmdit_cut_rel_err']:.2e} of scale "
        f"(tol {BF16_TOL}); small MMDiT (head dim 128, f32) card vs CPU: "
        f"{summary['mmdit_small_cpu_rel_err']:.2e} (tol {DIT_REL_TOL})")

    summary["gn_new_shapes"] = check_new_gn_shapes(gn_fast, dev)
    row = check_flash_attention_bf16(torch.Generator().manual_seed(9), dev)
    counts = {k: c_fast[k] + c_big[k] for k in c_fast}
    return counts, summary, row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=8,
                    help="requests drained under score routing (8 more "
                    "follow under centroid routing)")
    ap.add_argument("--out", default=None,
                    help="also write every measurement as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="add a score-routed drain of 16 fresh requests "
                    "and a repeat of the step-level drive under "
                    "torch.profiler (device busy time, top kernels)")
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from the root of a checkout "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false — this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 3
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    t_all = time.perf_counter()
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    log(f"[card] float flags as PyTorch starts: "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"[build] nvcc sm_90a, in parallel: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items())
        + f" (wall {time.perf_counter() - t0:.1f}s)")
    for name in _build.SOURCES:
        for fn, info in ptxas_summary(_build.build_log(name)):
            log(f"[build] {name}: {fn}: {info}")
    log(f"[build] {tensor_core_check(_build)}")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rows = run_kernel_checks(dev)
    system, backend, launches, summary, record = run_serve(
        dev, args.requests, profile=args.profile)
    flags = dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                 cudnn=torch.backends.cudnn.allow_tf32)
    log(f"[card] float flags as the port leaves them (DiffusionBackend on "
        f"the card): cuda.matmul.allow_tf32={flags['matmul']}, "
        f"cudnn.allow_tf32={flags['cudnn']}")
    if any(flags.values()):
        raise AssertionError("the port left TF32 on")
    summary["tf32_flags"] = flags
    summary.update(check_against_references(system, backend, dev))
    summary.update(check_vaes(backend, dev))
    counts, summary["latent"] = run_latent_step_level(
        dev, backend, profile=args.profile)
    c_alone, summary["standalone"] = run_standalone(system, dev)
    with tempfile.TemporaryDirectory() as workdir:
        c_faults, summary["faults"] = run_faults(dev, backend,
                                                 Path(workdir))
        c_front, summary["frontdoor"] = run_frontdoor(dev, backend,
                                                      Path(workdir))
        summary["mesh_scans"] = run_mesh_scans(dev)
        c_mesh, summary["mesh"] = run_mesh_serve(
            dev, backend, record, args.requests, Path(workdir))
    t_flux = time.perf_counter()
    c_flux, summary["flux"], fa_bf16 = run_flux(dev)
    rows.insert(3, fa_bf16)             # after the f32 flash_attention row
    summary["flux"]["seconds"] = time.perf_counter() - t_flux
    log(f"[flux] phase took {summary['flux']['seconds']:.1f} s")
    for c in counts + (c_alone,) + c_faults + c_front + (c_mesh, c_flux):
        launches = {k: launches.get(k, 0) + c[k] for k in c}
    for r in rows:
        if launches[r["name"]] == 0:
            raise AssertionError(f"no main-path drive launched {r['name']}")
    ranking = rank_by_shape(dev)
    summary["scan_shapes"] = {str(k): v for k, v in
                              check_scan_shapes(dev).items()}
    one = one_launch_per_call(dev)
    log(f"[check] one kernel per call (CUDA graph of one call): "
        f"groupnorm_silu at {one['groupnorm_silu']} shapes; at every shape "
        f"the drives ran: vdb_topk_pernode at {one['vdb_topk_pernode']}, "
        f"vdb_topk_sharded (node-masked and global) at "
        f"{one['vdb_topk_sharded']}, vdb_topk at {one['vdb_topk']}")
    for name in ("vdb_topk_pernode", "vdb_topk_sharded", "vdb_topk"):
        if one[name] == 0:
            raise AssertionError(f"no drive shape of {name} to check")

    kernels_line = {"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces")}
        | {"launches": launches[r["name"]]}
        | {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms")}
        for r in rows]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(card=card, kernels=rows, launches=launches, serve=summary,
                 ranking=ranking, seconds=time.perf_counter() - t_all),
            indent=1,
            default=lambda o: o.item() if hasattr(o, "item") else str(o)))
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f}s")
    print(card)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
