"""CacheGenius serving CLI on the card — the port of the JAX
package's ``repro/launch/serve.py``.

Builds the edge fleet (N node VDBs via the K-means storage classifier
over a synthetic reference corpus, the cluster index on ``--device``),
replays a Zipf request trace through the staged pipeline — drained in
FIFO micro-batches, or with ``--continuous`` as a Poisson arrival
process (``ServingEngine.run``), at step granularity with
``--step-level`` — and prints the route mix, hit rate, Eq. 8 latency and
cost against always-full generation, queue delay and per-stage wall
times.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 300 --nodes 4
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --continuous --arrival-rate 50 --step-level --slot-capacity 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --continuous --fault-schedule chaos --journal-dir /tmp/j --tenants 3

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mesh-nodes 3

``--fault-schedule`` runs the trace under a scripted chaos schedule
(``repro_torch.faults``) and fails if any accepted job is lost;
``--journal-dir`` gives every node a durability journal, so a crashed
node rejoins with its replayed cache; ``--tenants`` splits the trace
across tagged tenants and prints their latency percentiles.
``--mesh-nodes N`` shards the cluster index over N devices: N cards on
``--device cuda`` (the run stops with exit code 2 where the process sees
fewer: the mesh never falls back to one device unseen), N CPU shards on
``--device cpu``; the results equal ``--mesh-nodes 1``'s.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.embeddings import ProxyClipEmbedder
from repro_torch.core.latency_model import CostModel, LatencyModel
from repro_torch.core.lcu import POLICIES
from repro_torch.core.policy import GenerationPolicy, Route
from repro_torch.core.storage_classifier import StorageClassifier
from repro_torch.core.system import CacheGenius, GenerationBackend
from repro_torch.core.trace import (RequestTrace, merge_arrivals,
                                    poisson_arrivals)
from repro_torch.core.vdb import BlobStore
from repro_torch.data.synthetic import make_corpus, render_caption
from repro_torch.faults import (FaultInjector, FaultSchedule,
                                attach_journals)
from repro_torch.faults.schedule import PRESETS as FAULT_PRESETS
from repro_torch.runtime.serving import ServingEngine


def build_system(*, n_nodes: int = 4, corpus_n: int = 600,
                 capacity_per_node: int = 400, policy=None,
                 eviction="LCU", use_scheduler=True,
                 use_prompt_optimizer=True, backend=None, seed=0,
                 node_speeds=None, routing: str = "score",
                 latent_depths=None, mesh_nodes: int = 1, res: int = 32,
                 device="cuda", mesh_devices=None):
    """Assemble the full CacheGenius stack over the synthetic corpus.

    Same arguments and behaviour as the JAX package's ``build_system``,
    plus ``res``, the corpus resolution (32 there; 256 feeds the
    full-size VAE), ``device``, where the K-means fit and the cluster
    index run, and ``mesh_devices``, the devices of a ``mesh_nodes``
    mesh (default: one card per shard, or CPU shards on the CPU; a card
    may repeat)."""
    images, captions, _ = make_corpus(corpus_n, res=res, seed=seed)
    embedder = ProxyClipEmbedder(render_caption)
    img_vecs = embedder.embed_image(images)
    txt_vecs = embedder.embed_text(captions)
    embedder.set_corpus_anchor(img_vecs)

    blob = BlobStore()
    payloads = np.array([blob.put(im) for im in images], np.int64)
    classifier = StorageClassifier(n_nodes, device=device)
    dbs = classifier.build_node_dbs(img_vecs, txt_vecs, payloads,
                                    capacity_per_node=capacity_per_node)
    if backend is None:
        backend = NullBackend(res=images.shape[1])
    base_speeds = [1.0, 1.0, 0.82, 0.45]   # 4090D/4090D/3090/2070S
    speeds = node_speeds or [base_speeds[i % len(base_speeds)]
                             for i in range(n_nodes)]
    system = CacheGenius(
        embedder=embedder, dbs=dbs, blob_store=blob, backend=backend,
        classifier=classifier, policy=policy or GenerationPolicy(),
        latency_model=LatencyModel(), cost_model=CostModel(),
        eviction=POLICIES[eviction], node_speeds=speeds,
        use_scheduler=use_scheduler,
        use_prompt_optimizer=use_prompt_optimizer, routing=routing,
        latent_depths=latent_depths, mesh_nodes=mesh_nodes, device=device,
        mesh_devices=mesh_devices)
    return system, embedder, images, captions


class NullBackend(GenerationBackend):
    """Render-based stand-in backend for routing experiments that need no
    model.  Deterministic per element (steps/seeds are ignored), so
    batched and sequential drains stay exactly comparable; the "latent"
    archived at every depth is the finished image itself."""

    supports_latent_resume = True

    def __init__(self, res: int):
        super().__init__()
        self.res = int(res)

    def txt2img_batch(self, prompts, steps, seeds):
        return np.stack([render_caption(p, res=self.res) for p in prompts])

    def img2img_batch(self, prompts, references, steps, seeds):
        out = []
        for p, ref in zip(prompts, references):
            target = render_caption(p, res=self.res)
            out.append(0.75 * target
                       + 0.25 * ref[: target.shape[0], : target.shape[1]])
        return np.stack(out)

    def archive_latents_batch(self, images, seeds, depths, steps_total):
        return np.stack([np.asarray(images)] * len(depths))

    def resume_batch(self, prompts, latents, steps_total, k, seeds):
        return self.img2img_batch(prompts, latents, steps_total - k, seeds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=300)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--eviction", default="LCU", choices=sorted(POLICIES))
    ap.add_argument("--no-scheduler", action="store_true")
    ap.add_argument("--routing", default="score",
                    choices=("score", "centroid"),
                    help="'score' routes on each node's true best composite "
                    "match from the fused cluster scan; 'centroid' is the "
                    "Eq. 6 node-representation baseline")
    ap.add_argument("--no-prompt-optimizer", action="store_true")
    ap.add_argument("--latent-cache", action="store_true",
                    help="archive latents alongside finished images "
                    "(policy default depths)")
    ap.add_argument("--latent-depths", default=None,
                    help="comma-separated resume depths (implies "
                    "--latent-cache)")
    ap.add_argument("--fail-node", type=int, default=None,
                    help="kill node N after half the requests")
    ap.add_argument("--max-batch", "--batch", dest="max_batch", type=int,
                    default=8, help="engine micro-batch size")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over a Poisson arrival "
                    "process (ServingEngine.run) instead of the "
                    "submit-everything-then-drain loop")
    ap.add_argument("--arrival-rate", type=float, default=50.0,
                    help="offered load for --continuous, requests/second "
                    "on the virtual serving clock")
    ap.add_argument("--step-level", action="store_true",
                    help="with --continuous: admit arrivals at any "
                    "denoising-step boundary through a slot engine; prints "
                    "slot-occupancy p50/p95")
    ap.add_argument("--slot-capacity", type=int, default=None,
                    help="slot-buffer capacity for --step-level "
                    "(default: --max-batch)")
    ap.add_argument("--device", default="cuda",
                    help="where the K-means fit, the cluster index and "
                    "the node dbs' scans run")
    ap.add_argument("--mesh-nodes", type=int, default=1,
                    help="shard the cluster index's cache slabs over this "
                    "many devices (one card each on --device cuda, CPU "
                    "shards on --device cpu); scan results stay bitwise "
                    "identical to one device")
    ap.add_argument("--fault-schedule", default=None,
                    choices=sorted(FAULT_PRESETS),
                    help="with --continuous: run under a scripted chaos "
                    "schedule (repro_torch.faults preset, scaled to the "
                    "fleet and trace), print the injector's audit report, "
                    "and exit nonzero if ANY accepted job is lost")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for the fault schedule's deterministic "
                    "random draws (which blobs corrupt, etc.)")
    ap.add_argument("--journal-dir", default=None,
                    help="attach a per-node cache durability journal "
                    "(WAL + snapshots) under this directory; crashed "
                    "nodes in a --fault-schedule run then rejoin with "
                    "their journal-replayed cache instead of cold")
    ap.add_argument("--tenants", type=int, default=0,
                    help="with --continuous: split the trace round-robin "
                    "across N tagged tenants (tiers cycle premium/"
                    "standard/batch), merge their Poisson processes "
                    "deterministically, and print per-tenant/tier "
                    "queue-delay + wall percentiles")
    args = ap.parse_args(argv)
    if args.max_batch < 1:
        ap.error("--max-batch must be >= 1")
    if args.arrival_rate <= 0:
        ap.error("--arrival-rate must be > 0")
    if args.tenants < 0:
        ap.error("--tenants must be >= 0")
    if args.tenants > 1 and not args.continuous:
        ap.error("--tenants requires --continuous")
    if args.step_level and not args.continuous:
        ap.error("--step-level requires --continuous")
    if args.fault_schedule is not None and not args.continuous:
        ap.error("--fault-schedule requires --continuous")
    if args.fault_schedule is not None and args.fail_node is not None:
        ap.error("--fault-schedule already scripts failures; "
                 "drop --fail-node")
    if args.slot_capacity is not None and not args.step_level:
        ap.error("--slot-capacity requires --step-level")
    if args.slot_capacity is not None and args.slot_capacity < 1:
        ap.error("--slot-capacity must be >= 1")
    if args.mesh_nodes < 1:
        ap.error("--mesh-nodes must be >= 1")
    if args.mesh_nodes > 1 and torch.device(args.device).type == "cuda" \
            and torch.cuda.device_count() < args.mesh_nodes:
        ap.error(f"--mesh-nodes {args.mesh_nodes} needs that many cards, "
                 f"the process sees {torch.cuda.device_count()}")

    if args.latent_depths is not None:
        latent_depths = tuple(int(d) for d in args.latent_depths.split(","))
    elif args.latent_cache:
        latent_depths = True
    else:
        latent_depths = None
    system, _, _, _ = build_system(
        n_nodes=args.nodes, eviction=args.eviction,
        use_scheduler=not args.no_scheduler,
        use_prompt_optimizer=not args.no_prompt_optimizer,
        routing=args.routing, latent_depths=latent_depths,
        mesh_nodes=args.mesh_nodes, device=args.device)
    engine = ServingEngine(system, max_batch=args.max_batch)

    journals = (attach_journals(system, args.journal_dir)
                if args.journal_dir is not None else None)
    injector = None
    if args.fault_schedule is not None:
        # horizon = injection boundaries the run will see: every
        # denoising step in step-level mode, every admission group
        # otherwise (events land at fixed fractions of it)
        horizon = (args.requests if args.step_level
                   else max(10, args.requests // args.max_batch))
        schedule = FaultSchedule.preset(
            args.fault_schedule, nodes=args.nodes, horizon=horizon,
            seed=args.fault_seed)
        injector = FaultInjector(system, schedule, journals=journals)

    reqs = list(RequestTrace(seed=1).generate(args.requests))
    half = len(reqs) // 2
    occupancy = []
    if args.continuous:
        if args.tenants > 1:
            # one client among many: each tenant is its own tagged
            # Poisson process, interleaved deterministically
            tier_cycle = ("premium", "standard", "batch")
            procs, offset = [], 0
            for ti in range(args.tenants):
                chunk = reqs[ti::args.tenants]
                procs.append(poisson_arrivals(
                    chunk, args.arrival_rate / args.tenants, seed=1 + ti,
                    seed_base=offset, tenant=f"tenant{ti}",
                    tier=tier_cycle[ti % len(tier_cycle)]))
                offset += len(chunk)
            arrivals = merge_arrivals(*procs)
        else:
            arrivals = poisson_arrivals(reqs, args.arrival_rate, seed=1)
        step_kw = (dict(step_level=True, slot_capacity=args.slot_capacity)
                   if args.step_level else {})
        if injector is not None:
            step_kw["on_step"] = injector.on_step
        if args.fail_node is not None:
            done = engine.run(arrivals[:half], **step_kw)
            occupancy += engine.slot_occupancy
            print(f"--- failing node {args.fail_node} ---")
            engine.fail_node(args.fail_node)
            # resume on the same timeline: backlog carries over
            done += engine.run(
                arrivals[half:],
                start=max((c.finished_at for c in done), default=0.0),
                **step_kw)
            occupancy += engine.slot_occupancy
        else:
            done = engine.run(arrivals, **step_kw)
            occupancy = list(engine.slot_occupancy)
    else:
        for i, r in enumerate(reqs):
            if args.fail_node is not None and i == half:
                print(f"--- failing node {args.fail_node} ---")
                engine.fail_node(args.fail_node)
            engine.submit(r.prompt, seed=i, quality_tier=r.quality_tier)
        done = engine.drain()

    st = system.stats
    lat = np.array(st.latencies)
    full_latency = system.latency_model.latency(
        Route.TXT2IMG, system.policy.steps_full)
    base_cost = CostModel()
    for _ in range(st.requests):
        base_cost.charge(0, system.policy.steps_full
                         * system.latency_model.t_step)
    print(f"requests           : {st.requests}")
    print(f"routing            : {args.routing}"
          + ("" if not args.no_scheduler else " (scheduler disabled)"))
    ci = system.cluster_index
    if ci is not None and ci.mesh is not None:
        print(f"cluster mesh       : {ci.mesh_nodes} shards on "
              f"{', '.join(str(d) for d in ci.mesh.devices)} "
              f"({ci.n_nodes} nodes padded to {ci.padded_nodes}); "
              f"{ci.stats['allgather_bytes']} bytes of lists gathered")
    print(f"route mix          : {st.route_counts}")
    print(f"hit rate           : {st.hit_rate:.3f}")
    print(f"mean steps/request : {st.mean_steps:.2f}"
          + (f"   (latent resumes: {st.latent_resumes}, depths "
             f"{system.latent_depths})" if system.latent_depths else ""))
    print(f"mean latency (Eq.8): {lat.mean():.3f}s   "
          f"p50 {np.percentile(lat, 50):.3f}  p95 {np.percentile(lat, 95):.3f}")
    wall = np.array(st.wall_latencies)
    print(f"wall latency       : mean {wall.mean() * 1e3:.2f}ms   "
          f"p50 {np.percentile(wall, 50) * 1e3:.2f}ms  "
          f"p95 {np.percentile(wall, 95) * 1e3:.2f}ms  "
          f"(batch-amortised, max_batch={args.max_batch}, "
          f"{len(st.batch_wall_latencies)} micro-batches, "
          f"total {sum(st.batch_wall_latencies):.2f}s)")
    print(f"vs always-full     : {full_latency:.3f}s  "
          f"(reduction {100 * (1 - lat.mean() / full_latency):.1f}%)")
    cost = system.cost_model.total_cost()
    base = base_cost.total_cost()
    print(f"cost               : ${cost:.4f} vs ${base:.4f} "
          f"(reduction {100 * (1 - cost / max(base, 1e-12)):.1f}%)")
    qd = np.array([c.queue_delay for c in done])
    mode = (f"continuous, {args.arrival_rate:g} req/s offered"
            if args.continuous else "drain path, actual wait")
    if args.step_level:
        mode = "step-level " + mode
    print(f"queue delay        : mean {qd.mean() * 1e3:.2f}ms   "
          f"p50 {np.percentile(qd, 50) * 1e3:.2f}ms  "
          f"p95 {np.percentile(qd, 95) * 1e3:.2f}ms  ({mode})")
    if args.step_level and occupancy:
        occ = np.array(occupancy)
        cap = args.slot_capacity or args.max_batch
        print(f"slot occupancy     : p50 {np.percentile(occ, 50):.0f}  "
              f"p95 {np.percentile(occ, 95):.0f}  of {cap} slots  "
              f"({len(occ)} step launches)")
    walls = {}
    for c in done:
        for name, w in c.result.stage_walls.items():
            walls.setdefault(name, []).append(w)
    print("stage walls        : " + "  ".join(
        f"{name} {np.percentile(v, 50) * 1e3:.1f}/"
        f"{np.percentile(v, 95) * 1e3:.1f}ms" for name, v in walls.items()))
    tagged = engine.tagged_stats()
    if tagged:
        print("per-tenant/tier    : (queue-delay, wall p50/p95 ms)")
        for (tenant, tier), s in tagged.items():
            print(f"  {tenant or '-'}/{tier or '-':<9} n={s['n']:<4.0f} "
                  f"qd {s['queue_delay_p50'] * 1e3:.2f}/"
                  f"{s['queue_delay_p95'] * 1e3:.2f}  "
                  f"wall {s['wall_p50'] * 1e3:.2f}/"
                  f"{s['wall_p95'] * 1e3:.2f}")
    if injector is not None:
        injector.finish()
        rep = injector.report()
        print(f"chaos schedule     : {args.fault_schedule} "
              f"(seed {args.fault_seed}, {rep['steps_seen']} injection "
              f"boundaries seen)")
        print(f"chaos actions      : {rep['actions']}")
        print(f"chaos absorbed     : "
              f"transient_retries={rep['transient_retries']}  "
              f"corrupt_hits={rep['corrupt_hits']}  "
              f"degraded_serves={rep['degraded_serves']}")
        lost = len(reqs) - len(done)
        if lost or any(c.result.image is None for c in done):
            print(f"CHAOS FAIL         : {lost} accepted jobs lost")
            return 1
        print("chaos invariant    : zero accepted-job loss")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
