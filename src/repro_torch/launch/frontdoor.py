"""Front-door load generator: N concurrent synthetic tenants, wall-clock;
the port of the JAX package's ``repro/launch/frontdoor.py``.

Where ``repro_torch.launch.serve --continuous`` replays ONE arrival process on
a virtual clock, this program runs the production shape end to end: it
builds the CacheGenius fleet, puts the async multi-tenant
:class:`~repro_torch.frontdoor.gateway.Gateway` in front of it, and launches
one asyncio CLIENT PER TENANT — each with its own arrival process from
``repro_torch.core.trace`` (Poisson and bursty generators alternate across
tenants), its own SLA tier, and optionally a token-bucket quota.  The
trace generators become one client among many.

Virtual trace seconds are mapped to wall seconds by ``--time-scale``
(0.01 ⇒ a 40 req/s trace offers 4000 req/s of wall pressure), so a CI
smoke finishes in seconds while still exercising real concurrency, real
queueing and the worker-thread group loop.

    PYTHONPATH=src python -m repro_torch.launch.frontdoor --tenants 3 \\
        --requests 60 --nodes 2 --time-scale 0.005
    PYTHONPATH=src python -m repro_torch.launch.frontdoor --tenants 3 \\
        --quota 20,10 --leave-node 1          # drain node 1 mid-run
    PYTHONPATH=src python -m repro_torch.launch.frontdoor --device cpu

The fleet's cluster index and scans run on ``--device``, the card by
default, as in ``repro_torch.launch.serve``; the CLI serves through the
render-based ``NullBackend``.
"""
from __future__ import annotations

import argparse
import asyncio
import time
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.trace import (RequestTrace, bursty_arrivals,
                                    poisson_arrivals)
from repro_torch.frontdoor import (BackpressureError, FileResultStore,
                                   Gateway, QuotaExceededError, ResultHandle)
from repro_torch.launch.serve import build_system
from repro_torch.runtime.serving import ServingEngine

TIER_CYCLE = ("premium", "standard", "batch")


def jain_fairness(values: Sequence[float]) -> float:
    """Jain's fairness index over per-tenant allocations: 1.0 = perfectly
    fair, 1/n = one tenant takes everything.  Empty/zero input -> 1.0."""
    x = np.asarray(list(values), np.float64)
    if x.size == 0 or float(np.sum(x * x)) == 0.0:
        return 1.0
    return float(np.sum(x) ** 2 / (x.size * np.sum(x * x)))


def tenant_arrivals(ti: int, reqs, rate: float, *, tier: str,
                    seed_base: int):
    """Tenant ``ti``'s arrival process — generators alternate so tenants
    are DISTINCT clients (even tenants Poisson, odd tenants bursty at
    the same mean rate)."""
    tenant = f"tenant{ti}"
    if ti % 2 == 0:
        return poisson_arrivals(reqs, rate, seed=101 + ti,
                                seed_base=seed_base, tenant=tenant,
                                tier=tier)
    burst = max(2, int(round(rate / 10)) or 2)
    return bursty_arrivals(reqs, burst_size=burst,
                           burst_gap=burst / max(rate, 1e-9),
                           seed_base=seed_base, tenant=tenant, tier=tier)


async def _client(gateway: Gateway, arrivals, time_scale: float,
                  t0: float, tally: Dict[str, int]) -> List[ResultHandle]:
    handles: List[ResultHandle] = []
    for a in arrivals:
        await asyncio.sleep(max(0.0, t0 + a.arrival_time * time_scale
                                - time.perf_counter()))
        try:
            handles.append(await gateway.submit_async(
                a.prompt, tenant=a.tenant, tier=a.tier, seed=a.seed,
                quality_tier=a.quality_tier or None))
        except QuotaExceededError:
            tally["quota"] = tally.get("quota", 0) + 1
        except BackpressureError:
            tally["backpressure"] = tally.get("backpressure", 0) + 1
    return handles


async def _drive(gateway: Gateway, processes, time_scale: float,
                 capacity_op, capacity_at: float):
    t0 = time.perf_counter()
    tallies = [dict() for _ in processes]
    tasks = [asyncio.create_task(_client(gateway, p, time_scale, t0, tl))
             for p, tl in zip(processes, tallies)]
    if capacity_op is not None:
        async def _cap():
            await asyncio.sleep(capacity_at * time_scale)
            capacity_op()
        tasks.append(asyncio.create_task(_cap()))
        handles_per_client = await asyncio.gather(*tasks)
        handles_per_client = handles_per_client[:-1]
    else:
        handles_per_client = await asyncio.gather(*tasks)
    # every accepted job must complete (graceful drain)
    for handles in handles_per_client:
        for h in handles:
            await h.wait_async()
    return handles_per_client, tallies


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--requests", type=int, default=60,
                    help="requests per tenant")
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--arrival-rate", type=float, default=40.0,
                    help="per-tenant offered load, requests per VIRTUAL "
                    "second (scaled to wall time by --time-scale)")
    ap.add_argument("--time-scale", type=float, default=0.005,
                    help="wall seconds per virtual trace second")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-depth", type=int, default=512,
                    help="admission-control bound on the queue")
    ap.add_argument("--quota", default=None,
                    help="per-tenant token bucket 'rate,burst' in "
                    "VIRTUAL req/s (applied to every tenant)")
    ap.add_argument("--store", default=None,
                    help="directory for the filesystem result store "
                    "(default: in-memory)")
    ap.add_argument("--leave-node", type=int, default=None,
                    help="gracefully drain this node mid-run")
    ap.add_argument("--join-node", action="store_true",
                    help="join a fresh node mid-run")
    ap.add_argument("--device", default="cuda",
                    help="where the K-means fit, the cluster index and "
                    "the node dbs' scans run")
    args = ap.parse_args(argv)
    if args.tenants < 1:
        ap.error("--tenants must be >= 1")
    if args.time_scale <= 0:
        ap.error("--time-scale must be > 0")

    system, _, _, _ = build_system(n_nodes=args.nodes,
                                   device=args.device)
    engine = ServingEngine(system, max_batch=args.max_batch)

    quotas = None
    if args.quota:
        rate, burst = (float(v) for v in args.quota.split(","))
        # virtual req/s -> wall req/s under the time scale
        quotas = {f"tenant{i}": (rate / args.time_scale, burst)
                  for i in range(args.tenants)}
    store = FileResultStore(args.store) if args.store else None
    gateway = Gateway(engine, max_depth=args.max_depth, quotas=quotas,
                      store=store)

    processes = []
    for ti in range(args.tenants):
        trace = RequestTrace(seed=11 + ti)
        reqs = list(trace.generate(args.requests))
        processes.append(tenant_arrivals(
            ti, reqs, args.arrival_rate,
            tier=TIER_CYCLE[ti % len(TIER_CYCLE)],
            seed_base=ti * args.requests))

    capacity_op = None
    if args.leave_node is not None:
        capacity_op = lambda: gateway.leave_node(args.leave_node)
    elif args.join_node:
        capacity_op = lambda: gateway.join_node()
    half = max(p[-1].arrival_time for p in processes) / 2

    t_start = time.perf_counter()
    with gateway:
        handles_per_client, tallies = asyncio.run(
            _drive(gateway, processes, args.time_scale, capacity_op, half))
    wall = time.perf_counter() - t_start

    st = gateway.stats()
    n_done = sum(len(h) for h in handles_per_client)
    print(f"tenants            : {args.tenants}  "
          f"(tiers {', '.join(TIER_CYCLE[i % len(TIER_CYCLE)] for i in range(args.tenants))})")
    print(f"accepted/served    : {st['accepted']}/{st['jobs_served']} in "
          f"{st['groups_served']} groups over {wall:.2f}s wall "
          f"({n_done / max(wall, 1e-9):.1f} done/s)")
    print(f"rejections         : quota {st['rejected_quota']}  "
          f"backpressure {st['rejected_backpressure']}  "
          f"escalations {st['escalations']}")
    if args.leave_node is not None:
        print(f"capacity           : node {args.leave_node} left mid-run "
              f"(accepted-job loss: "
              f"{st['accepted'] - st['jobs_served']})")
    if args.join_node:
        print(f"capacity           : node joined mid-run -> "
              f"{len(system.dbs)} nodes")
    print("per-tenant/tier    : (queue-delay, wall p50/p95 ms)")
    for (tenant, tier), s in st["per_tenant_tier"].items():
        print(f"  {tenant}/{tier:<9} n={s['n']:<4.0f} "
              f"qd {s['queue_delay_p50'] * 1e3:.2f}/"
              f"{s['queue_delay_p95'] * 1e3:.2f}  "
              f"wall {s['wall_p50'] * 1e3:.2f}/{s['wall_p95'] * 1e3:.2f}")
    served = [len(h) for h in handles_per_client]
    print(f"fairness (Jain)    : {jain_fairness(served):.3f} over "
          f"completed-per-tenant {served}")
    print(f"result store       : {st['stored_results']} results "
          f"({'fs:' + args.store if args.store else 'memory'})")
    # engine memory holds no pixels after offload
    assert all(c.result.image is None for c in engine.completed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
