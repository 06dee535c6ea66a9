"""The front door, the port against the JAX package, on the CPU.

* Queue: the same seeded sequence of submissions and dequeues gives the
  reference's ``next_batch`` order, rejections and counters — tiers,
  deadline escalation, weighted fair share, token-bucket quotas and
  backpressure.
* Result stores: a ``FileResultStore`` directory written by one package
  reads in the other; handles resolve and fail as the reference's.
* ``tenant_tier_stats`` equals the reference's on the same completions.
* Gateway: the worker-thread dispatcher's results equal a direct
  ``ServingEngine.run`` of the merged trace, the port's and the
  reference's; graceful leave, backpressure, hung-stop warnings and
  transient group retries behave as in the reference.
* The CLIs: the port's serve CLI with ``--fault-schedule chaos
  --journal-dir --tenants 3 --continuous --device cpu`` and
  ``repro_torch.launch.frontdoor --device cpu`` run to the end.

Every thread wait has a timeout.  Exact comparisons throughout: the
fleet runs the render-based NullBackend."""
from __future__ import annotations

import asyncio
import contextlib
import io
import threading

import numpy as np
import pytest

from repro.core.trace import trace_arrivals as jtrace_arrivals
from repro.frontdoor import (FileResultStore as JFileStore,
                             FrontDoorQueue as JQueue, Job as JJob,
                             QuotaExceededError as JQuota,
                             BackpressureError as JBackpressure,
                             TokenBucket as JBucket)
from repro.launch.frontdoor import jain_fairness as jjain
from repro.launch.frontdoor import tenant_arrivals as jtenant_arrivals
from repro.launch.serve import build_system as jbuild
from repro.runtime.serving import Completed as JCompleted
from repro.runtime.serving import Request as JRequest
from repro.runtime.serving import ServingEngine as JEngine
from repro.runtime.serving import tenant_tier_stats as jstats
from repro_torch.core.pipeline import TransientBackendError
from repro_torch.core.system import ServeResult
from repro_torch.core.policy import Route
from repro_torch.core.trace import (RequestTrace, merge_arrivals,
                                    trace_arrivals)
from repro_torch.data.synthetic import all_specs, caption_of
from repro_torch.faults import FlakyBackend
from repro_torch.frontdoor import (BackpressureError, DEFAULT_TIERS,
                                   FileResultStore, FrontDoorQueue,
                                   Gateway, GatewayClosedError, Job,
                                   MemoryResultStore, QuotaExceededError,
                                   ResultHandle, TierSpec, TokenBucket)
from repro_torch.launch import frontdoor as tfrontdoor
from repro_torch.launch import serve as tserve
from repro_torch.launch.frontdoor import jain_fairness, tenant_arrivals
from repro_torch.launch.serve import build_system
from repro_torch.runtime.serving import (Completed, Request, ServingEngine,
                                         tenant_tier_stats)

WAIT = 120                     # seconds any one handle or join may take


@contextlib.contextmanager
def _serving(gw):
    """``gw`` started, then closed with a bounded join: the worker must
    have stopped when the block ends."""
    gw.start()
    try:
        yield gw
    finally:
        gw.close(timeout=WAIT)
    assert not gw.dispatcher.running


# ---------------------------------------------------------------------------
# the queue: same operations, same order
# ---------------------------------------------------------------------------


def _queue_script(seed: int, n_ops: int = 300):
    """A seeded script of submissions and dequeues on a clock that jumps
    far enough for escalations (standard after 4 s, batch after 30 s)
    and token refills to happen."""
    rng = np.random.default_rng(seed)
    tenants = [f"t{i}" for i in range(4)]
    ops, now = [], 0.0
    for i in range(n_ops):
        now += float(rng.exponential(0.6))
        if rng.random() < 0.65:
            ops.append(("submit", now, tenants[int(rng.integers(4))],
                        ("premium", "standard", "batch", "bogus")[
                            int(rng.choice(4, p=[0.2, 0.4, 0.38, 0.02]))],
                        f"p{i}"))
        else:
            ops.append(("next", now, int(rng.integers(0, 6))))
    return ops


def _play(script, queue_cls, job_cls, bucket_cls, quota_err, bp_err, *,
          fair, weights):
    q = queue_cls(max_depth=24, fair=fair, tenant_weights=weights,
                  quotas={"t1": bucket_cls(rate=0.8, burst=3),
                          "t3": bucket_cls(rate=2.0, burst=1)})
    out = []
    for op in script:
        if op[0] == "submit":
            _, now, tenant, tier, prompt = op
            try:
                q.submit(job_cls(tenant=tenant, tier=tier, prompt=prompt,
                                 seed=0), now=now)
                out.append(("ok", prompt))
            except quota_err as e:
                out.append(("quota", prompt, e.retry_after, e.depth))
            except bp_err as e:
                out.append(("full", prompt, e.depth, e.bound))
            except ValueError:
                out.append(("tier", prompt))
        else:
            _, now, n = op
            out.append(("batch", [(j.prompt, j.tenant, j.tier,
                                   j.effective_tier, j.escalations,
                                   j.submitted_at, j.deadline)
                                  for j in q.next_batch(n, now=now)]))
    s = q.stats
    return out, (s.accepted, s.dispatched, s.rejected_quota,
                 s.rejected_backpressure, s.escalations,
                 dict(s.accepted_by_tenant), dict(s.rejected_by_tenant),
                 q.depth_by_tenant(), len(q))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("fair,weights", [(True, None),
                                          (True, {"t0": 3.0, "t2": 0.5}),
                                          (False, None)])
def test_queue_order_equals_jax(seed, fair, weights):
    script = _queue_script(seed)
    got = _play(script, FrontDoorQueue, Job, TokenBucket,
                QuotaExceededError, BackpressureError, fair=fair,
                weights=weights)
    want = _play(script, JQueue, JJob, JBucket, JQuota, JBackpressure,
                 fair=fair, weights=weights)
    assert got == want
    kinds = {o[0] for o in got[0]}
    assert {"ok", "quota", "batch"} <= kinds        # the script bites
    assert got[1][4] > 0                            # escalations happened


def test_queue_typed_errors_and_validation():
    q = FrontDoorQueue(max_depth=2, quotas={"t0": TokenBucket(1.0, 2)})
    q.submit(Job(tenant="t0", tier="standard", prompt="a", seed=0), now=0)
    q.submit(Job(tenant="t0", tier="standard", prompt="b", seed=0), now=0)
    with pytest.raises(BackpressureError) as ei:
        q.submit(Job(tenant="o", tier="standard", prompt="c", seed=0),
                 now=0)
    assert not isinstance(ei.value, QuotaExceededError)
    q.next_batch(2, now=0.0)
    with pytest.raises(QuotaExceededError) as ei:
        q.submit(Job(tenant="t0", tier="standard", prompt="d", seed=0),
                 now=0)
    assert ei.value.retry_after == pytest.approx(1.0)
    with pytest.raises(ValueError):
        FrontDoorQueue(tiers=(TierSpec("a", 0, 1.0), TierSpec("b", 2, 1.0)))
    with pytest.raises(ValueError):
        FrontDoorQueue(max_depth=0)
    with pytest.raises(ValueError):
        TokenBucket(rate=0.0, burst=1.0)
    assert [t.name for t in DEFAULT_TIERS] == ["premium", "standard",
                                               "batch"]


# ---------------------------------------------------------------------------
# result stores, handles, small helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_file_result_store_reads_across_packages(tmp_path, writer):
    w_cls, r_cls = ((JFileStore, FileResultStore) if writer == "jax"
                    else (FileResultStore, JFileStore))
    w = w_cls(str(tmp_path))
    img = np.random.default_rng(0).standard_normal((4, 4, 3)).astype(
        np.float32)
    refs = [w.put(7, img, {"tenant": "t0", "tier": "premium",
                           "score": 0.5, "node": 2}),
            w.put(8, img * 2)]
    r = r_cls(str(tmp_path))
    assert len(w) == 2 and len(r) == 0       # counts its own puts
    assert refs[0].endswith("7.npy")
    np.testing.assert_array_equal(r.get(refs[0]), img)
    np.testing.assert_array_equal(r.get(refs[1]), img * 2)
    assert r.meta(refs[0]) == {"tenant": "t0", "tier": "premium",
                               "score": 0.5, "node": 2}
    assert r.meta(refs[1]) == {}


def test_memory_store_and_handles():
    store = MemoryResultStore()
    img = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
    ref = store.put(7, img, {"k": "v"})
    assert ref == "mem:7" and len(store) == 1
    h = ResultHandle(7, store)
    assert not h.done() and h.ref is None
    h._resolve(ref, {"k": "v"})
    assert h.done() and h.wait(0.1) == ref and h.meta == {"k": "v"}
    np.testing.assert_array_equal(h.image(), img)
    assert asyncio.run(h.wait_async()) == ref
    h2 = ResultHandle(8, store)
    h2._fail(GatewayClosedError("closed"))
    with pytest.raises(GatewayClosedError):
        h2.wait(0.1)


def test_jain_fairness_and_tenant_arrivals_equal_jax():
    for v in ([5, 5, 5, 5], [10, 0, 0, 0], [], [0, 0], [3, 1, 4, 1, 5]):
        assert jain_fairness(v) == jjain(v)
    assert jain_fairness([10, 0, 0, 0]) == pytest.approx(0.25)
    from repro.core.trace import RequestTrace as JRequestTrace
    reqs = list(RequestTrace(seed=4).generate(12))
    jreqs = list(JRequestTrace(seed=4).generate(12))
    for ti in range(3):
        got = tenant_arrivals(ti, reqs, 40.0, tier="standard",
                              seed_base=ti * 12)
        want = jtenant_arrivals(ti, jreqs, 40.0, tier="standard",
                                seed_base=ti * 12)
        assert [(a.prompt, a.seed, a.arrival_time, a.tenant, a.tier,
                 a.quality_tier) for a in got] == \
            [(a.prompt, a.seed, a.arrival_time, a.tenant, a.tier,
              a.quality_tier) for a in want]


def _completions(request_cls, completed_cls, result_for, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):
        tenant = (None, "a", "b", "c")[int(rng.integers(4))]
        tier = (None, "premium", "batch")[int(rng.integers(3))]
        wall_total = float(rng.choice([0.0, rng.exponential(0.02)]))
        out.append(completed_cls(
            request_cls(f"p{i}", i, tenant=tenant, tier=tier),
            result_for(float(rng.exponential(0.05)), wall_total),
            float(rng.exponential(0.01))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tenant_tier_stats_equal_jax(seed):
    from repro.core.policy import Route as JRoute
    from repro.core.system import ServeResult as JServeResult

    def port_result(wall_latency, wall_total):
        return ServeResult(image=None, route=Route.TXT2IMG, score=0.0,
                           node=0, steps=0, latency=0.0,
                           wall_latency=wall_latency, wall_total=wall_total)

    def jax_result(wall_latency, wall_total):
        return JServeResult(image=None, route=JRoute.TXT2IMG, score=0.0,
                            node=0, steps=0, latency=0.0,
                            wall_latency=wall_latency,
                            wall_total=wall_total)
    got = tenant_tier_stats(_completions(Request, Completed, port_result,
                                         seed))
    want = jstats(_completions(JRequest, JCompleted, jax_result, seed))
    assert got and got == want
    assert tenant_tier_stats([]) == {}


# ---------------------------------------------------------------------------
# the gateway over a real fleet
# ---------------------------------------------------------------------------


def _system(build=build_system, n_nodes=2, **kw):
    if build is build_system:
        kw.setdefault("device", "cpu")
    system, _, _, _ = build(n_nodes=n_nodes, corpus_n=60,
                            capacity_per_node=80, seed=0, **kw)
    return system


_PROMPTS = [caption_of(s) for s in all_specs()]


def _submit_wave(gw, n, *, tenant="t0", tier="standard", base_seed=0):
    return [gw.submit(_PROMPTS[(base_seed + i) % len(_PROMPTS)],
                      tenant=tenant, tier=tier, seed=base_seed + i)
            for i in range(n)]


def _merged(n, tseed, jax_side=False):
    if jax_side:
        from repro.core.trace import RequestTrace as JRequestTrace
    arrivals = jtrace_arrivals if jax_side else trace_arrivals
    reqs = list((JRequestTrace if jax_side else RequestTrace)(
        seed=tseed).generate(n))
    zeros = [0.0] * (n // 2)
    procs = (arrivals(reqs[:n // 2], zeros, tenant="a", tier="standard"),
             arrivals(reqs[n // 2:], zeros, tenant="b", tier="standard",
                      seed_base=n // 2))
    if jax_side:
        from repro.core.trace import merge_arrivals as jmerge
        return jmerge(*procs)
    return merge_arrivals(*procs)


@pytest.mark.parametrize("store", ["memory", "file"])
def test_gateway_equals_direct_run_and_jax(tmp_path, store):
    """Jobs submitted before ``start`` with FIFO dequeue: the gateway's
    groups are the direct run's, so every image, route and node equals a
    direct ``ServingEngine.run`` of the merged trace — the port's and the
    reference's."""
    n = 16
    merged = _merged(n, 3)
    direct = ServingEngine(_system(), max_batch=4)
    direct_done = direct.run(merged)
    j_direct = JEngine(_system(jbuild), max_batch=4).run(
        _merged(n, 3, jax_side=True))

    gw = Gateway(ServingEngine(_system(), max_batch=4), fair=False,
                 store=(FileResultStore(str(tmp_path)) if store == "file"
                        else None))
    handles = [gw.submit(r.prompt, tenant=r.tenant, tier=r.tier,
                         seed=r.seed, quality_tier=r.quality_tier)
               for r in merged]
    with _serving(gw):
        for h in handles:
            h.wait(timeout=WAIT)
    assert [c.request.prompt for c in j_direct] == [r.prompt
                                                     for r in merged]
    for h, comp, jcomp in zip(handles, direct_done, j_direct):
        assert jcomp.request.quality_tier == comp.request.quality_tier
        np.testing.assert_array_equal(h.image(), comp.result.image)
        np.testing.assert_array_equal(h.image(), jcomp.result.image)
        route = comp.result.fast_path or comp.result.route.value
        assert h.meta["route"] == route == (jcomp.result.fast_path
                                            or jcomp.result.route.value)
        assert h.meta["node"] == comp.result.node == jcomp.result.node
        assert (h.meta["tenant"], h.meta["tier"]) == (comp.request.tenant,
                                                      "standard")
    for eng in (direct, gw.engine):
        tagged = tenant_tier_stats(eng.completed)
        assert set(tagged) == {("a", "standard"), ("b", "standard")}
        assert all(s["n"] == n // 2 for s in tagged.values())
    # the engine keeps no pixels once the store owns them
    assert all(c.result.image is None for c in gw.engine.completed)
    st = gw.stats()
    assert st["accepted"] == st["jobs_served"] == st["stored_results"] == n


def test_node_leave_mid_run_zero_accepted_job_loss():
    system = _system(n_nodes=3)
    gw = Gateway(ServingEngine(system, max_batch=4))
    with _serving(gw):
        first = _submit_wave(gw, 8)
        for h in first:
            h.wait(timeout=WAIT)
        gw.leave_node(1)
        second = _submit_wave(gw, 12, base_seed=100)
        for h in second:
            h.wait(timeout=WAIT)
    st = gw.stats()
    assert st["accepted"] == st["jobs_served"] == 20
    assert all(h.meta["node"] != 1 for h in second)
    assert any(h.meta["node"] in (0, 2) for h in second)


def test_node_join_mid_run_grows_fleet():
    system = _system(n_nodes=2)
    gw = Gateway(ServingEngine(system, max_batch=4))
    with _serving(gw):
        for h in _submit_wave(gw, 4):
            h.wait(timeout=WAIT)
        gw.join_node(speed=50.0)
        second = _submit_wave(gw, 8, tenant="t1", base_seed=100)
        for h in second:
            h.wait(timeout=WAIT)
    assert len(system.dbs) == 3 and system.cluster_index.n_nodes == 3
    assert system.scheduler.nodes[2].speed == 50.0
    st = gw.stats()
    assert st["accepted"] == st["jobs_served"] == 12


def test_premium_tier_maps_to_priority_fast_path():
    system = _system(n_nodes=2)
    gw = Gateway(ServingEngine(system, max_batch=2))
    with _serving(gw):
        gw.submit(_PROMPTS[3], tenant="t0", tier="premium",
                  seed=0).wait(timeout=WAIT)
        sched = system.scheduler
        sched.invalidate_payloads(list(sched._hist_payloads))
        repeat = gw.submit(_PROMPTS[3], tenant="t0", tier="premium", seed=1)
        plain = gw.submit(_PROMPTS[3], tenant="t0", tier="standard",
                          seed=2)
        repeat.wait(timeout=WAIT)
        plain.wait(timeout=WAIT)
    assert repeat.meta["route"] == "priority"
    assert plain.meta["route"] != "priority"


def test_gateway_backpressure_and_no_drain_close():
    gw = Gateway(ServingEngine(_system(), max_batch=4), max_depth=3)
    handles = _submit_wave(gw, 3)
    with pytest.raises(BackpressureError):
        gw.submit("overflow", tenant="t0")
    gw.start()
    gw.close(drain=False, timeout=WAIT)
    assert not gw.dispatcher.running
    failed = 0
    for h in handles:
        try:
            h.wait(timeout=5)
        except GatewayClosedError:
            failed += 1
    assert failed + gw.stats()["jobs_served"] == 3


class _GatedBackend:
    """Delegating backend whose generation calls block on an event, to
    hold the dispatcher mid-group."""

    def __init__(self, inner):
        self._inner = inner
        self.gate = threading.Event()
        self.entered = threading.Event()

    def _wait(self):
        self.entered.set()
        assert self.gate.wait(timeout=WAIT)

    def txt2img_batch(self, *a, **kw):
        self._wait()
        return self._inner.txt2img_batch(*a, **kw)

    def img2img_batch(self, *a, **kw):
        self._wait()
        return self._inner.img2img_batch(*a, **kw)

    def resume_batch(self, *a, **kw):
        self._wait()
        return self._inner.resume_batch(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_stop_timeout_warns_and_keeps_thread_handle():
    system = _system()
    backend = _GatedBackend(system.backend)
    system.backend = backend
    gw = Gateway(ServingEngine(system, max_batch=2))
    gw.start()
    h = gw.submit("a never-cached prompt to force generation", seed=0)
    assert backend.entered.wait(timeout=WAIT)
    with pytest.warns(RuntimeWarning, match="did not stop"):
        gw.close(timeout=0.05)
    assert gw.dispatcher.running
    backend.gate.set()
    gw.close(timeout=WAIT)
    assert not gw.dispatcher.running and gw.dispatcher._thread is None
    assert h.done()


@pytest.mark.parametrize("armed,retries,served", [(1, 3, True),
                                                  (10**6, 2, False)])
def test_transient_group_failure_retries(armed, retries, served):
    """A group that dies of a transient fault is retried at the
    dispatcher with backoff; past the budget its handles fail typed."""
    system = _system()
    system.transient_retries = 0
    system.backend = FlakyBackend(system.backend)
    gw = Gateway(ServingEngine(system, max_batch=2))
    gw.dispatcher.max_group_retries = retries
    gw.dispatcher.retry_backoff = 0.001
    system.backend.arm(armed)
    with _serving(gw):
        h = gw.submit("transient-retry probe prompt", seed=0)
        if served:
            assert h.image() is not None
        else:
            with pytest.raises(TransientBackendError):
                h.wait(timeout=WAIT)
    assert system.backend.faults_injected == (1 if served else retries + 1)
    assert gw.stats()["jobs_served"] == (1 if served else 0)


def test_dispatcher_device_scope_follows_the_backend():
    gw = Gateway(ServingEngine(_system(), max_batch=2))
    assert isinstance(gw.dispatcher._device_scope(),
                      contextlib.nullcontext)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def _run_cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("step_level", [False, True])
def test_serve_cli_chaos_journals_tenants(tmp_path, step_level):
    argv = ["--device", "cpu", "--requests", "40", "--nodes", "3",
            "--continuous", "--fault-schedule", "chaos", "--journal-dir",
            str(tmp_path), "--tenants", "3"]
    if step_level:
        argv += ["--step-level", "--slot-capacity", "4"]
    rc, out = _run_cli(tserve.main, argv)
    assert rc == 0, out
    assert "chaos invariant    : zero accepted-job loss" in out
    assert "'rejoin-journaled': 1" in out
    for ti, tier in enumerate(("premium", "standard", "batch")):
        assert f"tenant{ti}/{tier}" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["node0", "node1",
                                                          "node2"]


def test_serve_cli_checks_the_new_flags():
    for argv, msg in (
            (["--tenants", "-1"], "must be >= 0"),
            (["--continuous", "--fault-schedule", "chaos",
              "--fail-node", "1"], "drop --fail-node")):
        err = io.StringIO()
        with contextlib.redirect_stderr(err), pytest.raises(SystemExit):
            tserve.main(["--device", "cpu"] + argv)
        assert msg in err.getvalue(), (argv, err.getvalue())


def test_frontdoor_cli_runs_to_the_end(tmp_path):
    rc, out = _run_cli(tfrontdoor.main, [
        "--device", "cpu", "--tenants", "3", "--requests", "12",
        "--nodes", "2", "--store", str(tmp_path), "--leave-node", "1"])
    assert rc == 0
    assert "accepted/served    : 36/36" in out
    assert "accepted-job loss: 0" in out
    assert "fairness (Jain)    : 1.000" in out
    assert len(list(tmp_path.glob("*.npy"))) == 36


def test_frontdoor_cli_defaults_to_the_card(monkeypatch):
    built = {}

    class _Stop(Exception):
        pass

    def fake_build(**kw):
        built.update(kw)
        raise _Stop
    monkeypatch.setattr(tfrontdoor, "build_system", fake_build)
    with pytest.raises(_Stop):
        tfrontdoor.main([])
    assert built["device"] == "cuda"
