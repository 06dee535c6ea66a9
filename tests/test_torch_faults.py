"""Scripted faults, the port against the JAX package, on the CPU.

* Schedules: every preset and ``FaultSchedule.generate`` give the
  reference's events, event for event, for several (nodes, horizon,
  seed); ``rng(step)`` draws are equal; validation refuses what the
  reference refuses.
* ``FlakyBackend``: the saturating arm contract, and a proxy that
  delegates everything else (the step-level path finds the slot engine
  through it).
* Chaos runs: the ``chaos`` preset over ``build_system(device="cpu")``
  and over the reference's fleet, with the same schedule and trace, on a
  fixed-tick clock (the engine's virtual clock otherwise follows the
  machine's load), in group mode and at step level, with and without
  journals: the injector's log and report, the route counts, every
  image and the cache state equal the reference's.
* Crash-restart: a crashed node's journal replay equals its live cache
  at the instant of the crash, and a trace interrupted by the crash
  finishes as an uninterrupted twin does, in the port and in the
  reference alike.

Everything compared here is exact: the fleet runs the render-based
NullBackend, and the scans' scores are f32 sums of the same numpy
inputs (held to the reference's 2e-5 by ``test_torch_retrieval.py``)
whose ranking must not move."""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest

from repro.core.pipeline import TransientBackendError as JTransient
from repro.faults import (FaultInjector as JInjector,
                          FaultSchedule as JSchedule,
                          attach_journals as jattach)
from repro.launch.serve import build_system as jbuild
from repro.runtime import serving as jserving
from repro_torch.core.pipeline import TransientBackendError
from repro_torch.core.trace import RequestTrace, bursty_arrivals
from repro_torch.faults import (FaultEvent, FaultInjector, FaultSchedule,
                                FlakyBackend, attach_journals)
from repro_torch.faults.schedule import PRESETS
from repro_torch.launch.serve import build_system
from repro_torch.runtime import serving as tserving
from repro_torch.runtime.serving import (EmulatedSlotEngine,
                                         ServingEngine)


def _events(schedule):
    return [dataclasses.astuple(e) for e in schedule.events]


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PRESETS))
@pytest.mark.parametrize("nodes,horizon,seed", [(2, 10, 0), (3, 40, 7),
                                                (4, 120, 1), (5, 7, 3)])
def test_presets_equal_jax(name, nodes, horizon, seed):
    got = FaultSchedule.preset(name, nodes=nodes, horizon=horizon,
                               seed=seed)
    want = JSchedule.preset(name, nodes=nodes, horizon=horizon, seed=seed)
    assert _events(got) == _events(want)
    assert (got.seed, got.horizon) == (want.seed, want.horizon)
    for step in range(max(horizon, 10) + 1):
        assert [dataclasses.astuple(e) for e in got.at(step)] == \
            [dataclasses.astuple(e) for e in want.at(step)]


@pytest.mark.parametrize("nodes,horizon,seed,rate", [
    (3, 200, 5, 0.05), (3, 200, 6, 0.05), (4, 500, 0, 0.2),
    (2, 50, 9, 0.5), (6, 1000, 123, 0.02)])
def test_generate_equals_jax(nodes, horizon, seed, rate):
    got = FaultSchedule.generate(nodes=nodes, horizon=horizon, seed=seed,
                                 rate=rate)
    want = JSchedule.generate(nodes=nodes, horizon=horizon, seed=seed,
                              rate=rate)
    assert len(got.events) > 0
    assert _events(got) == _events(want)


def test_rng_draws_equal_jax():
    for seed in (0, 3, 41):
        a, b = FaultSchedule(events=(), seed=seed), JSchedule(events=(),
                                                              seed=seed)
        for step in (0, 7, 31, 999):
            np.testing.assert_array_equal(a.rng(step).integers(0, 1000, 16),
                                          b.rng(step).integers(0, 1000, 16))
            ra, rb = a.rng(step), b.rng(step)
            np.testing.assert_array_equal(ra.choice(50, 9, replace=False),
                                          rb.choice(50, 9, replace=False))
            np.testing.assert_array_equal(ra.standard_normal(5),
                                          rb.standard_normal(5))


def test_validation_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultEvent(step=0, kind="meteor")
    with pytest.raises(ValueError, match="step must be"):
        FaultEvent(step=-1, kind="crash")
    with pytest.raises(ValueError, match="unknown preset"):
        FaultSchedule.preset("nope", nodes=2, horizon=20)
    for name in ("crash", "chaos"):
        with pytest.raises(ValueError, match="nodes >= 2"):
            FaultSchedule.preset(name, nodes=1, horizon=20)
    s = FaultSchedule.preset("chaos", nodes=3, horizon=40, seed=7)
    assert {e.kind for e in s.events} == {"crash", "corrupt", "transient",
                                          "stall"}
    assert s.horizon <= 40 and all(s.at(e.step) for e in s.events)


# ---------------------------------------------------------------------------
# FlakyBackend
# ---------------------------------------------------------------------------


def test_flaky_backend_arm_is_saturating():
    class Inner:
        latent_shape = (4, 4, 4)

        def txt2img_batch(self, p, s, seeds):
            return "txt"

        def img2img_batch(self, p, r, s, seeds):
            return "img"

        def resume_batch(self, p, lat, total, k, seeds):
            return "resume"

        def make_slot_engine(self, capacity):
            return ("slots", capacity)

    fb = FlakyBackend(Inner())
    fb.arm(2)
    fb.arm(1)                    # saturates at 2, does not stack to 3
    assert fb._armed == 2
    with pytest.raises(TransientBackendError):
        fb.txt2img_batch([], 0, [])
    with pytest.raises(TransientBackendError):
        fb.resume_batch([], None, 0, 0, [])
    assert fb.txt2img_batch([], 0, []) == "txt"
    assert fb.img2img_batch([], None, 0, []) == "img"
    assert fb.faults_injected == 2
    fb.arm(1)
    with pytest.raises(TransientBackendError):
        fb.img2img_batch([], None, 0, [])
    # everything else delegates, the slot engine included
    assert fb.make_slot_engine(4) == ("slots", 4)
    assert fb.latent_shape == (4, 4, 4)
    assert fb.faults_injected == 3
    # the port's error is its own class, not the reference's
    assert not issubclass(TransientBackendError, JTransient)


# ---------------------------------------------------------------------------
# chaos runs against the reference
# ---------------------------------------------------------------------------


def _tick_clock(tick: float = 1e-6):
    """A stand-in for the ``time`` module whose ``perf_counter`` advances
    ``tick`` seconds per reading: both engines then batch the same
    arrivals into the same groups, whatever the machine's load."""
    now = [0.0]

    def perf_counter() -> float:
        now[0] += tick
        return now[0]
    return types.SimpleNamespace(perf_counter=perf_counter)


def _fleet(build, **kw):
    system, _, _, _ = build(n_nodes=3, corpus_n=80, capacity_per_node=80,
                            seed=0, **kw)
    return system


def _cache_state(system):
    return {k: [db.snapshot()[k] for db in system.dbs]
            for k in ("valid", "payload_ids", "access_count", "depth",
                      "source_id", "insert_time", "last_access",
                      "img_vecs")}


def _chaos(build, attach, schedule_cls, injector_cls, *, step_level,
           journal_root=None, **kw):
    system = _fleet(build, **kw)
    reqs = list(RequestTrace(seed=0).generate(36))
    arrivals = bursty_arrivals(reqs, burst_size=7, burst_gap=0.4)
    journals = (attach(system, str(journal_root), snapshot_every=16)
                if journal_root is not None else None)
    horizon = 120 if step_level else 10
    sched = schedule_cls.preset("chaos", nodes=3, horizon=horizon, seed=1)
    inj = injector_cls(system, sched, journals=journals)
    engine = (ServingEngine if build is build_system
              else jserving.ServingEngine)(system, max_batch=8)
    run_kw = dict(step_level=True, slot_capacity=4) if step_level else {}
    done = engine.run(arrivals, on_step=inj.on_step, **run_kw)
    inj.finish()
    return system, done, inj.report(), engine


def _assert_same_chaos(got, want):
    (s_t, d_t, rep_t, _), (s_j, d_j, rep_j, _) = got, want
    assert rep_t == rep_j                 # log, actions, counts
    assert s_t.stats.route_counts == s_j.stats.route_counts
    assert (s_t.stats.corrupt_hits, s_t.stats.degraded_serves,
            s_t.stats.transient_retries, s_t.stats.total_steps) == \
        (s_j.stats.corrupt_hits, s_j.stats.degraded_serves,
         s_j.stats.transient_retries, s_j.stats.total_steps)
    assert len(d_t) == len(d_j)
    for a, b in zip(d_t, d_j):
        ra, rb = a.result, b.result
        assert a.request.prompt == b.request.prompt
        assert (ra.fast_path or ra.route.value) == (rb.fast_path
                                                    or rb.route.value)
        assert (ra.node, ra.steps, ra.degraded) == (rb.node, rb.steps,
                                                    rb.degraded)
        np.testing.assert_array_equal(ra.image, rb.image)
    st, sj = _cache_state(s_t), _cache_state(s_j)
    for k in st:
        for a, b in zip(st[k], sj[k]):
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert sorted(s_t.blob_store._blobs) == sorted(s_j.blob_store._blobs)
    assert [n.alive for n in s_t.scheduler.nodes] == \
        [n.alive for n in s_j.scheduler.nodes]
    assert [n.speed for n in s_t.scheduler.nodes] == \
        [n.speed for n in s_j.scheduler.nodes]


@pytest.mark.parametrize("step_level,journaled", [(False, False),
                                                  (False, True),
                                                  (True, True)])
def test_chaos_run_equals_jax(tmp_path, monkeypatch, step_level, journaled):
    monkeypatch.setattr(tserving, "time", _tick_clock())
    monkeypatch.setattr(jserving, "time", _tick_clock())
    roots = ((tmp_path / "port", tmp_path / "jax") if journaled
             else (None, None))
    got = _chaos(build_system, attach_journals, FaultSchedule,
                 FaultInjector, step_level=step_level,
                 journal_root=roots[0], device="cpu")
    want = _chaos(jbuild, jattach, JSchedule, JInjector,
                  step_level=step_level, journal_root=roots[1])
    system, done, rep, engine = got
    # zero accepted-job loss, and every fault really fired
    assert len(done) == 36 and all(c.result.image is not None
                                   for c in done)
    assert rep["actions"]["crash"] == 1 and rep["actions"]["unstall"] == 1
    assert rep["actions"]["rejoin-journaled" if journaled
                          else "rejoin-cold"] == 1
    assert rep["faults_injected"] > 0 and rep["transient_retries"] > 0
    if not step_level:
        assert rep["corrupt_hits"] > 0
    else:
        assert isinstance(engine.last_slot_engine, EmulatedSlotEngine)
    assert all(n.alive for n in system.scheduler.nodes)
    if journaled:
        assert system.dbs[2].size > 0          # rejoined with its cache
    _assert_same_chaos(got, want)


def test_chaos_replay_is_bit_for_bit(monkeypatch):
    runs = []
    for _ in range(2):
        monkeypatch.setattr(tserving, "time", _tick_clock())
        runs.append(_chaos(build_system, attach_journals, FaultSchedule,
                           FaultInjector, step_level=False, device="cpu"))
    _assert_same_chaos(runs[0], runs[1])


# ---------------------------------------------------------------------------
# crash-restart: bitwise replay and interrupted-run parity
# ---------------------------------------------------------------------------


def _interrupted(build, attach, tmp_path, replay_kw, **kw):
    """The reference's satellite property: serve half a trace, crash the
    busiest node, replay its journal, rejoin and finish; an uninterrupted
    twin serves the same trace.  Returns both result lists, both
    systems and the replay-vs-live comparison taken before the rejoin."""
    reqs = list(RequestTrace(seed=2).generate(40))
    cut = 20
    twin = _fleet(build, **kw)
    attach(twin, str(tmp_path / "twin"), snapshot_every=16)
    twin_res = [twin.serve(r.prompt, seed=i) for i, r in enumerate(reqs)]
    system = _fleet(build, **kw)
    journals = attach(system, str(tmp_path / "crashed"), snapshot_every=16)
    res = [system.serve(r.prompt, seed=i)
           for i, r in enumerate(reqs[:cut])]
    victim = max(range(3), key=lambda n: system.dbs[n].size)
    old = system.crash_node(victim)
    assert system.dbs[victim].size == 0
    db = journals[victim].replay(old.dim, old.capacity, name=old.name,
                                 use_pallas=old.use_pallas,
                                 **replay_kw(old))
    live, rest = old.snapshot(), db.snapshot()
    db.attach_journal(journals[victim])
    system.rejoin_node(victim, db)
    res += [system.serve(r.prompt, seed=cut + i)
            for i, r in enumerate(reqs[cut:])]
    return twin, twin_res, system, res, (live, rest, victim)


def test_crash_replay_and_interrupted_run_equal_jax(tmp_path):
    got = _interrupted(build_system, attach_journals, tmp_path / "port",
                       lambda old: dict(device=old.device), device="cpu")
    want = _interrupted(jbuild, jattach, tmp_path / "jax",
                        lambda old: dict(interpret=old.interpret))
    twin, twin_res, system, res, (live, rest, victim) = got
    assert set(live) == set(rest)              # bitwise before rejoin
    for k in live:
        np.testing.assert_array_equal(live[k], rest[k], err_msg=k)
    for a, b in zip(twin_res, res):            # = the uninterrupted twin
        assert (a.fast_path or a.route.value) == (b.fast_path
                                                  or b.route.value)
        assert a.node == b.node and a.steps == b.steps
        np.testing.assert_array_equal(a.image, b.image)
    assert twin.stats.route_counts == system.stats.route_counts
    for db_a, db_b in zip(twin.dbs, system.dbs):
        for k, v in db_a.snapshot().items():
            np.testing.assert_array_equal(v, db_b.snapshot()[k], err_msg=k)
    # and the whole story equals the reference's
    j_twin, j_twin_res, j_system, j_res, (_, _, j_victim) = want
    assert victim == j_victim
    for a, b in zip(res, j_res):
        assert (a.fast_path or a.route.value, a.node, a.steps) == \
            (b.fast_path or b.route.value, b.node, b.steps)
        np.testing.assert_array_equal(a.image, b.image)
    for db_a, db_b in zip(system.dbs, j_system.dbs):
        for k, v in db_a.snapshot().items():
            np.testing.assert_array_equal(v, db_b.snapshot()[k], err_msg=k)


def test_attach_journals_publishes_a_base_snapshot(tmp_path):
    system = _fleet(build_system, device="cpu")
    journals = attach_journals(system, str(tmp_path), snapshot_every=8)
    assert sorted(journals) == [0, 1, 2]
    for i, j in journals.items():
        assert j.root == str(tmp_path / f"node{i}")
        assert system.dbs[i]._journal is j
        rebuilt = j.replay(system.dbs[i].dim, system.dbs[i].capacity,
                           device="cpu")
        for k, v in system.dbs[i].snapshot().items():
            np.testing.assert_array_equal(v, rebuilt.snapshot()[k])


def test_injector_skips_what_cannot_fire():
    """A crash of a dead node, of the last alive node, and a rejoin of a
    live one are logged as skips, as in the reference."""
    system = _fleet(build_system, device="cpu")
    sched = FaultSchedule(events=(
        FaultEvent(step=0, kind="crash", node=1, duration=0),
        FaultEvent(step=1, kind="crash", node=1),
        FaultEvent(step=1, kind="fail", node=0),
        FaultEvent(step=2, kind="crash", node=2),
        FaultEvent(step=2, kind="fail", node=0)))
    inj = FaultInjector(system, sched)
    assert isinstance(system.backend, FlakyBackend)
    for step in range(3):
        inj.on_step(step)
    inj._rejoin(2, 3)
    assert [a for _, a, _ in inj.log] == [
        "crash", "skip-crash", "fail", "skip-crash", "skip-fail",
        "skip-rejoin"]
    assert inj.report()["steps_seen"] == 3
