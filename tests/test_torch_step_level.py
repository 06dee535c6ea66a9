"""Continuous, step-level and latent-depth serving, the port against the
JAX package, on the CPU.

* The four sampler pieces of the slice (``ddim_step_slots``,
  ``step_slots``, ``resume_noise_levels``, ``resume_sample``) against
  JAX on the same inputs.
* ``DiffusionBackend.archive_latents_batch`` / ``resume_batch`` against
  the JAX backend at sd15-small, JAX's noise draw injected; ``resume``
  from depth 0 replays img2img.
* ``ServingEngine.run`` in continuous and drain mode and at step level
  (slot capacities 4 and 13), on the NullBackend: routes, nodes, steps,
  images (bitwise) and cache state equal JAX's sequential ``serve``; a
  latent-depth drain of the band-mutation trace equals JAX's.
* Step-level serving through the port's DiffusionSlotEngine (tiny DiT)
  against the port's sequential ``serve``: same routes, images to 1e-5.

Tolerances: one network pass or a few DDIM steps to 1e-5 / 1e-4 of the
output scale, as in ``tests/test_torch_dit_vae.py``."""
from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (jax_noise_fn, jax_vae, perturbed_jax_dit,
                           port_dit, port_schedule, port_vae)
from repro.configs import get_arch
from repro.core.embeddings import ProxyClipEmbedder as JEmbedder
from repro.data.synthetic import render_caption as jrender
from repro.launch.serve import build_system as jbuild
from repro.models.diffusion import dit as jdit
from repro.models.diffusion import sampler as jsampler
from repro.models.diffusion.schedule import DiffusionSchedule as JSchedule
from repro.runtime.serving import DiffusionBackend as JBackend
from repro_torch.core.embeddings import ProxyClipEmbedder
from repro_torch.core.policy import GenerationPolicy
from repro_torch.core.trace import (RequestTrace, band_mutation_trace,
                                    bursty_arrivals, poisson_arrivals)
from repro_torch.data.synthetic import render_caption
from repro_torch.launch.serve import build_system
from repro_torch.models.diffusion import sampler as tsampler
from repro_torch.models.diffusion.dit import make_eps_fn
from repro_torch.runtime import serving
from repro_torch.runtime.serving import (DiffusionBackend,
                                         DiffusionSlotEngine,
                                         EmulatedSlotEngine, ServingEngine)

SD15 = get_arch("sd15-small").make_config(None)


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * scale)


@pytest.fixture(scope="module")
def sd15_weights():
    return perturbed_jax_dit(SD15.net, seed=0), jax_vae(SD15.vae, seed=1)


# ---------------------------------------------------------------------------
# sampler pieces
# ---------------------------------------------------------------------------


def test_resume_noise_levels_match_jax():
    for steps, strength in ((20, 0.6), (2, 0.6), (7, 0.35)):
        assert tsampler.resume_noise_levels(
            port_schedule(JSchedule.linear(1000)), steps=steps,
            strength=strength) == jsampler.resume_noise_levels(
            JSchedule.linear(1000), steps=steps, strength=strength)


def test_ddim_step_slots_and_step_slots_match_jax(sd15_weights):
    """Per-slot timesteps, a last update (t_prev = -1) and an inactive
    slot, through the sd15-small DiT."""
    dit, _ = sd15_weights
    jsched = JSchedule.linear(1000)
    tsched = port_schedule(jsched)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 8, 8, 4)).astype(np.float32)
    eps = rng.normal(size=x.shape).astype(np.float32)
    ctx = rng.normal(size=(4, 512)).astype(np.float32)
    t = np.array([999, 600, 31, 0], np.int32)
    tp = np.array([966, 400, -1, -1], np.int32)
    active = np.array([True, True, True, False])
    want = jsampler.ddim_step_slots(jsched, *map(jnp.asarray, (x, eps, t,
                                                               tp)))
    got = tsampler.ddim_step_slots(tsched, *map(torch.from_numpy,
                                                (x, eps, t, tp)))
    _close(got, want)
    want = jsampler.step_slots(jdit.make_eps_fn(dit, SD15.net), jsched,
                               *map(jnp.asarray, (x, ctx, t, tp, active)))
    with torch.no_grad():
        got = tsampler.step_slots(make_eps_fn(port_dit(dit, SD15.net)),
                                  tsched, *map(torch.from_numpy,
                                               (x, ctx, t, tp, active)))
    _close(got, want)
    assert torch.equal(got[3], torch.from_numpy(x[3]))   # passed through


@pytest.mark.parametrize("k", [0, 2])
def test_resume_sample_matches_jax(sd15_weights, k):
    dit, _ = sd15_weights
    jsched = JSchedule.linear(1000)
    rng = np.random.default_rng(4 + k)
    lat = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(2, 512)).astype(np.float32)
    want = jsampler.resume_sample(jdit.make_eps_fn(dit, SD15.net), jsched,
                                  jnp.asarray(lat), jnp.asarray(ctx),
                                  steps=4, k=k, strength=0.6)
    with torch.no_grad():
        got = tsampler.resume_sample(
            make_eps_fn(port_dit(dit, SD15.net)), port_schedule(jsched),
            torch.from_numpy(lat), torch.from_numpy(ctx), steps=4, k=k,
            strength=0.6)
    _close(got, want, rel=1e-4)


# ---------------------------------------------------------------------------
# the backend's latent-depth surface
# ---------------------------------------------------------------------------


def _port_backend(weights, **kw):
    dit, vae = weights
    emb = ProxyClipEmbedder(render_caption)
    return DiffusionBackend(
        port_dit(dit, SD15.net), port_vae(vae, SD15.vae),
        lambda p: emb.embed_text([p])[0],
        schedule=port_schedule(JSchedule.linear(1000)), device="cpu", **kw)


_PROMPTS = ["a medium red circle at the center on a black background",
            "a small blue square at the left on a gray background",
            "a large green triangle at the right on a white background"]


def test_archive_and_resume_match_jax(sd15_weights):
    """Three images (padded to a batch of four on both sides), depths
    (0, 1) of a 2-step chain, then a resume from depth 1."""
    dit, vae = sd15_weights
    emb = JEmbedder(jrender)
    jb = JBackend(dit, SD15.net, vae, SD15.vae,
                  embed_prompt=lambda p: emb.embed_text([p])[0])
    tb = _port_backend(sd15_weights, noise_fn=jax_noise_fn)
    assert tb.supports_latent_resume
    imgs = np.stack([render_caption(p, res=32) for p in _PROMPTS])
    seeds = [3, 4, 5]
    want = jb.archive_latents_batch(imgs, seeds, (0, 1), steps_total=2)
    got = tb.archive_latents_batch(imgs, seeds, (0, 1), steps_total=2)
    assert got.shape == want.shape == (2, 3, 8, 8, 4)
    _close(got, want)
    _close(tb.resume_batch(_PROMPTS, got[1], 2, 1, seeds),
           jb.resume_batch(_PROMPTS, want[1], 2, 1, seeds), rel=1e-4)
    assert tb.archive_latents_batch(imgs[:0], [], (0, 1), 2).shape == \
        (2, 0, 8, 8, 4)


def test_resume_from_depth_zero_replays_img2img(sd15_weights):
    tb = _port_backend(sd15_weights)
    refs = np.stack([render_caption(p, res=32) for p in _PROMPTS[:2]])
    seeds = [7, 8]
    lat = tb.archive_latents_batch(refs, seeds, (0,), steps_total=2)
    np.testing.assert_array_equal(
        tb.resume_batch(_PROMPTS[:2], lat[0], 2, 0, seeds),
        tb.img2img_batch(_PROMPTS[:2], refs, 2, seeds))


# ---------------------------------------------------------------------------
# the engine on the NullBackend: every mode equals JAX's sequential serve
# ---------------------------------------------------------------------------


def _null_system(build, **kw):
    system, _, _, _ = build(n_nodes=2, corpus_n=80, capacity_per_node=80,
                            seed=0, **kw)
    return system


def _route_key(r):
    return r.fast_path or r.route.value


def _outcome(results, system):
    return dict(
        routes=[_route_key(r) for r in results],
        nodes=[r.node for r in results], steps=[r.steps for r in results],
        images=[np.asarray(r.image) for r in results],
        valid=[db.valid.copy() for db in system.dbs],
        payloads=[db.payload_ids.copy() for db in system.dbs],
        access=[db.access_count.copy() for db in system.dbs],
        stats=(dict(system.stats.route_counts), system.stats.cache_hits,
               system.stats.reference_hits, system.stats.latent_resumes),
        blobs=len(system.blob_store))


def _assert_same(got, want):
    for key in ("routes", "nodes", "steps", "stats", "blobs"):
        assert got[key] == want[key], key
    for key in ("images", "valid", "payloads", "access"):
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a, b)


_TRACE = list(RequestTrace(seed=3).generate(40))


@pytest.fixture(scope="module")
def jax_sequential():
    system = _null_system(jbuild)
    results = [system.serve(r.prompt, seed=i, quality_tier=r.quality_tier)
               for i, r in enumerate(_TRACE)]
    return _outcome(results, system)


def _tick_clock(tick: float = 1e-6):
    """A stand-in for the ``time`` module whose ``perf_counter`` advances
    ``tick`` seconds per reading: every pass of ``ServingEngine.run`` then
    takes the same virtual time however loaded the machine is."""
    now = [0.0]

    def perf_counter() -> float:
        now[0] += tick
        return now[0]
    return types.SimpleNamespace(perf_counter=perf_counter)


@pytest.mark.parametrize("mode,cap", [("continuous", None), ("drain", None),
                                      ("step", 4), ("step", 13)])
def test_run_modes_equal_jax_sequential(jax_sequential, mode, cap,
                                        monkeypatch):
    """The engine's virtual clock advances by measured pass times, so the
    batching would follow the machine's load; a fixed tick per clock
    reading gives the batching of a fast machine on every run."""
    monkeypatch.setattr(serving, "time", _tick_clock())
    system = _null_system(build_system, device="cpu")
    engine = ServingEngine(system, max_batch=8)
    arrivals = poisson_arrivals(_TRACE, 60.0, seed=3)
    if mode == "step":
        done = engine.run(arrivals, step_level=True, slot_capacity=cap)
        assert isinstance(engine.last_slot_engine, EmulatedSlotEngine)
        assert engine.last_slot_engine.step_calls == \
            len(engine.slot_occupancy) > 0
        assert max(engine.slot_occupancy) <= cap
    else:
        done = engine.run(arrivals, mode=mode)
    assert [c.request.prompt for c in done] == [r.prompt for r in _TRACE]
    assert all(c.queue_delay >= 0 for c in done)
    _assert_same(_outcome([c.result for c in done], system), jax_sequential)


def test_run_refuses_bad_modes():
    engine = ServingEngine(_null_system(build_system, device="cpu"))
    with pytest.raises(ValueError, match="unknown mode"):
        engine.run([], mode="batch")
    with pytest.raises(ValueError, match="requires mode='continuous'"):
        engine.run([], mode="drain", step_level=True)
    with pytest.raises(ValueError, match="slot_capacity"):
        engine.run([], slot_capacity=4)
    assert engine.run([]) == [] and engine.run([], step_level=True) == []


def test_latent_depth_drain_equals_jax():
    """The band-mutation trace with latents archived at the policy's
    depths: resumes happen, and everything equals JAX."""
    reqs = band_mutation_trace(40, seed=7)
    out = []
    for build, kw in ((jbuild, {}), (build_system, dict(device="cpu"))):
        system = _null_system(build, latent_depths=True, **kw)
        results = [system.serve(r.prompt, seed=i)
                   for i, r in enumerate(reqs)]
        out.append(_outcome(results, system))
    assert out[1]["stats"][3] > 0                    # latent resumes
    _assert_same(out[1], out[0])


# ---------------------------------------------------------------------------
# the real slot engine (tiny DiT) against sequential serve
# ---------------------------------------------------------------------------


def _tiny_system(backend):
    system, _, _, _ = build_system(
        n_nodes=2, corpus_n=60, capacity_per_node=60, seed=0,
        policy=GenerationPolicy(steps_full=2, steps_ref=2), backend=backend,
        latent_depths=(1,), device="cpu")
    return system


def test_step_level_slot_engine_matches_sequential(sd15_weights):
    backend = _port_backend(sd15_weights)
    reqs = list(RequestTrace(seed=11).generate(12))
    s_seq = _tiny_system(backend)
    r_seq = [s_seq.serve(r.prompt, seed=i, quality_tier=r.quality_tier)
             for i, r in enumerate(reqs)]
    s_stp = _tiny_system(backend)
    engine = ServingEngine(s_stp, max_batch=4)
    done = engine.run(bursty_arrivals(reqs, burst_size=3, burst_gap=2.0),
                      step_level=True, slot_capacity=4)
    assert isinstance(engine.last_slot_engine, DiffusionSlotEngine)
    assert any(r.steps > 0 and r.fast_path != "history" for r in r_seq)
    assert len(done) == len(reqs)
    for a, c in zip(r_seq, done):
        assert _route_key(a) == _route_key(c.result)
        assert a.node == c.result.node and a.steps == c.result.steps
        _close(c.result.image, a.image)
    for db_a, db_b in zip(s_seq.dbs, s_stp.dbs):
        np.testing.assert_array_equal(db_a.valid, db_b.valid)
        np.testing.assert_array_equal(db_a.depth, db_b.depth)
