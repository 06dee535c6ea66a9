"""The port's serving path as a whole, against the JAX package's, on the
CPU: ``build_system`` -> ``ServingEngine.submit``/``drain`` over the
staged pipeline, the cluster scans and a generation backend.

* With the render-based ``NullBackend`` (the drain of
  ``tests/test_cluster_sharded.py::test_end_to_end_serve_parity`` at
  mesh 1): routes, nodes, images and the final cache state are EQUAL.
* With ``DiffusionBackend`` at ``sd15-small`` width, JAX-initialised
  weights converted to the port, and the JAX noise draw injected: routes
  and nodes are equal; images agree to 1e-4 of their scale (a few DDIM
  steps of f32 arithmetic in two frameworks)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import (jax_noise_fn, jax_vae, perturbed_jax_dit,
                           port_dit, port_schedule, port_vae)
from repro.configs import get_arch
from repro.core.embeddings import ProxyClipEmbedder as JEmbedder
from repro.core.policy import GenerationPolicy as JPolicy
from repro.core.trace import RequestTrace
from repro.data.synthetic import render_caption as jrender
from repro.launch.serve import build_system as jbuild
from repro.models.diffusion.schedule import DiffusionSchedule as JSchedule
from repro.runtime.serving import DiffusionBackend as JBackend
from repro.runtime.serving import ServingEngine as JEngine
from repro_torch.core.embeddings import ProxyClipEmbedder
from repro_torch.core.policy import GenerationPolicy
from repro_torch.data.synthetic import render_caption
from repro_torch.launch import serve as tserve
from repro_torch.runtime.serving import (DiffusionBackend, ServingEngine,
                                         seeded_noise)

SD15 = get_arch("sd15-small").make_config(None)


def _drain(build, engine_cls, n_requests: int, **kw):
    system, _, _, _ = build(n_nodes=4, corpus_n=120, capacity_per_node=80,
                            seed=0, **kw)
    engine = engine_cls(system, max_batch=8)
    for i, r in enumerate(RequestTrace(seed=1).generate(n_requests)):
        engine.submit(r.prompt, seed=i, quality_tier=r.quality_tier)
    done = engine.drain()
    return dict(
        routes=[c.result.route.name for c in done],
        nodes=[c.result.node for c in done],
        images=[None if c.result.image is None
                else np.asarray(c.result.image) for c in done],
        state=[(db.valid.copy(), db.img_vecs.copy()) for db in system.dbs],
        system=system)


@pytest.mark.parametrize("routing", ["score", "centroid"])
def test_null_backend_drain_equals_jax(routing):
    want = _drain(jbuild, JEngine, 48, routing=routing)
    got = _drain(tserve.build_system, ServingEngine, 48, routing=routing,
                 device="cpu")
    assert got["routes"] == want["routes"]
    assert got["nodes"] == want["nodes"]
    for a, b in zip(got["images"], want["images"]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    for (v1, g1), (v2, g2) in zip(got["state"], want["state"]):
        np.testing.assert_array_equal(v1, v2)
        np.testing.assert_array_equal(g1, g2)
    ci, ji = got["system"].cluster_index, want["system"].cluster_index
    for key in ("slab_uploads", "row_updates", "fused_scans"):
        assert ci.stats[key] == ji.stats[key]


@pytest.fixture(scope="module")
def sd15_weights():
    return perturbed_jax_dit(SD15.net, seed=0), jax_vae(SD15.vae, seed=1)


def _port_backend(weights, **kw):
    dit, vae = weights
    emb = ProxyClipEmbedder(render_caption)
    return DiffusionBackend(
        port_dit(dit, SD15.net), port_vae(vae, SD15.vae),
        lambda p: emb.embed_text([p])[0],
        schedule=port_schedule(JSchedule.linear(1000)), device="cpu", **kw)


@pytest.mark.parametrize("routing", ["score", "centroid"])
def test_diffusion_drain_matches_jax(sd15_weights, routing):
    """24 requests, few denoising steps (3 txt2img, 2 img2img) to keep
    the JAX compiles short; every route occurs."""
    dit, vae = sd15_weights
    emb = JEmbedder(jrender)
    jbackend = JBackend(dit, SD15.net, vae, SD15.vae,
                        embed_prompt=lambda p: emb.embed_text([p])[0])
    want = _drain(jbuild, JEngine, 24, routing=routing, backend=jbackend,
                  policy=JPolicy(steps_full=3, steps_ref=2))
    got = _drain(tserve.build_system, ServingEngine, 24, routing=routing,
                 backend=_port_backend(sd15_weights, noise_fn=jax_noise_fn),
                 policy=GenerationPolicy(steps_full=3, steps_ref=2),
                 device="cpu")
    assert got["routes"] == want["routes"]
    assert {"TXT2IMG", "IMG2IMG", "HIT_RETURN"} <= set(got["routes"])
    assert got["nodes"] == want["nodes"]
    scale = max(float(np.abs(b).max()) for b in want["images"])
    for a, b in zip(got["images"], want["images"]):
        assert a.shape == b.shape == (32, 32, 3)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale)
    for (v1, _), (v2, _) in zip(got["state"], want["state"]):
        np.testing.assert_array_equal(v1, v2)


def test_batching_never_changes_an_image(sd15_weights):
    """With the default per-seed generators, a request's image is the same
    alone or in a padded batch, at any batch position."""
    backend = _port_backend(sd15_weights)
    prompts = ["a red circle", "a blue square", "a green triangle"]
    seeds = [5, 6, 7]
    seq = np.stack([backend.txt2img(p, 2, s) for p, s in zip(prompts, seeds)])
    bat = backend.txt2img_batch(prompts, 2, seeds)
    np.testing.assert_allclose(bat, seq, rtol=1e-5, atol=1e-5)
    assert np.abs(bat[0] - bat[1]).max() > 1e-6
    seq2 = np.stack([backend.img2img(p, r, 2, s)
                     for p, r, s in zip(prompts, seq, seeds)])
    bat2 = backend.img2img_batch(prompts, seq, 2, seeds)
    np.testing.assert_allclose(bat2, seq2, rtol=1e-5, atol=1e-5)
    assert backend.txt2img_batch([], 2, []).shape == (0, 32, 32, 3)


def test_seeded_noise_is_per_request():
    a = seeded_noise([3, 1, 3], (2, 2, 4), "cpu")
    assert torch.equal(a[0], a[2]) and not torch.equal(a[0], a[1])
    assert torch.equal(seeded_noise([1], (2, 2, 4), "cpu")[0], a[1])


def test_serve_cli_drain_path(capsys):
    assert tserve.main(["--requests", "16", "--nodes", "3",
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "requests           : 16" in out and "route mix" in out


@pytest.mark.parametrize("flag", [["--journal-dir", "journals",
                                   "--fault-schedule", "chaos"],
                                  ["--tenants", "3"],
                                  ["--fault-schedule", "mixed"],
                                  ["--mesh-nodes", "0"]])
def test_serve_cli_refuses_later_slices(flag, capsys):
    """Faults, journals, tenants and the mesh are ported: their flags are
    refused only where the reference refuses them (a chaos schedule or
    tenants without ``--continuous``, an unknown preset, a mesh of no
    shard)."""
    with pytest.raises(SystemExit) as exc:
        tserve.main(flag + ["--device", "cpu"])
    assert exc.value.code == 2
    want = {"--journal-dir": "--fault-schedule requires --continuous",
            "--tenants": "--tenants requires --continuous",
            "--fault-schedule": "invalid choice: 'mixed'",
            "--mesh-nodes": "--mesh-nodes must be >= 1"}[flag[0]]
    assert want in capsys.readouterr().err


@pytest.mark.parametrize("flags,mode", [
    (["--continuous"], "(continuous, 50 req/s offered)"),
    (["--continuous", "--step-level", "--slot-capacity", "4"],
     "(step-level continuous, 50 req/s offered)")])
def test_serve_cli_continuous_modes(flags, mode, capsys):
    assert tserve.main(["--requests", "16", "--nodes", "3",
                        "--device", "cpu"] + flags) == 0
    out = capsys.readouterr().out
    assert "requests           : 16" in out and mode in out
    assert ("slot occupancy" in out) == ("--step-level" in flags)


@pytest.mark.parametrize("flags", [["--step-level"],
                                   ["--continuous", "--slot-capacity", "4"],
                                   ["--continuous", "--arrival-rate", "0"]])
def test_serve_cli_checks_continuous_flags(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        tserve.main(flags + ["--device", "cpu"])
    assert exc.value.code == 2
    assert "--" in capsys.readouterr().err
