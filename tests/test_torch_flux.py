"""flux-dev's path in the port against the JAX package, on the CPU: the
MMDiT, the gen cell program, the rectified-flow samplers, the configs
and the plain bf16 flash attention.

Weights are JAX-initialised (``init_mmdit`` of ``flux_dev.make_reduced``)
with the zero-initialised layers (every ``mod``, ``final_mod``,
``final_proj``) drawn from N(0, 0.02) — an untouched MMDiT predicts
v = 0 and a comparison would check nothing — converted with
``repro_torch.convert``, and the same numpy inputs go through both.  The
JAX MMDiT runs with ``use_pallas=True`` (flash attention in Pallas
interpret mode, as ``tests/test_kernels.py`` runs it).  Tolerances: one
forward to 1e-5 of the output scale (the DiT tests' f32 tolerance);
four Euler steps, and a VAE encode → ``rf_edit`` → decode, to 1e-4 (each
step's error feeds the next).  The bf16 scalar arithmetic of the gen
step and of ``rf_sample`` is checked bit for bit, with a stand-in
network that returns fixed velocities."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_params_numpy, port_dit, port_vae
from repro.configs import get_arch as jget_arch
from repro.configs.shapes import get_shape as jget_shape
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models.diffusion import dit as jdit
from repro.models.diffusion import mmdit as jmmdit
from repro.models.diffusion import sampler as jsampler
from repro.models.diffusion import vae as jvae
from repro.runtime import steps as jsteps
from repro_torch.configs import get_arch, get_shape
from repro_torch.convert import mmdit_params_from_jax
from repro_torch.kernels import ref
from repro_torch.models.common import layers as TL
from repro_torch.models.diffusion import sampler as tsampler
from repro_torch.models.diffusion.mmdit import (MMDiT, MMDiTConfig,
                                                make_v_fn, perturb_zero_init_)
from repro_torch.runtime.steps import build_cell_program

FLUX = jget_arch("flux-dev")
REDUCED = FLUX.make_reduced()
JCFG = REDUCED.net._replace(use_pallas=True)
# the multi-step tests run JAX's plain attention: four steps of Pallas
# interpret mode under lax.scan take seconds to trace, and the forward
# test already holds the port against the Pallas path
JCFG_PLAIN = REDUCED.net


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * scale)


def _bits(a) -> np.ndarray:
    """bf16 values as their 16-bit patterns, from JAX or PyTorch."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _port_config(jcfg, **kw) -> MMDiTConfig:
    return MMDiTConfig(**{f: getattr(jcfg, f) for f in MMDiTConfig._fields
                          if f != "use_pallas"}, **kw)


def _jit_init(init, cfg, seed: int):
    """A JAX initialiser, jitted (eager dispatch of every op takes
    seconds on the CPU), as numpy."""
    return jax_params_numpy(jax.jit(lambda k: init(k, cfg))(
        jax.random.key(seed)))


def _perturb(trees, seed: int, std: float = 0.02):
    rng = np.random.default_rng(seed + 100)
    for tree in trees:
        for name in ("w", "b"):
            tree[name] = rng.normal(0.0, std, tree[name].shape).astype(
                np.float32)


def _perturbed_params(jcfg, seed: int = 0):
    p = _jit_init(jmmdit.init_mmdit, jcfg, seed)
    _perturb([p["double"]["img"]["mod"], p["double"]["txt"]["mod"],
              p["single"]["mod"], p["final_mod"], p["final_proj"]], seed)
    return p


def _port_mmdit(params, jcfg, **kw) -> MMDiT:
    m = MMDiT(_port_config(jcfg, **kw), device="cpu")
    m.load_state_dict(mmdit_params_from_jax(params))
    return m.eval()


def _inputs(jcfg, batch: int, seed: int, guidance: bool = False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, jcfg.img_res, jcfg.img_res, jcfg.in_ch))
    ctx = {"txt": rng.normal(size=(batch, jcfg.txt_len, jcfg.txt_dim)),
           "vec": rng.normal(size=(batch, jcfg.vec_dim))}
    if guidance:
        ctx["guidance"] = rng.uniform(1.0, 5.0, size=(batch,))
    return (x.astype(np.float32),
            {k: v.astype(np.float32) for k, v in ctx.items()})


def _jctx(ctx):
    return {k: jnp.asarray(v) for k, v in ctx.items()}


def _tctx(ctx):
    return {k: torch.from_numpy(v) for k, v in ctx.items()}


@pytest.fixture(scope="module")
def params():
    return _perturbed_params(JCFG, seed=0)


def test_converted_state_dict_is_complete(params):
    sd = mmdit_params_from_jax(params)
    model = _port_mmdit(params, JCFG)
    assert set(sd) == set(model.state_dict())
    assert sum(t.numel() for t in sd.values()) == sum(
        np.asarray(a).size for a in jax.tree_util.tree_leaves(params))
    # the JAX tree's block axis became one module per block
    assert "double.1.txt.k_norm.scale" in sd and "single.1.linear2.weight" \
        in sd


@pytest.fixture(scope="module")
def jax_forward(params):
    """JAX's velocity (Pallas attention, interpret mode) on the forward
    test's inputs, once per guidance setting."""
    memo = {}

    def get(guidance: bool):
        if guidance not in memo:
            x, ctx = _inputs(JCFG, 2, seed=1, guidance=guidance)
            t = np.array([0.93, 0.27], np.float32)
            memo[guidance] = (x, t, ctx, np.asarray(jmmdit.apply_mmdit(
                params, JCFG, jnp.asarray(x), jnp.asarray(t), _jctx(ctx))))
        return memo[guidance]
    return get


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("guidance", [False, True])
def test_mmdit_forward_matches_jax(params, jax_forward, kernels, guidance):
    """One velocity forward; ``kernels`` sets the port's use_pallas (the
    dispatch takes the plain version on CPU tensors either way)."""
    x, t, ctx, want = jax_forward(guidance)
    assert float(np.abs(want).max()) > 1e-2         # the heads are live
    model = _port_mmdit(params, JCFG, use_pallas=kernels)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t), _tctx(ctx))
    assert got.shape == want.shape
    _close(got, want)


def test_own_init_is_jaxs_zero_velocity_until_perturbed():
    """The port's init mirrors JAX's: every gate and the output head are
    zero, so the velocity is exactly 0, in both packages; perturbing the
    zero-initialised layers makes it live."""
    x, ctx = _inputs(JCFG, 2, seed=2)
    t = np.array([0.5, 0.1], np.float32)
    jp = _jit_init(jmmdit.init_mmdit, JCFG_PLAIN, 4)
    assert float(jnp.abs(jmmdit.apply_mmdit(
        jp, JCFG_PLAIN, jnp.asarray(x), jnp.asarray(t),
        _jctx(ctx))).max()) == 0.0
    gen = torch.Generator().manual_seed(0)
    model = MMDiT(_port_config(JCFG), device="cpu", generator=gen).eval()
    w = model.single[0].linear1.weight
    assert abs(float(w.std()) * JCFG.d_model ** 0.5 - 1.0) < 0.05
    assert float(model.img_in.bias.abs().max()) == 0.0
    args = (torch.from_numpy(x), torch.from_numpy(t), _tctx(ctx))
    with torch.no_grad():
        assert float(model(*args).abs().max()) == 0.0
        perturb_zero_init_(model, gen)
        assert float(model(*args).abs().max()) > 1e-3


def test_set_img_res_keeps_every_other_weight():
    gen = torch.Generator().manual_seed(1)
    model = MMDiT(_port_config(JCFG), device="cpu", generator=gen)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.set_img_res(16, generator=gen)
    assert model.cfg.img_res == 16 and model.img_pos.shape == (64, 96)
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before
               if k != "img_pos")
    x, ctx = _inputs(model.cfg, 1, seed=3)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.tensor([0.5]), _tctx(ctx))
    assert out.shape == (1, 16, 16, 4)


@pytest.mark.parametrize("arch_id", ["flux-dev", "dit-b2"])
def test_gen_step_matches_jax(arch_id):
    """One denoising step of ``build_cell_program(arch, gen_fast,
    reduced=True)``: the Euler step of the MMDiT, the DDIM step of the
    DiT, f32, same weights and inputs."""
    jarch = jget_arch(arch_id)
    jprog = jsteps.build_cell_program(jarch, jget_shape("diffusion",
                                                        "gen_fast"),
                                      reduced=True)
    prog = build_cell_program(get_arch(arch_id),
                              get_shape("diffusion", "gen_fast"),
                              reduced=True, device="cpu")
    (x_shape, x_dt), (t_shape, _), _, ctx_shapes = prog.arg_shapes
    assert tuple(x_shape) == jprog.args_sds[1].shape and x_dt == \
        torch.float32
    assert tuple(t_shape) == jprog.args_sds[2].shape
    rng = np.random.default_rng(5)
    x = rng.normal(size=x_shape).astype(np.float32)
    t = np.array([999, 999], np.int32)
    t_prev = np.array(749, np.int32)
    if arch_id == "flux-dev":
        net_j = _perturbed_params(jprog.arch.make_reduced().net, seed=6)
        net_t = _port_mmdit(net_j, jprog.arch.make_reduced().net)
        ctx = {k: rng.normal(size=s).astype(np.float32)
               for k, (s, _) in ctx_shapes.items()}
        jc, tc = _jctx(ctx), _tctx(ctx)
    else:
        jcfg = jprog.arch.make_reduced().net
        net_j = _jit_init(jdit.init_dit, jcfg, 6)
        _perturb([net_j["blocks"]["ada"], net_j["final_ada"],
                  net_j["final_proj"]], 6)
        net_t = port_dit(net_j, jcfg)
        ctx = rng.normal(size=ctx_shapes[0]).astype(np.float32)
        jc, tc = jnp.asarray(ctx), torch.from_numpy(ctx)
    want = jprog.step_fn(net_j, jnp.asarray(x), jnp.asarray(t),
                         jnp.asarray(t_prev), jc)
    with torch.no_grad():
        got = prog.step_fn(net_t, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(t_prev), tc)
    assert float(np.abs(np.asarray(want) - x).max()) > 1e-3   # it moved
    _close(got, want)


class _Recorder:
    """A stand-in network: records the time it was given and returns
    fixed velocities."""

    def __init__(self, v):
        self.v, self.seen = v, []

    def __call__(self, x, t, ctx):
        self.seen.append(t)
        return self.v


def test_gen_step_bf16_arithmetic_is_exact(monkeypatch):
    """The full-size gen step runs in bf16: t / 1000 (bf16 rounds 999 to
    1000 first), dt = (t_prev - t) / 1000 and x + dt·v all in bf16, bit
    for bit as the JAX program computes them."""
    rng = np.random.default_rng(7)
    shape = (5, 4, 4, 4)
    x = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    seen_j = []

    def fake_apply(p, cfg, x_img, t, ctx):
        seen_j.append(t)
        return jnp.asarray(v, jnp.bfloat16)
    monkeypatch.setattr(jmmdit, "apply_mmdit", fake_apply)
    cell = jget_shape("diffusion", "gen_fast")
    jprog = jsteps.build_cell_program(FLUX, cell)
    prog = build_cell_program(get_arch("flux-dev"),
                              get_shape("diffusion", "gen_fast"),
                              device="cpu")
    assert prog.arg_shapes[0][1] == torch.bfloat16
    assert jprog.args_sds[1].dtype == jnp.bfloat16
    rec = _Recorder(torch.from_numpy(v).to(torch.bfloat16))
    xb_j = jnp.asarray(x, jnp.bfloat16)
    xb_t = torch.from_numpy(x).to(torch.bfloat16)
    assert np.array_equal(_bits(xb_j), _bits(xb_t))
    for t0, t_prev in ((999, 749), (998, 997), (600, 0), (1, 0), (750, 499)):
        t = np.array([t0, t0, 3, 400, 999], np.int32)
        want = jprog.step_fn(None, xb_j, jnp.asarray(t),
                             jnp.asarray(np.int32(t_prev)), None)
        got = prog.step_fn(rec, xb_t, torch.from_numpy(t),
                           torch.tensor(t_prev, dtype=torch.int32), None)
        assert got.dtype == torch.bfloat16
        assert np.array_equal(_bits(rec.seen[-1]), _bits(seen_j[-1]))
        assert np.array_equal(_bits(got), _bits(want))
    # bf16 rounds t = 999 to 1000: the network sees t = 1.0
    assert float(rec.seen[0][0]) == 1.0


def test_mmdit_time_input_rounds_in_bf16(monkeypatch):
    """``apply_mmdit`` computes t * 1000 in t's dtype before the f32
    embedding: bf16 rounds it there."""
    seen = []
    real = TL.timestep_embedding

    def spy(t, dim, **kw):
        seen.append(t)
        return real(t, dim, **kw)
    monkeypatch.setattr(TL, "timestep_embedding", spy)
    gen = torch.Generator().manual_seed(2)
    model = MMDiT(_port_config(JCFG), device="cpu", dtype=torch.bfloat16,
                  generator=gen).eval()
    t = np.array([0.999, 0.3337, 0.6015625, 0.0078125], np.float32)
    tb = torch.from_numpy(t).to(torch.bfloat16)
    x, ctx = _inputs(JCFG, 4, seed=4)
    with torch.no_grad():
        model(torch.from_numpy(x).to(torch.bfloat16), tb, _tctx(ctx))
    want = jnp.asarray(t, jnp.bfloat16) * 1000.0
    assert seen[0].dtype == torch.bfloat16
    assert np.array_equal(_bits(seen[0]), _bits(want))


# 7 and 28: counts where a true division by ``steps`` would differ from
# XLA's product with the reciprocal
@pytest.mark.parametrize("steps", [1, 4, 7, 28, 50])
@pytest.mark.parametrize("t_start", [1.0, 0.6])
@pytest.mark.parametrize("shift", [1.0, 3.0])
def test_rf_timesteps_match_jax(steps, t_start, shift):
    """Element for element, bit for bit."""
    want = np.asarray(jsampler.rf_timesteps(steps, t_start=t_start,
                                            shift=shift))
    got = tsampler.rf_timesteps(steps, t_start=t_start, shift=shift)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_rf_sample_bf16_update_is_exact():
    """``rf_sample`` at bf16: the network sees t rounded to bf16, and the
    update promotes to f32 (ts is f32) before the cast back — bit for bit
    as JAX promotes it.  The stand-in network returns v = x (JAX traces
    the scan body once, so the velocity must be a function of x)."""
    rng = np.random.default_rng(8)
    shape = (3, 4, 4, 4)
    x0 = rng.normal(size=shape).astype(np.float32)
    want = jsampler.rf_sample(lambda x, t, ctx: x, shape, None,
                              jax.random.PRNGKey(0), steps=4, shift=3.0,
                              t_start=0.6,
                              x_init=jnp.asarray(x0, jnp.bfloat16),
                              dtype=jnp.bfloat16)
    seen = []

    def v_t(x, t, ctx):
        seen.append(t)
        return x
    got = tsampler.rf_sample(v_t, shape, None, steps=4, shift=3.0,
                             t_start=0.6,
                             x_init=torch.from_numpy(x0).to(torch.bfloat16),
                             dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and len(seen) == 4
    assert np.array_equal(_bits(got), _bits(want))
    ts = tsampler.rf_timesteps(4, t_start=0.6, shift=3.0)
    for i, t in enumerate(seen):
        assert np.array_equal(
            _bits(t), _bits(jnp.full((3,), ts[i], jnp.bfloat16)))


def _jax_noise(shape, seed: int, dtype=jnp.float32):
    """The draw JAX's ``rf_edit`` makes from ``PRNGKey(seed)``."""
    return jax.random.normal(jax.random.PRNGKey(seed), shape, dtype)


def test_rf_sample_and_rf_edit_match_jax(params):
    """Four Euler steps of the reduced MMDiT: ``rf_sample`` from a given
    x_init, and ``rf_edit`` with JAX's noise injected — against JAX's
    ``rf_edit`` and ``rf_sample(x_init=...)``."""
    shape = (2, JCFG.img_res, JCFG.img_res, JCFG.in_ch)
    ref_lat, ctx = _inputs(JCFG, 2, seed=9)
    v_j = jmmdit.make_v_fn(params, JCFG_PLAIN)
    v_t = make_v_fn(_port_mmdit(params, JCFG))
    key = jax.random.PRNGKey(11)
    noise = np.asarray(_jax_noise(shape, 11))
    want = jsampler.rf_edit(v_j, jnp.asarray(ref_lat), _jctx(ctx), key,
                            steps=4, strength=0.6, shift=3.0)
    x_init = (1.0 - 0.6) * ref_lat + 0.6 * noise
    want_s = jsampler.rf_sample(v_j, shape, _jctx(ctx), key, steps=4,
                                shift=3.0, x_init=jnp.asarray(x_init),
                                t_start=0.6)
    with torch.no_grad():
        got = tsampler.rf_edit(v_t, torch.from_numpy(ref_lat), _tctx(ctx),
                               steps=4, strength=0.6, shift=3.0,
                               noise=torch.from_numpy(noise))
        got_s = tsampler.rf_sample(v_t, shape, _tctx(ctx), steps=4,
                                   shift=3.0,
                                   x_init=torch.from_numpy(x_init),
                                   t_start=0.6)
    assert float(np.abs(np.asarray(want) - x_init).max()) > 1e-2
    _close(got, want, rel=1e-4)
    _close(got_s, want_s, rel=1e-4)


def test_rf_edit_draws_from_its_generator():
    shape = (2, 4, 4, 4)
    ref_lat = torch.zeros(shape)

    def v(x, t, ctx):
        return torch.zeros_like(x)
    a = tsampler.rf_edit(v, ref_lat, None, steps=2,
                         generator=torch.Generator().manual_seed(3))
    b = tsampler.rf_edit(v, ref_lat, None, steps=2,
                         generator=torch.Generator().manual_seed(3))
    c = tsampler.rf_edit(v, ref_lat, None, steps=2,
                         generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # v = 0: the start is (1 - t) ref + t eps = 0.6 eps, left unchanged
    noise = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, 0.6 * noise)


def test_vae_rf_edit_decode_composite_matches_jax(params):
    """The edit path of the smoke at reduced size: the reference images'
    latent means from the VAE, ``rf_edit`` (4 steps, strength 0.6, JAX's
    noise injected), then a decode — against the same JAX composite."""
    vae_j = _jit_init(jvae.init_vae, REDUCED.vae, 12)
    vae_t = port_vae(vae_j, REDUCED.vae)
    rng = np.random.default_rng(13)
    res = JCFG.img_res * REDUCED.vae.downsample
    imgs = rng.uniform(-1, 1, size=(2, res, res, 3)).astype(np.float32)
    _, ctx = _inputs(JCFG, 2, seed=14)
    noise = np.asarray(_jax_noise((2, JCFG.img_res, JCFG.img_res, 4), 15))
    mean_j, _ = jax.jit(lambda p, x: jvae.encode(p, REDUCED.vae, x))(
        vae_j, jnp.asarray(imgs))
    z_j = jsampler.rf_edit(jmmdit.make_v_fn(params, JCFG_PLAIN), mean_j,
                           _jctx(ctx), jax.random.PRNGKey(15), steps=4,
                           strength=0.6)
    want = jax.jit(lambda p, z: jvae.decode(p, REDUCED.vae, z))(vae_j, z_j)
    with torch.no_grad():
        mean_t, _ = vae_t.encode(torch.from_numpy(imgs))
        z_t = tsampler.rf_edit(make_v_fn(_port_mmdit(params, JCFG)), mean_t,
                               _tctx(ctx), steps=4, strength=0.6,
                               noise=torch.from_numpy(noise))
        got = vae_t.decode(z_t)
    _close(mean_t, mean_j)
    _close(z_t, z_j, rel=1e-4)
    _close(got, want, rel=1e-4)


@pytest.mark.parametrize("b,sq,sk,h,d", [
    (2, 40, 40, 3, 128), (1, 72, 72, 2, 64), (2, 33, 47, 2, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_bf16_attention_matches_jax_kernel(b, sq, sk, h, d, causal):
    """K4's plain version at bf16 against JAX's Pallas kernel in interpret
    mode on the same bf16 inputs (the bf16 kernel tolerance of
    ``tests/test_kernels.py``, 2e-2)."""
    rng = np.random.default_rng(sq + d)
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32)
               for n in (sq, sk, sk))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jflash(jq, jk, jv, causal=causal, block_q=32, block_k=32,
                  interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("cell_name", ["gen_1024", "gen_fast", "train_256",
                                       "train_1024"])
def test_configs_match_jax(cell_name):
    jcell = jget_shape("diffusion", cell_name)
    cell = get_shape("diffusion", cell_name)
    assert cell == type(cell)(**{f: getattr(jcell, f) for f in
                                 jcell.__dataclass_fields__})
    for arch_id in ("flux-dev", "dit-b2"):
        jcfg = jget_arch(arch_id).make_config(jcell)
        cfg = get_arch(arch_id).make_config(cell)
        assert cfg.backbone == jcfg.backbone
        assert tuple(cfg.vae) == tuple(jcfg.vae)
        assert (cfg.ctx_len, cfg.ctx_dim, cfg.pooled_dim) == (
            jcfg.ctx_len, jcfg.ctx_dim, jcfg.pooled_dim)
        for f in cfg.net._fields:
            if not f.startswith("use_pallas"):
                assert getattr(cfg.net, f) == getattr(jcfg.net, f), f
        assert cfg.net.use_pallas          # the port's kernels default on
    full = get_arch("flux-dev").make_config(get_shape("diffusion",
                                                      "gen_1024")).net
    assert (full.img_res, full.n_img_tokens, full.head_dim) == (128, 4096,
                                                                128)


def test_full_width_parameter_count():
    """flux-dev at full width: ≈11.9 B parameters, 23.8 GB in bf16
    (counted on the meta device, nothing allocated)."""
    cfg = get_arch("flux-dev").make_config(get_shape("diffusion",
                                                     "gen_1024")).net
    model = MMDiT(cfg, device="meta", dtype=torch.bfloat16)
    n = sum(p.numel() for p in model.parameters())
    d, hid = 3072, 12288
    dbl = 2 * ((6 * d + 3 * d + d + 2 * hid) * d + 6 * d + hid + d
               + 2 * 128)
    sgl = (3 * d + 3 * d + hid) * d + 3 * d + (d + hid) * d + 2 * 128
    assert n == 19 * dbl + 38 * sgl + sum(
        p.numel() for name, p in model.named_parameters()
        if not name.startswith(("double.", "single.")))
    assert 11.8e9 < n < 12.0e9


def test_unported_ids_and_kinds_say_so():
    with pytest.raises(NotImplementedError, match="not ported"):
        get_arch("unet-sd15")
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
    with pytest.raises(NotImplementedError, match="not ported"):
        build_cell_program(get_arch("flux-dev"),
                           get_shape("diffusion", "train_256"),
                           device="cpu")
