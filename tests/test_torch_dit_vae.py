"""The port's DiT, VAE and DDIM sampler against the JAX package's, through
``repro_torch.convert``, on the CPU.

Weights are JAX-initialised (``init_dit``/``init_vae``) with the
zero-initialised adaLN heads drawn from N(0, 0.02), converted, and the
same numpy inputs go through both.  Tolerances: one DiT/VAE forward to
1e-5 of the output scale (f32 matmuls and convolutions in two
frameworks); three DDIM steps to 1e-4 (the per-step error feeds the next
step)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (jax_noise_fn, jax_vae, perturbed_jax_dit,
                           port_dit, port_dit_config, port_schedule, port_vae)
from repro.configs import get_arch
from repro.models.diffusion import dit as jdit
from repro.models.diffusion import sampler as jsampler
from repro.models.diffusion import vae as jvae
from repro.models.diffusion.dit import DiTConfig as JDiTConfig
from repro.models.diffusion.schedule import DiffusionSchedule as JSchedule
from repro_torch.convert import dit_params_from_jax, vae_params_from_jax
from repro_torch.models.diffusion import sampler as tsampler
from repro_torch.models.diffusion.dit import DiT, make_eps_fn
from repro_torch.models.diffusion.vae import VAE, VAEConfig

SD15 = get_arch("sd15-small").make_config(None)
# dit-b2 width (768 wide, 12 heads, patch 2), cut to 2 layers and a
# 16-token latent so it runs on the CPU in a second
DIT_B2_2L = JDiTConfig(img_res=8, in_ch=4, patch=2, n_layers=2, d_model=768,
                       n_heads=12, ctx_dim=512)


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * scale)


@pytest.fixture(scope="module")
def sd15_dit():
    return perturbed_jax_dit(SD15.net, seed=0)


@pytest.fixture(scope="module")
def sd15_vae():
    return jax_vae(SD15.vae, seed=1)


def test_converted_state_dicts_are_complete(sd15_dit, sd15_vae):
    """Every parameter of the port's modules comes from the JAX tree, and
    nothing is left over."""
    tdit = dit_params_from_jax(sd15_dit)
    assert set(tdit) == set(port_dit(sd15_dit, SD15.net).state_dict())
    n_jax = sum(np.asarray(a).size
                for a in jax.tree_util.tree_leaves(sd15_dit))
    assert sum(t.numel() for t in tdit.values()) == n_jax
    tvae = vae_params_from_jax(sd15_vae)
    assert set(tvae) == set(port_vae(sd15_vae, SD15.vae).state_dict())
    assert sum(t.numel() for t in tvae.values()) == sum(
        np.asarray(a).size for a in jax.tree_util.tree_leaves(sd15_vae))


@pytest.mark.parametrize("jcfg", [SD15.net, DIT_B2_2L],
                         ids=["sd15-small", "dit-b2-width-2L"])
@pytest.mark.parametrize("kernels", [True, False])
def test_dit_forward_matches_jax(jcfg, kernels):
    """One eps forward; ``kernels`` sets the port's use_pallas flags (the
    dispatch takes the plain versions on CPU tensors either way)."""
    params = perturbed_jax_dit(jcfg, seed=3)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, jcfg.img_res, jcfg.img_res, jcfg.in_ch))
    x = x.astype(np.float32)
    t = np.array([7, 640], np.int32)
    ctx = rng.normal(size=(2, jcfg.ctx_dim)).astype(np.float32)
    want = jdit.apply_dit(params, jcfg, jnp.asarray(x), jnp.asarray(t),
                          jnp.asarray(ctx))
    assert float(jnp.abs(want).max()) > 1e-2      # the heads are live
    model = port_dit(params, jcfg, use_pallas=kernels,
                     use_pallas_adaln=kernels)
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (x, t, ctx)))
    _close(got, want)


def test_vae_encode_decode_match_jax(sd15_vae):
    rng = np.random.default_rng(1)
    vae = port_vae(sd15_vae, SD15.vae)
    img = rng.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    j_mean, j_logvar = jvae.encode(sd15_vae, SD15.vae, jnp.asarray(img))
    z = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    j_img = jvae.decode(sd15_vae, SD15.vae, jnp.asarray(z))
    with torch.no_grad():
        mean, logvar = vae.encode(torch.from_numpy(img))
        dec = vae.decode(torch.from_numpy(z))
    _close(mean, j_mean)
    _close(logvar, j_logvar)
    _close(dec, j_img)


def test_seeded_init_has_the_jax_statistics():
    """The port's own seeded init: N(0, 1/fan_in) weights, zero biases and
    zero adaLN heads (so an untouched DiT predicts eps = 0)."""
    m = DiT(port_dit_config(DIT_B2_2L),
            generator=torch.Generator().manual_seed(0))
    v = VAE(VAEConfig(*SD15.vae), generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, 8, 8, 4, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        w = m.blocks[0].mlp.fc1.weight
        assert abs(float(w.std()) * 768 ** 0.5 - 1.0) < 0.02
        assert float(m.blocks[1].ada.weight.abs().max()) == 0.0
        eps = m(x, torch.tensor([5]), torch.zeros(1, 512))
        assert float(eps.abs().max()) == 0.0
        assert float(v.enc["stem"].bias.abs().max()) == 0.0


@pytest.mark.parametrize("img2img", [False, True])
def test_three_step_ddim_matches_jax(sd15_dit, img2img):
    """3 DDIM steps from the same initial noise (txt2img), or from the
    same SDEdit start of a reference latent (img2img)."""
    jsched = JSchedule.linear(1000)
    tsched = port_schedule(jsched)
    rng = np.random.default_rng(2)
    shape = (2, 8, 8, 4)
    ctx = rng.normal(size=(2, 512)).astype(np.float32)
    noise = jax_noise_fn([3, 4], shape[1:], "cpu").numpy()
    eps_j = jdit.make_eps_fn(sd15_dit, SD15.net)
    eps_t = make_eps_fn(port_dit(sd15_dit, SD15.net))
    t_start = None
    x_j = x_t = noise
    if img2img:
        ref = rng.normal(size=shape).astype(np.float32)
        x_j, t_start = jsampler.sdedit_start(jsched, jnp.asarray(ref),
                                             jnp.asarray(noise), strength=0.6)
        x_t, t_start_t = tsampler.sdedit_start(
            tsched, torch.from_numpy(ref), torch.from_numpy(noise),
            strength=0.6)
        assert t_start_t == t_start
        _close(x_t, x_j)
    want = jsampler.ddim_sample(eps_j, jsched, shape, jnp.asarray(ctx),
                                jax.random.PRNGKey(0), steps=3,
                                x_init=jnp.asarray(x_j), t_start=t_start)
    with torch.no_grad():
        got = tsampler.ddim_sample(eps_t, tsched, shape,
                                   torch.from_numpy(ctx), steps=3,
                                   x_init=torch.as_tensor(np.asarray(x_t)),
                                   t_start=t_start)
    _close(got, want, rel=1e-4)


def test_ddim_timesteps_match_jax():
    for steps, t_start in ((30, None), (20, 600), (3, None), (1, 600)):
        np.testing.assert_array_equal(
            tsampler.ddim_timesteps(1000, steps, t_start=t_start),
            jsampler.ddim_timesteps(1000, steps, t_start=t_start))
