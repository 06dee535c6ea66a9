"""GroupNorm+SiLU (K6) and the VAE that runs it, the port against the JAX
package, on the CPU.

* ``groupnorm_silu_ref`` (what ``ops.groupnorm_silu`` runs on a CPU
  tensor) against the Pallas kernel ``groupnorm_silu(interpret=True)``,
  including the shrink rule for groups (C = 48 gives 24 groups) and the
  reduced configs' ``groups=8``.
* The port's VAE with ``use_pallas`` against the JAX VAE's
  ``encode``/``decode(use_pallas=True)`` on ``REDUCED_VAE``.

Tolerances: the kernel tests' 2e-5 (``_torch_parity.KERNEL_TOL``) for one
normalisation; one VAE pass to 1e-5 of its output scale, as in
``tests/test_torch_dit_vae.py``."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import KERNEL_TOL, jax_vae, port_vae
from repro.configs.diffusion_common import REDUCED_VAE
from repro.kernels.groupnorm_silu import groupnorm_silu as jgroupnorm_silu
from repro.models.diffusion import vae as jvae
from repro_torch.kernels import groupnorm_silu as tgn
from repro_torch.kernels import ops, ref


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    scale = rng.normal(1.0, 0.3, size=(c,)).astype(np.float32)
    bias = rng.normal(0.0, 0.3, size=(c,)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape,groups", [
    ((2, 8, 8, 64), 32), ((1, 16, 16, 128), 32), ((3, 5, 7, 48), 32),
    ((2, 6, 6, 32), 8)])
def test_groupnorm_silu_ref_matches_pallas(shape, groups):
    x, scale, bias = _inputs(shape, seed=shape[-1] + groups)
    want = np.asarray(jgroupnorm_silu(jnp.asarray(x), jnp.asarray(scale),
                                      jnp.asarray(bias), groups=groups,
                                      interpret=True))
    args = [torch.from_numpy(a) for a in (x, scale, bias)]
    got = ref.groupnorm_silu_ref(*args, groups=groups)
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)
    # the dispatch takes the plain version for a CPU tensor
    torch.testing.assert_close(ops.groupnorm_silu(*args, groups=groups), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("c,groups,want", [(48, 32, 24), (128, 32, 32),
                                           (16, 32, 16), (32, 8, 8),
                                           (12, 8, 6)])
def test_group_count_shrinks_until_it_divides(c, groups, want):
    assert tgn.num_groups(c, groups) == want


def test_wrapper_refuses_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only; ``ops`` sends CPU
    tensors to the plain version instead."""
    x, scale, bias = (torch.from_numpy(a) for a in _inputs((1, 4, 4, 8), 0))
    with pytest.raises(ValueError, match="CUDA"):
        tgn.launch(x, scale, bias)


@pytest.fixture(scope="module")
def reduced_vae():
    return jax_vae(REDUCED_VAE, seed=5)


def test_vae_with_kernels_matches_jax_pallas_vae(reduced_vae):
    rng = np.random.default_rng(7)
    img = rng.uniform(-1, 1, size=(2, 16, 16, 3)).astype(np.float32)
    z = rng.normal(size=(2, 4, 4, 4)).astype(np.float32)
    j_mean, j_logvar = jvae.encode(reduced_vae, REDUCED_VAE,
                                   jnp.asarray(img), use_pallas=True)
    j_img = jvae.decode(reduced_vae, REDUCED_VAE, jnp.asarray(z),
                        use_pallas=True)
    vae = port_vae(reduced_vae, REDUCED_VAE)
    assert vae.use_pallas and all(
        m.use_pallas for m in vae.modules() if hasattr(m, "norm1"))
    with torch.no_grad():
        mean, logvar = vae.encode(torch.from_numpy(img))
        dec = vae.decode(torch.from_numpy(z))
    for got, want in ((mean, j_mean), (logvar, j_logvar), (dec, j_img)):
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * scale)


def test_vae_kernel_flag_changes_nothing_on_the_cpu(reduced_vae):
    """On CPU tensors the dispatch runs the plain version, so the VAE
    with and without ``use_pallas`` gives the same bits."""
    from repro_torch.convert import vae_params_from_jax
    from repro_torch.models.diffusion.vae import VAE, VAEConfig
    plain = VAE(VAEConfig(*REDUCED_VAE), use_pallas=False)
    plain.load_state_dict(vae_params_from_jax(reduced_vae))
    fused = port_vae(reduced_vae, REDUCED_VAE)
    x = torch.from_numpy(np.random.default_rng(8).uniform(
        -1, 1, size=(1, 16, 16, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(plain.eval().encode(x)[0], fused.encode(x)[0])
