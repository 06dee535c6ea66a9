"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``):
the same seeded inputs go through the JAX package and the port.  JAX and
PyTorch meet only as numpy arrays."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.diffusion import dit as jdit
from repro.models.diffusion import vae as jvae
from repro_torch.convert import dit_params_from_jax, vae_params_from_jax
from repro_torch.models.diffusion.dit import DiT, DiTConfig
from repro_torch.models.diffusion.schedule import DiffusionSchedule
from repro_torch.models.diffusion.vae import VAE, VAEConfig

# f32 agreement of two frameworks' arithmetic (the kernel tests' 2e-5,
# tests/test_kernels.py) — for one layer or one kernel
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)


def jax_params_numpy(params):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  jax.device_get(params))


def perturbed_jax_dit(cfg, seed: int = 0, std: float = 0.02):
    """JAX ``init_dit`` params as numpy, with the zero-initialised adaLN
    and output heads drawn from N(0, std) — an untouched DiT predicts
    eps = 0 and a comparison would check nothing."""
    p = jax_params_numpy(jdit.init_dit(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed + 100)
    for tree in (p["blocks"]["ada"], p["final_ada"], p["final_proj"]):
        for name in ("w", "b"):
            tree[name] = rng.normal(0.0, std, tree[name].shape).astype(
                np.float32)
    return p


def jax_vae(cfg, seed: int = 1):
    return jax_params_numpy(jvae.init_vae(jax.random.key(seed), cfg))


def port_dit_config(jcfg, **kw) -> DiTConfig:
    """The port's config of the same shape (kernel flags at the port's
    defaults unless given)."""
    fields = {f: getattr(jcfg, f) for f in DiTConfig._fields
              if f not in ("use_pallas", "use_pallas_adaln")}
    return DiTConfig(**fields, **kw)


def port_dit(jparams, jcfg, **kw) -> DiT:
    m = DiT(port_dit_config(jcfg, **kw))
    m.load_state_dict(dit_params_from_jax(jparams))
    return m.eval()


def port_vae(jparams, jcfg) -> VAE:
    m = VAE(VAEConfig(*jcfg))
    m.load_state_dict(vae_params_from_jax(jparams))
    return m.eval()


def port_schedule(jsched) -> DiffusionSchedule:
    """The JAX schedule's own arrays, so the samplers see equal
    coefficients."""
    return DiffusionSchedule(*(torch.from_numpy(np.array(a, np.float32))
                               for a in jsched))


def jax_noise_fn(seeds, shape, device):
    """The JAX serving backend's per-request draw
    (``split(PRNGKey(seed))`` -> ``normal``), handed to the port's
    ``DiffusionBackend`` as its ``noise_fn``."""
    shape = tuple(int(s) for s in shape)

    def one(seed):
        k, _ = jax.random.split(jax.random.PRNGKey(seed))
        return jax.random.normal(k, (1,) + shape)[0]

    arr = np.array(jax.vmap(one)(jnp.asarray(list(seeds), jnp.int32)))
    return torch.from_numpy(arr).to(device)
