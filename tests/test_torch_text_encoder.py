"""The port's hash tokenizer and text encoder against the JAX package's,
on the CPU.

The tokenizer's ids must be equal, element for element.  The text
encoder runs at the size the flux phase of ``chip_smoke.py`` uses
(``TextEncoderConfig(max_len=256)``: 4 layers, 256 wide, 4 heads of 64,
768-wide context, 512-wide pooled vector) with JAX-initialised weights
converted by ``repro_torch.convert``; tolerance 1e-5 of the output scale
(f32 matmuls in two frameworks, the DiT tests' tolerance)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_params_numpy
from repro.data.tokenizer import HashTokenizer as JTokenizer
from repro.models.diffusion import text_encoder as jte
from repro_torch.convert import text_encoder_params_from_jax
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models.diffusion.text_encoder import (TextEncoder,
                                                       TextEncoderConfig)

PROMPTS = [
    "a red fox in the snow, 35mm photo",
    "Watercolor of an old lighthouse at dusk; waves crashing!!",
    "",
    "3 cats & 2 dogs sleeping on a sofa in 1998",
    "l'hôtel de ville — über café, naïve résumé",
    " ".join(["tok"] * 300),                      # longer than max_len
]


@pytest.mark.parametrize("vocab,max_len", [(32768, 256), (32768, 77),
                                           (1000, 16)])
def test_tokenizer_ids_equal_jax(vocab, max_len):
    got = HashTokenizer(vocab).encode_batch(PROMPTS, max_len=max_len)
    want = JTokenizer(vocab).encode_batch(PROMPTS, max_len=max_len)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(HashTokenizer(vocab).lengths(got),
                                  JTokenizer(vocab).lengths(want))


@pytest.fixture(scope="module")
def encoder():
    jcfg = jte.TextEncoderConfig(max_len=256)
    params = jax_params_numpy(jax.jit(
        lambda k: jte.init_text_encoder(k, jcfg))(jax.random.key(3)))
    model = TextEncoder(TextEncoderConfig(*jcfg), device="cpu")
    model.load_state_dict(text_encoder_params_from_jax(params))
    return jcfg, params, model.eval()


def test_converted_state_dict_is_complete(encoder):
    _, params, model = encoder
    sd = text_encoder_params_from_jax(params)
    assert set(sd) == set(model.state_dict())
    assert sum(t.numel() for t in sd.values()) == sum(
        np.asarray(a).size for a in jax.tree_util.tree_leaves(params))


@pytest.mark.parametrize("batch", [PROMPTS[:4], PROMPTS[4:]])
def test_text_encoder_matches_jax(encoder, batch):
    """ctx (B, 256, 768) and pooled (B, 512) from the tokenizer's ids,
    padding included (pooled over the real tokens only; the second batch
    has a prompt longer than max_len)."""
    jcfg, params, model = encoder
    tokens = HashTokenizer().encode_batch(batch, max_len=256)
    ctx_j, pooled_j = jax.jit(
        lambda p, t: jte.apply_text_encoder(p, jcfg, t))(
        params, jnp.asarray(tokens))
    with torch.no_grad():
        ctx_t, pooled_t = model(torch.from_numpy(tokens))
    b = len(batch)
    assert ctx_t.shape == (b, 256, 768) and pooled_t.shape == (b, 512)
    for got, want in ((ctx_t, ctx_j), (pooled_t, pooled_j)):
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * scale)


def test_own_init_has_the_jax_statistics():
    model = TextEncoder(TextEncoderConfig(max_len=256), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert abs(float(model.embed.std()) - 0.02) < 1e-3
        w = model.blocks[0].mlp.fc1.weight
        assert abs(float(w.std()) * 256 ** 0.5 - 1.0) < 0.02
        assert float(model.blocks[0].mlp.fc1.bias.abs().max()) == 0.0
        assert float(model.ln_f.scale.min()) == 1.0
