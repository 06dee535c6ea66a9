"""Convert the JAX package's parameter pytrees into the port's
``state_dict``s.

The input is the JAX parameter tree with every leaf already a numpy
array (``jax.device_get(params)``); this module never imports JAX.

* Dense ``{"w": (in, out), "b"}`` becomes ``nn.Linear`` ``weight``
  (out, in) and ``bias``.
* Conv ``{"w": (kh, kw, in, out) HWIO, "b"}`` becomes
  :class:`repro_torch.models.common.layers.Conv` ``weight``
  (out, in, kh, kw); activations stay NHWC on both sides.
* GroupNorm ``{"scale", "bias"}`` keeps its names.
* The DiT's blocks are stacked on a leading layer axis for ``lax.scan``
  (``dit.py:63-65`` of the JAX package); they are unstacked into
  ``blocks.<i>.``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _dense(out: Dict[str, torch.Tensor], prefix: str, p: Mapping) -> None:
    out[prefix + "weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        out[prefix + "bias"] = _t(p["b"])


def _mlp(out, prefix: str, p: Mapping) -> None:
    _dense(out, prefix + "fc1.", p["fc1"])
    _dense(out, prefix + "fc2.", p["fc2"])


def dit_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``init_dit`` tree (numpy leaves) -> ``DiT.state_dict()``."""
    out: Dict[str, torch.Tensor] = {}
    _dense(out, "patch_embed.", params["patch_embed"])
    out["pos_embed"] = _t(params["pos_embed"])
    _mlp(out, "t_mlp.", params["t_mlp"])
    _dense(out, "ctx_proj.", params["ctx_proj"])
    blocks = params["blocks"]
    n_layers = np.asarray(blocks["qkv"]["w"]).shape[0]
    for i in range(n_layers):
        layer = _index_tree(blocks, i)
        pre = f"blocks.{i}."
        for name in ("qkv", "proj", "ada"):
            _dense(out, pre + name + ".", layer[name])
        _mlp(out, pre + "mlp.", layer["mlp"])
    _dense(out, "final_ada.", params["final_ada"])
    _dense(out, "final_proj.", params["final_proj"])
    return out


def _index_tree(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def vae_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``init_vae`` tree (numpy leaves) -> ``VAE.state_dict()``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node: Mapping) -> None:
        if "w" in node:                               # conv
            out[prefix + "weight"] = _t(
                np.transpose(np.asarray(node["w"]), (3, 2, 0, 1)))
            out[prefix + "bias"] = _t(node["b"])
        elif "scale" in node:                         # group norm
            out[prefix + "scale"] = _t(node["scale"])
            out[prefix + "bias"] = _t(node["bias"])
        else:
            for name, child in node.items():
                walk(f"{prefix}{name}.", child)

    walk("", params)
    return out
