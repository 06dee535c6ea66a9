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
  ``blocks.<i>.``.  So are the MMDiT's ``double``/``single`` blocks
  (``mmdit.py:92-95``, into ``double.<i>.`` and ``single.<i>.``) and the
  text encoder's ``blocks`` (``text_encoder.py:43-44``).
* RMSNorm and LayerNorm ``{"scale"[, "bias"]}`` and the plain arrays
  (``img_pos``, ``embed``, ``pos``) keep their names.
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


def _norm(out, prefix: str, p: Mapping) -> None:
    for name in ("scale", "bias"):
        if name in p:
            out[prefix + name] = _t(p[name])


def _blocks(tree) -> int:
    """The length of a stacked (vmapped) block tree's leading axis."""
    leaf = tree
    while isinstance(leaf, Mapping):
        leaf = next(iter(leaf.values()))
    return np.asarray(leaf).shape[0]


def _stream(out, prefix: str, p: Mapping) -> None:
    for name in ("mod", "qkv", "proj"):
        _dense(out, f"{prefix}{name}.", p[name])
    _mlp(out, prefix + "mlp.", p["mlp"])
    _norm(out, prefix + "q_norm.", p["q_norm"])
    _norm(out, prefix + "k_norm.", p["k_norm"])


def mmdit_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``init_mmdit`` tree (numpy leaves) -> ``MMDiT.state_dict()``."""
    out: Dict[str, torch.Tensor] = {}
    for name in ("img_in", "txt_in", "final_mod", "final_proj"):
        _dense(out, name + ".", params[name])
    for name in ("time_mlp", "vec_mlp", "guidance_mlp"):
        _mlp(out, name + ".", params[name])
    out["img_pos"] = _t(params["img_pos"])
    for i in range(_blocks(params["double"])):
        blk = _index_tree(params["double"], i)
        for side in ("img", "txt"):
            _stream(out, f"double.{i}.{side}.", blk[side])
    for i in range(_blocks(params["single"])):
        blk = _index_tree(params["single"], i)
        pre = f"single.{i}."
        for name in ("mod", "linear1", "linear2"):
            _dense(out, pre + name + ".", blk[name])
        _norm(out, pre + "q_norm.", blk["q_norm"])
        _norm(out, pre + "k_norm.", blk["k_norm"])
    return out


def text_encoder_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``init_text_encoder`` tree (numpy leaves) ->
    ``TextEncoder.state_dict()``."""
    out: Dict[str, torch.Tensor] = {"embed": _t(params["embed"]),
                                    "pos": _t(params["pos"])}
    for i in range(_blocks(params["blocks"])):
        blk = _index_tree(params["blocks"], i)
        pre = f"blocks.{i}."
        _norm(out, pre + "ln1.", blk["ln1"])
        _norm(out, pre + "ln2.", blk["ln2"])
        _dense(out, pre + "qkv.", blk["qkv"])
        _dense(out, pre + "proj.", blk["proj"])
        _mlp(out, pre + "mlp.", blk["mlp"])
    _norm(out, "ln_f.", params["ln_f"])
    _dense(out, "to_ctx.", params["to_ctx"])
    _dense(out, "to_pool.", params["to_pool"])
    return out
