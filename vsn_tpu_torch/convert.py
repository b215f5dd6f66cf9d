"""JAX parameter tree <-> the port's state_dict.

``state_dict_from_jax`` is the inverse of scripts/golden_parity.py
``port_swin``, with the same transposes: a Dense kernel [in, out] becomes a
Linear weight [out, in]; a Conv kernel [kd, kh, kw, I, O] becomes a Conv3d
weight [O, I, kd, kh, kw]; LayerNorm scale/bias become weight/bias. Every
leaf must match a rule (KeyError otherwise); load the result with
``load_state_dict(strict=True)`` so that any model key left without a leaf
errors too. The maps are linear, so they carry gradients and optimizer
moments as well as parameters. ``jax_params_from_state_dict`` is the
reverse map.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch


def _same(a):
    return a


def _dense(a):
    return a.T


def _conv(a):
    return a.transpose(4, 3, 0, 1, 2)


def _conv_inverse(a):
    return a.transpose(2, 3, 4, 1, 0)


_INVERSE = {_same: _same, _dense: _dense, _conv: _conv_inverse}


_LN = {"scale": "weight", "bias": "bias"}

# (regex over the '/'-joined params path, torch key template, transform);
# the template's {0}, {1}, ... are the regex groups, {ln} maps LN leaves.
_RULES = (
    (r"patch_embed/kernel", "backbone.patch_embed.proj.weight", _conv),
    (r"patch_embed/bias", "backbone.patch_embed.proj.bias", _same),
    (r"patch_embed_norm/(scale|bias)", "backbone.patch_embed.norm.{ln}", _same),
    (r"layer(\d+)/block(\d+)/(norm1|norm2)/(scale|bias)",
     "backbone.layers.{0}.blocks.{1}.{2}.{ln}", _same),
    (r"layer(\d+)/block(\d+)/attn/(qkv|proj)/kernel",
     "backbone.layers.{0}.blocks.{1}.attn.{2}.weight", _dense),
    (r"layer(\d+)/block(\d+)/attn/(qkv|proj)/bias",
     "backbone.layers.{0}.blocks.{1}.attn.{2}.bias", _same),
    (r"layer(\d+)/block(\d+)/attn/relative_position_bias_table",
     "backbone.layers.{0}.blocks.{1}.attn.relative_position_bias_table",
     _same),
    (r"layer(\d+)/block(\d+)/mlp/fc1/kernel",
     "backbone.layers.{0}.blocks.{1}.mlp.0.weight", _dense),
    (r"layer(\d+)/block(\d+)/mlp/fc1/bias",
     "backbone.layers.{0}.blocks.{1}.mlp.0.bias", _same),
    (r"layer(\d+)/block(\d+)/mlp/fc2/kernel",
     "backbone.layers.{0}.blocks.{1}.mlp.3.weight", _dense),
    (r"layer(\d+)/block(\d+)/mlp/fc2/bias",
     "backbone.layers.{0}.blocks.{1}.mlp.3.bias", _same),
    (r"layer(\d+)/downsample/norm/(scale|bias)",
     "backbone.layers.{0}.downsample.norm.{ln}", _same),
    (r"layer(\d+)/downsample/reduction/kernel",
     "backbone.layers.{0}.downsample.reduction.weight", _dense),
    (r"norm/(scale|bias)", "backbone.norm.{ln}", _same),
    (r"head/kernel", "head.weight", _dense),
    (r"head/bias", "head.bias", _same),
)


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def _translate(path: str):
    for pattern, template, fn in _RULES:
        m = re.fullmatch(pattern, path)
        if m:
            groups = m.groups()
            ln = _LN.get(groups[-1]) if groups else None
            return template.format(*groups, ln=ln), fn
    raise KeyError(f"no port mapping for JAX leaf {path!r}")


def state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """``{"params": tree}`` with numpy (or array-like) leaves -> the port's
    Swin state_dict (f32 tensors)."""
    extra = set(variables) - {"params"}
    if extra:
        raise KeyError(f"unexpected variable collections: {sorted(extra)}")
    out = {}
    for path, leaf in _flatten(variables["params"]):
        key, fn = _translate(path)
        if key in out:
            raise KeyError(f"two JAX leaves map to {key!r}")
        arr = np.array(fn(np.asarray(leaf, np.float32)), order="C")
        out[key] = torch.from_numpy(arr)
    return out


def _template_regex(template: str) -> str:
    out = re.escape(template)
    out = re.sub(r"\\\{ln\\\}", "(weight|bias)", out)
    return re.sub(r"\\\{\d+\\\}", r"(\\w+)", out)


def _reverse(key: str):
    """torch key -> ('/'-joined JAX path, inverse transform)."""
    for pattern, template, fn in _RULES:
        m = re.fullmatch(_template_regex(template), key)
        if m:
            values = [{"weight": "scale"}.get(v, v) if i == len(m.groups()) - 1
                      and "{ln}" in template else v
                      for i, v in enumerate(m.groups())]
            it = iter(values)
            path = re.sub(r"\([^)]*\)", lambda _: next(it), pattern)
            return path, _INVERSE[fn]
    raise KeyError(f"no JAX mapping for port key {key!r}")


def jax_params_from_state_dict(state_dict: Mapping) -> dict:
    """The port's Swin state_dict (tensors or arrays) -> ``{"params": tree}``
    with numpy f32 leaves, the inverse of ``state_dict_from_jax``."""
    tree: dict = {}
    for key, value in state_dict.items():
        path, fn = _reverse(key)
        arr = value.detach().cpu().numpy() if isinstance(
            value, torch.Tensor) else np.asarray(value)
        node = tree
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.array(fn(arr.astype(np.float32)), order="C")
    return {"params": tree}
