"""JAX variables <-> the port's state_dict (Swin-3D and ResNet-3D).

``state_dict_from_jax`` is the inverse of scripts/golden_parity.py
``port_swin`` and ``port_resnet``, with the same transposes: a Dense kernel
[in, out] becomes a Linear weight [out, in]; a Conv kernel [kd, kh, kw, I, O]
becomes a Conv3d weight [O, I, kd, kh, kw]; LayerNorm and BatchNorm
scale/bias become weight/bias; BatchNorm ``batch_stats`` mean/var become the
running_mean/running_var buffers. Every leaf must match a rule (KeyError
otherwise); load the result with ``load_state_dict(strict=True)`` so that
any model key left without a leaf errors too. The maps are linear, so they
carry gradients and optimizer moments as well as parameters.
``jax_params_from_state_dict`` is the reverse map; the round trip is exact.
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

# The last group of a rule's pattern names the leaf; {leaf} in the torch key
# is its torch name.
_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}
_LEAF_INVERSE = {v: k for k, v in _LEAF.items()}

_SWIN = "backbone.layers.{0}.blocks.{1}"
_RES = "resnet.layer{0}.{1}"

# (collection, regex over the '/'-joined path, torch key template,
# transform); the template's {0}, {1}, ... are the regex groups.
_RULES = (
    # Swin-3D
    ("params", r"patch_embed/kernel", "backbone.patch_embed.proj.weight",
     _conv),
    ("params", r"patch_embed/bias", "backbone.patch_embed.proj.bias", _same),
    ("params", r"patch_embed_norm/(scale|bias)",
     "backbone.patch_embed.norm.{leaf}", _same),
    ("params", r"layer(\d+)/block(\d+)/(norm1|norm2)/(scale|bias)",
     _SWIN + ".{2}.{leaf}", _same),
    ("params", r"layer(\d+)/block(\d+)/attn/(qkv|proj)/kernel",
     _SWIN + ".attn.{2}.weight", _dense),
    ("params", r"layer(\d+)/block(\d+)/attn/(qkv|proj)/bias",
     _SWIN + ".attn.{2}.bias", _same),
    ("params", r"layer(\d+)/block(\d+)/attn/relative_position_bias_table",
     _SWIN + ".attn.relative_position_bias_table", _same),
    ("params", r"layer(\d+)/block(\d+)/mlp/fc1/kernel", _SWIN + ".mlp.0.weight",
     _dense),
    ("params", r"layer(\d+)/block(\d+)/mlp/fc1/bias", _SWIN + ".mlp.0.bias",
     _same),
    ("params", r"layer(\d+)/block(\d+)/mlp/fc2/kernel", _SWIN + ".mlp.3.weight",
     _dense),
    ("params", r"layer(\d+)/block(\d+)/mlp/fc2/bias", _SWIN + ".mlp.3.bias",
     _same),
    ("params", r"layer(\d+)/downsample/norm/(scale|bias)",
     "backbone.layers.{0}.downsample.norm.{leaf}", _same),
    ("params", r"layer(\d+)/downsample/reduction/kernel",
     "backbone.layers.{0}.downsample.reduction.weight", _dense),
    ("params", r"norm/(scale|bias)", "backbone.norm.{leaf}", _same),
    ("params", r"head/kernel", "head.weight", _dense),
    ("params", r"head/bias", "head.bias", _same),
    # ResNet-3D
    ("params", r"conv1/kernel", "resnet.conv1.weight", _conv),
    ("params", r"bn1/(scale|bias)", "resnet.bn1.{leaf}", _same),
    ("batch_stats", r"bn1/(mean|var)", "resnet.bn1.{leaf}", _same),
    ("params", r"layer(\d+)_block(\d+)/(conv[123])/kernel",
     _RES + ".{2}.weight", _conv),
    ("params", r"layer(\d+)_block(\d+)/(bn[123])/(scale|bias)",
     _RES + ".{2}.{leaf}", _same),
    ("batch_stats", r"layer(\d+)_block(\d+)/(bn[123])/(mean|var)",
     _RES + ".{2}.{leaf}", _same),
    ("params", r"layer(\d+)_block(\d+)/downsample_conv/kernel",
     _RES + ".downsample.0.weight", _conv),
    ("params", r"layer(\d+)_block(\d+)/downsample_bn/(scale|bias)",
     _RES + ".downsample.1.{leaf}", _same),
    ("batch_stats", r"layer(\d+)_block(\d+)/downsample_bn/(mean|var)",
     _RES + ".downsample.1.{leaf}", _same),
    ("params", r"fc/kernel", "resnet.fc.weight", _dense),
    ("params", r"fc/bias", "resnet.fc.bias", _same),
)


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def _translate(collection: str, path: str):
    for coll, pattern, template, fn in _RULES:
        m = re.fullmatch(pattern, path) if coll == collection else None
        if m:
            groups = m.groups()
            leaf = _LEAF.get(groups[-1]) if "{leaf}" in template else None
            return template.format(*groups, leaf=leaf), fn
    raise KeyError(f"no port mapping for JAX leaf {collection}/{path}")


def state_dict_from_jax(variables: Mapping,
                        dtype=np.float32) -> dict[str, torch.Tensor]:
    """``{"params": tree, "batch_stats": tree}`` (batch_stats optional) with
    numpy (or array-like) leaves -> the port's state_dict (tensors of
    ``dtype``, f32 by default)."""
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise KeyError(f"unexpected variable collections: {sorted(extra)}")
    out = {}
    for collection, tree in variables.items():
        for path, leaf in _flatten(tree):
            key, fn = _translate(collection, path)
            if key in out:
                raise KeyError(f"two JAX leaves map to {key!r}")
            arr = np.array(fn(np.asarray(leaf, dtype)), order="C")
            out[key] = torch.from_numpy(arr)
    return out


def _template_regex(template: str, pattern: str) -> str:
    """The torch keys a rule produces, with its pattern's groups."""
    groups = re.findall(r"\(([^)]*)\)", pattern)
    out = re.escape(template)
    leaves = "|".join(_LEAF.values())
    out = re.sub(r"\\\{leaf\\\}", lambda _: f"({leaves})", out)
    return re.sub(r"\\\{(\d+)\\\}", lambda m: f"({groups[int(m.group(1))]})",
                  out)


def _reverse(key: str):
    """torch key -> (collection, '/'-joined JAX path, inverse transform)."""
    for coll, pattern, template, fn in _RULES:
        m = re.fullmatch(_template_regex(template, pattern), key)
        if not m:
            continue
        values = list(m.groups())
        if "{leaf}" in template:
            values[-1] = _LEAF_INVERSE[values[-1]]
        it = iter(values)
        path = re.sub(r"\([^)]*\)", lambda _: next(it), pattern)
        if re.fullmatch(pattern, path):  # e.g. not a statistic as a param
            return coll, path, _INVERSE[fn]
    raise KeyError(f"no JAX mapping for port key {key!r}")


def jax_params_from_state_dict(state_dict: Mapping) -> dict:
    """The port's state_dict (tensors or arrays) -> ``{"params": tree}``,
    plus ``"batch_stats"`` when it holds BatchNorm statistics, with numpy
    f32 leaves: the inverse of ``state_dict_from_jax``."""
    out: dict = {}
    for key, value in state_dict.items():
        coll, path, fn = _reverse(key)
        arr = value.detach().cpu().numpy() if isinstance(
            value, torch.Tensor) else np.asarray(value)
        node = out.setdefault(coll, {})
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.array(fn(arr.astype(np.float32)), order="C")
    out.setdefault("params", {})
    return out
