"""JAX variables <-> the port's state_dict (Swin-3D, ViT-3D, MedViT-3D and
ResNet-3D).

``state_dict_from_jax`` is the inverse of scripts/golden_parity.py
``port_swin``, ``port_vit`` and ``port_resnet``, with the same transposes: a Dense kernel
[in, out] becomes a Linear weight [out, in]; a Conv kernel [kd, kh, kw, I, O]
becomes a Conv3d weight [O, I, kd, kh, kw]; LayerNorm, RMSNorm and
BatchNorm scale/bias become weight/bias; DynamicTanh keeps alpha (0-d),
gamma and beta; BatchNorm ``batch_stats`` mean/var become the
running_mean/running_var buffers; ViT's ``cls_token`` and
``pos_embedding`` keep their names and shapes. A LayerScale gamma
(``res1/LayerScale_0/gamma``, ``res2/...``) becomes the block's
``res1.gamma`` / ``res2.gamma``, and ViT's post-norm LayerNorms
(``attn_norm``, ``ff_norm``) keep their names under the block. A JAX ``head`` is Swin's
``head`` or, in a tree that holds ``cls_token``, ViT's ``mlp_head.1``.
A tree whose blocks are named ``s{stage}_b{block}_{ecb|ltb}`` is a
MedViT's: its f-th block in (stage, block) order is the reference's
``features.{f}``, at any depths (the reverse map takes ``depths=``), and
its leaves take the names scripts/golden_parity_medvit.py reads (the
LocalityFeedForward ``lff/...`` as ``conv.conv.{0,1,3,4,6.fc.0,6.fc.2,7,
8}``, ``mhca/group_conv`` as ``mhca.group_conv3x3``, ``e_mhsa/sr_norm`` as
``e_mhsa.norm``). Every leaf must match a rule (KeyError
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
         "var": "running_var", "alpha": "alpha", "gamma": "gamma",
         "beta": "beta"}
_LEAF_INVERSE = {v: k for k, v in _LEAF.items()}

_SWIN = "backbone.layers.{0}.blocks.{1}"
_NORM = "(scale|bias|alpha|gamma|beta)"  # LayerNorm, RMSNorm, DynamicTanh
_RES = "resnet.layer{0}.{1}"

# (collection, regex over the '/'-joined path, torch key template,
# transform); the template's {0}, {1}, ... are the regex groups.
_RULES = (
    # Swin-3D
    ("params", r"patch_embed/kernel", "backbone.patch_embed.proj.weight",
     _conv),
    ("params", r"patch_embed/bias", "backbone.patch_embed.proj.bias", _same),
    ("params", r"patch_embed_norm/" + _NORM,
     "backbone.patch_embed.norm.{leaf}", _same),
    ("params", r"layer(\d+)/block(\d+)/(norm1|norm2)/" + _NORM,
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
    ("params", r"layer(\d+)/block(\d+)/(res1|res2)/LayerScale_0/gamma",
     _SWIN + ".{2}.gamma", _same),
    ("params", r"layer(\d+)/downsample/norm/" + _NORM,
     "backbone.layers.{0}.downsample.norm.{leaf}", _same),
    ("params", r"layer(\d+)/downsample/reduction/kernel",
     "backbone.layers.{0}.downsample.reduction.weight", _dense),
    ("params", r"norm/" + _NORM, "backbone.norm.{leaf}", _same),
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

_VIT = "transformer.layers.{0}"
# ViT-3D (JAX fused and unfused paths declare one tree, with no qkv bias)
_VIT_RULES = (
    ("params", r"patch_norm1/" + _NORM, "to_patch_embedding.1.{leaf}",
     _same),
    ("params", r"patch_proj/kernel", "to_patch_embedding.2.weight", _dense),
    ("params", r"patch_proj/bias", "to_patch_embedding.2.bias", _same),
    ("params", r"patch_norm2/" + _NORM, "to_patch_embedding.3.{leaf}",
     _same),
    ("params", r"(pos_embedding)", "{0}", _same),
    ("params", r"(cls_token)", "{0}", _same),
    ("params", r"block(\d+)/attn/norm/" + _NORM, _VIT + ".0.norm.{leaf}",
     _same),
    ("params", r"block(\d+)/attn/qkv/kernel", _VIT + ".0.to_qkv.weight",
     _dense),
    ("params", r"block(\d+)/attn/proj/kernel", _VIT + ".0.to_out.0.weight",
     _dense),
    ("params", r"block(\d+)/attn/proj/bias", _VIT + ".0.to_out.0.bias",
     _same),
    ("params", r"block(\d+)/ff_prenorm/" + _NORM, _VIT + ".1.net.0.{leaf}",
     _same),
    ("params", r"block(\d+)/mlp/fc1/kernel", _VIT + ".1.net.1.weight",
     _dense),
    ("params", r"block(\d+)/mlp/fc1/bias", _VIT + ".1.net.1.bias", _same),
    ("params", r"block(\d+)/mlp/fc2/kernel", _VIT + ".1.net.4.weight",
     _dense),
    ("params", r"block(\d+)/mlp/fc2/bias", _VIT + ".1.net.4.bias", _same),
    ("params", r"block(\d+)/(attn_norm|ff_norm)/" + _NORM,
     _VIT + ".{1}.{leaf}", _same),
    ("params", r"block(\d+)/(res1|res2)/LayerScale_0/gamma",
     _VIT + ".{1}.gamma", _same),
    ("params", r"head_norm/" + _NORM, "mlp_head.0.{leaf}", _same),
    ("params", r"head/kernel", "mlp_head.1.weight", _dense),
    ("params", r"head/bias", "mlp_head.1.bias", _same),
)


_F = "features.{0}"
_FJ = r"features/(\d+)"
_BN = r"(scale|bias)"
_STATS = r"(mean|var)"


def _batch_norm(jax_path: str, torch_key: str):
    """A BatchNorm's rules: scale / bias in params, mean / var in
    batch_stats."""
    return (("params", jax_path + "/" + _BN, torch_key + ".{leaf}", _same),
            ("batch_stats", jax_path + "/" + _STATS, torch_key + ".{leaf}",
             _same))


_LFF = (("expand", "0"), ("dwconv", "3"), ("project", "7"))
_LFF_BN = (("bn1", "1"), ("bn2", "4"), ("bn3", "8"))

# MedViT-3D, on JAX paths whose block names s{stage}_b{block}_{ecb|ltb} are
# written features/{f}, f the block's place in the model (``_medvit_in`` /
# ``_medvit_out``), as the reference's state_dict numbers them
_MEDVIT_RULES = (
    ("params", r"stem(\d)/conv/kernel", "stem.{0}.conv.weight", _conv),
    *_batch_norm(r"stem(\d)/norm", "stem.{0}.norm"),
    ("params", _FJ + r"/(patch_embed|projection)/conv/kernel",
     _F + ".{1}.conv.weight", _conv),
    *_batch_norm(_FJ + r"/(patch_embed|projection)/norm", _F + ".{1}.norm"),
    *_batch_norm(_FJ + r"/(norm1|norm2)", _F + ".{1}"),
    ("params", _FJ + r"/mhca/group_conv/kernel",
     _F + ".mhca.group_conv3x3.weight", _conv),
    *_batch_norm(_FJ + r"/mhca/norm", _F + ".mhca.norm"),
    ("params", _FJ + r"/mhca/projection/kernel", _F + ".mhca.projection.weight",
     _conv),
    *(("params", _FJ + f"/lff/{name}/kernel", _F + f".conv.conv.{i}.weight",
       _conv) for name, i in _LFF),
    *(rule for name, i in _LFF_BN
      for rule in _batch_norm(_FJ + f"/lff/{name}", _F + f".conv.conv.{i}")),
    *(("params", _FJ + f"/lff/se/{name}/{leaf}",
       _F + f".conv.conv.6.fc.{i}.{torch_leaf}", fn)
      for name, i in (("fc1", 0), ("fc2", 2))
      for leaf, torch_leaf, fn in (("kernel", "weight", _dense),
                                   ("bias", "bias", _same))),
    ("params", _FJ + r"/e_mhsa/(q|k|v|proj)/kernel", _F + ".e_mhsa.{1}.weight",
     _dense),
    ("params", _FJ + r"/e_mhsa/(q|k|v|proj)/bias", _F + ".e_mhsa.{1}.bias",
     _same),
    *_batch_norm(_FJ + r"/e_mhsa/sr_norm", _F + ".e_mhsa.norm"),
    ("params", _FJ + r"/(res1|res2|res_mhsa|res_mhca|res_ffn)/LayerScale_0/"
     r"gamma", _F + ".{1}.gamma", _same),
    *_batch_norm(r"norm", "norm"),
    ("params", r"proj_head/kernel", "proj_head.0.weight", _dense),
    ("params", r"proj_head/bias", "proj_head.0.bias", _same),
)
_MEDVIT_BLOCK = re.compile(r"s(\d+)_b(\d+)_(ecb|ltb)")


def _medvit_in(tree: Mapping):
    """JAX block name -> its place f in the model, from a MedViT tree's
    names (None for a tree of another model)."""
    blocks = sorted((tuple(map(int, m.groups()[:2])), k) for k in tree
                    if (m := _MEDVIT_BLOCK.fullmatch(k)))
    if not blocks:
        return None
    return {k: f for f, (_, k) in enumerate(blocks)}


def _medvit_out(depths):
    """f -> the JAX block name at ``depths``."""
    from vsn_tpu_torch.models.medvit3d import block_names

    return dict(enumerate(block_names(depths)))


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def _translate(collection: str, path: str, rules=_RULES):
    for coll, pattern, template, fn in rules:
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
    params = variables.get("params", {})
    medvit = _medvit_in({k: None for tree in variables.values() for k in tree})
    rules = (_VIT_RULES if "cls_token" in params
             else _MEDVIT_RULES if medvit else _RULES)
    out = {}
    for collection, tree in variables.items():
        for path, leaf in _flatten(tree):
            if medvit:
                head, _, rest = path.partition("/")
                if head in medvit:
                    path = f"features/{medvit[head]}/{rest}"
            key, fn = _translate(collection, path, rules)
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
    for coll, pattern, template, fn in _RULES + _VIT_RULES + _MEDVIT_RULES:
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


def jax_params_from_state_dict(state_dict: Mapping, depths=None) -> dict:
    """The port's state_dict (tensors or arrays) -> ``{"params": tree}``,
    plus ``"batch_stats"`` when it holds BatchNorm statistics, with numpy
    f32 leaves: the inverse of ``state_dict_from_jax``. A MedViT's
    ``features.{f}`` keys need the model's ``depths`` to name f's JAX
    block."""
    out: dict = {}
    names = None if depths is None else _medvit_out(depths)
    for key, value in state_dict.items():
        coll, path, fn = _reverse(key)
        if path.startswith("features/"):
            if names is None:
                raise ValueError(f"{key}: a MedViT block's key needs depths")
            _, f, rest = path.split("/", 2)
            path = f"{names[int(f)]}/{rest}"
        arr = value.detach().cpu().numpy() if isinstance(
            value, torch.Tensor) else np.asarray(value)
        node = out.setdefault(coll, {})
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.array(fn(arr.astype(np.float32)), order="C")
    out.setdefault("params", {})
    return out
