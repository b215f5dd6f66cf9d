"""Device-resident volume store (PRELOAD_DEVICE): keep a fold's volumes on
the card and assemble each batch there from sampler indices (port of
vsn_tpu/data/resident.py).

The whole cache crosses to the card once; every step then ships only int32
row indices, and the batch is a row gather of whole volumes on the card
(``Tensor.index_select``), so training and validation do not wait on the
host's gather or the host-to-card copy.

Modes (config key PRELOAD_DEVICE):
  * ``"float16"`` / ``"bfloat16"`` — bit-faithful to the host cache (bf16
    rounds the f16 values to nearest even, as the JAX store's cast does);
  * ``"int8"`` — per-volume affine codes (uint8 codes + f32 scale / offset
    from the volume's min / max, ``quantize_volumes_int8``); half the
    memory, slightly lossy;
  * ``False`` — off (the host pipeline ships gathered volumes).

With a ``pretransform`` (``resident_pretransform``), the deterministic
resize + z-score is applied on the card at build time, in chunks, and the
store keeps the transformed volumes in its dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

_F16 = ("float16", "f16", "fp16", "true", "1")
_BF16 = ("bfloat16", "bf16")


@dataclass
class ResidentVolumes:
    """Device-side volume store: ``data`` [N, D, H, W, C] (f16, bf16 or
    uint8 codes); ``scale`` and ``offset`` [N] f32 (int8 mode) or None."""

    data: torch.Tensor
    scale: Optional[torch.Tensor] = None
    offset: Optional[torch.Tensor] = None

    def __len__(self) -> int:
        return self.data.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.data, self.scale, self.offset)
                   if t is not None)


def quantize_volumes_int8(images: np.ndarray):
    """Per-volume affine uint8 quantization. Returns (q, scale, offset) with
    x ~= q * scale + offset."""
    n = images.shape[0]
    flat = images.reshape(n, -1).astype(np.float32)
    lo = flat.min(axis=1)
    hi = flat.max(axis=1)
    scale = np.maximum(hi - lo, 1e-8) / 255.0
    q = np.rint((flat - lo[:, None]) / scale[:, None]).astype(np.uint8)
    return q.reshape(images.shape), scale.astype(np.float32), \
        lo.astype(np.float32)


def resident_pretransform(cfg, train: bool):
    """The deterministic per-volume transform to bake into the store at build
    time, or None when the store must stay raw.

    The eval store can always be pre-transformed (resize + z-score is
    deterministic). The TRAIN store only when the pipeline is minimal (no
    dung / extended augmentation) and MixUp / CutMix are off: the reference
    z-scores after mixing (dataset/dataset.py:288-291).
    PRELOAD_PRETRANSFORM=False keeps every store raw."""
    if not cfg.get("PRELOAD_PRETRANSFORM", True):
        return None
    if train and (cfg.get("IS_DUNG_TRANSFORMS", False)
                  or cfg.get("USE_EXTENDED_DATA_AUGMENTATION", False)
                  or cfg.get("USE_MIXUP", False)
                  or cfg.get("USE_CUTMIX", False)):
        return None
    from vsn_tpu_torch.data.augment import build_eval_transform

    return build_eval_transform(cfg)


def _quantize(t: torch.Tensor):
    flat = t.reshape(t.shape[0], -1)
    lo = flat.min(dim=1).values
    scale = torch.clamp(flat.max(dim=1).values - lo, min=1e-8) / 255.0
    q = torch.round((flat - lo[:, None]) / scale[:, None]).to(torch.uint8)
    return q.reshape(t.shape), scale, lo


def _store_dtype(mode: str):
    if mode in _F16:
        return torch.float16
    if mode in _BF16:
        return torch.bfloat16
    if mode == "int8":
        return None
    raise ValueError(f"unknown PRELOAD_DEVICE mode: {mode!r}")


def build_resident(images: np.ndarray, mode, device, pretransform=None,
                   chunk: int = 8) -> ResidentVolumes:
    """Upload the [N, D, H, W, C] float16 cache to ``device`` in ``mode``.

    Without ``pretransform`` the raw volumes are stored (int8: quantized on
    the host, as the JAX store quantizes them). With it, raw chunks of
    ``chunk`` volumes cross once, the transform runs on the card in f32
    and only its output is kept, cast to the store's dtype (int8: codes
    from the transformed volume, on the card)."""
    mode = str(mode).lower()
    dtype = _store_dtype(mode)
    device = torch.device(device)
    if pretransform is None:
        if dtype is None:
            q, scale, offset = quantize_volumes_int8(images)
            return ResidentVolumes(torch.from_numpy(q).to(device),
                                   torch.from_numpy(scale).to(device),
                                   torch.from_numpy(offset).to(device))
        data = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        return ResidentVolumes(data.to(dtype))
    parts, scales, offsets = [], [], []
    for i in range(0, images.shape[0], chunk):
        raw = torch.from_numpy(np.ascontiguousarray(images[i:i + chunk]))
        t = pretransform(raw.to(device).float())
        if dtype is None:
            q, s, o = _quantize(t)
            parts.append(q)
            scales.append(s)
            offsets.append(o)
        else:
            parts.append(t.to(dtype))
    return ResidentVolumes(torch.cat(parts),
                           torch.cat(scales) if scales else None,
                           torch.cat(offsets) if offsets else None)


def gather_volumes(res: ResidentVolumes, idx: torch.Tensor) -> torch.Tensor:
    """[B] row indices -> [B, D, H, W, C] volumes, gathered on the store's
    device. float16 / bfloat16 stores return their dtype unchanged
    (bit-faithful to the host cache); int8 dequantizes to float32."""
    idx = idx.to(res.data.device, torch.long)
    vols = res.data.index_select(0, idx)
    if res.scale is None:
        return vols
    bshape = (idx.shape[0],) + (1,) * (vols.dim() - 1)
    scale = res.scale.index_select(0, idx).reshape(bshape)
    offset = res.offset.index_select(0, idx).reshape(bshape)
    return vols.float() * scale + offset


def resolve_micro(micro: dict, res: Optional[ResidentVolumes]) -> dict:
    """Replace image_idx / partner_idx index fields with gathered volumes.

    No-op when ``res`` is None or the micro-batch already carries images
    (host-pipeline mode), so the train step works alike in both modes."""
    if res is None or "image_idx" not in micro:
        return micro
    out = dict(micro)
    out["image"] = gather_volumes(res, out.pop("image_idx"))
    if "partner_idx" in out:
        out["image2"] = gather_volumes(res, out.pop("partner_idx"))
    return out
