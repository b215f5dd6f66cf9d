"""ARCHITECTURE -> model factory (port of vsn_tpu/models/factory.py)."""

from __future__ import annotations

import torch

MODEL_PRESETS = ("Swin", "SwinDPL", "MedViT", "ViT", "ResNet")

# ROADMAP Queue 1 items that port the other backbones
_NOT_PORTED = {
    "ViT": "models/vit3d.py (ROADMAP Queue 1, item 9)",
    "MedViT": "models/medvit3d.py (ROADMAP Queue 1, item 11)",
}


def model_dtype(cfg) -> torch.dtype:
    """Activation dtype: bf16 when FP16 (mixed precision) is on, else f32.
    Parameters always stay f32."""
    if cfg.get("FP64", False):
        raise NotImplementedError("FP64 is the JAX package's CPU oracle mode; "
                                  "the port does not carry it")
    return torch.bfloat16 if cfg.get("FP16", True) else torch.float32


def _device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("build_model: no CUDA device; pass device='cpu' to "
                           "build the model on the CPU")
    return torch.device("cuda")


def build_model(cfg, device=None):
    """The model for ``cfg`` in eval mode, with its parameters on ``device``:
    the CUDA card unless the caller names another device (``device="cpu"``).
    Without a card and without a device it raises."""
    device = _device(device)
    arch = cfg.ARCHITECTURE
    if arch == "Swin":
        from vsn_tpu_torch.models.swin3d import swin_from_config

        model = swin_from_config(cfg, dtype=model_dtype(cfg))
    elif arch == "ResNet":
        from vsn_tpu_torch.models.resnet3d import resnet_from_config

        model = resnet_from_config(cfg, dtype=model_dtype(cfg))
    elif arch in _NOT_PORTED:
        raise NotImplementedError(f"ARCHITECTURE={arch!r} is not ported yet: "
                                  f"{_NOT_PORTED[arch]}")
    elif arch == "SwinDPL":
        raise NotImplementedError(
            "SwinDPL (Deformable Patch Location) is a private architecture; "
            "the public interface is a stub in the reference as well.")
    else:
        raise ValueError(f"Unknown ARCHITECTURE {arch!r}; expected one of "
                         f"{MODEL_PRESETS}")
    return model.to(device).eval()
