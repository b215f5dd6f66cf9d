"""ARCHITECTURE -> model factory (port of vsn_tpu/models/factory.py)."""

from __future__ import annotations

import torch

MODEL_PRESETS = ("Swin", "SwinDPL", "MedViT", "ViT", "ResNet")


def model_dtype(cfg) -> torch.dtype:
    """Activation dtype: bf16 when FP16 (mixed precision) is on, else f32.
    Parameters always stay f32."""
    if cfg.get("FP64", False):
        raise NotImplementedError("FP64 is the JAX package's CPU oracle mode; "
                                  "the port does not carry it")
    return torch.bfloat16 if cfg.get("FP16", True) else torch.float32


def card_or(device, caller: str = "build_model") -> torch.device:
    """``device`` when the caller names one, else the CUDA card; without a
    card and without a device it raises (``caller``: the entry point)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f"{caller}: no CUDA device; pass device='cpu' to "
                           "run on the CPU")
    return torch.device("cuda")


def build_model(cfg, device=None):
    """The model for ``cfg`` in eval mode, with its parameters on ``device``:
    the CUDA card unless the caller names another device (``device="cpu"``).
    Without a card and without a device it raises."""
    device = card_or(device)
    arch = cfg.ARCHITECTURE
    if arch == "Swin":
        from vsn_tpu_torch.models.swin3d import swin_from_config

        model = swin_from_config(cfg, dtype=model_dtype(cfg))
    elif arch == "ViT":
        from vsn_tpu_torch.models.vit3d import vit_from_config

        model = vit_from_config(cfg, dtype=model_dtype(cfg))
    elif arch == "ResNet":
        from vsn_tpu_torch.models.resnet3d import resnet_from_config

        model = resnet_from_config(cfg, dtype=model_dtype(cfg))
    elif arch == "MedViT":
        from vsn_tpu_torch.models.medvit3d import medvit_from_config

        model = medvit_from_config(cfg, dtype=model_dtype(cfg))
    elif arch == "SwinDPL":
        raise NotImplementedError(
            "SwinDPL (Deformable Patch Location) is a private architecture; "
            "the public interface is a stub in the reference as well.")
    else:
        raise ValueError(f"Unknown ARCHITECTURE {arch!r}; expected one of "
                         f"{MODEL_PRESETS}")
    return model.to(device).eval()


def init_model(model, cfg, generator: torch.Generator):
    """``model`` with fresh weights from its architecture's initializer
    (each model module's ``init_weights``, the JAX package's initializers'
    distributions) drawn from ``generator``."""
    from vsn_tpu_torch.models import medvit3d, resnet3d, swin3d, vit3d

    init = {"Swin": swin3d, "ViT": vit3d, "ResNet": resnet3d,
            "MedViT": medvit3d}[cfg.ARCHITECTURE].init_weights
    return init(model, generator)
