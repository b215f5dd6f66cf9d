"""Config keys of the port's slice (port of vsn_tpu/config.py).

The port must run where only torch is installed, without importing the JAX
package, so the defaults its slices read are carried here as a dict. They
equal vsn_tpu/configs/config-defaults.yaml key for key (a CPU test holds
them to ``vsn_tpu.config.load_config()``), and the experiment YAMLs the
port runs are carried as ``PRESETS`` (held to ``load_config`` of those
files). Same access style as the JAX Config: ``cfg.EMBED_DIM`` and
``cfg["EMBED_DIM"]``.
"""

from __future__ import annotations

from typing import Any, Mapping

DEFAULTS = {
    "ARCHITECTURE": "Swin",
    "IMG_SIZE": [144, 168, 144],
    "RESHAPE_SIZE": False,
    "PATCH_SHAPE": [4, 4, 4],
    "EMBED_DIM": 96,
    "DEPTH": [2, 2, 6, 2],
    "HEADS": [3, 6, 12, 24],
    "WINDOW_SIZE": [6, 7, 6],
    "MLP_RATIO": 4,
    "QKV_BIAS": True,
    "PATCH_NORM": True,
    "POST_NORM": False,
    "NORM_LAYER": "nn.LayerNorm",
    "DROPOUT": 0,
    "ATTENTION_DROPOUT": 0,
    "STOCHASTIC_DEPTH_PROB": 0.15,
    "USE_SHAKEDROP": False,
    "SHAKEDROP_ALPHA_RANGE": [-1.0, 1.0],
    "ENABLE_STABLE": False,
    "STABLE_K": 2.0,
    "STABLE_ALPHA": 1.0,
    "LAYER_SCALE": False,
    "LAYER_SCALE_INIT_VALUE": 0.1,
    "FP16": True,
    "DISEASES": ["CN", "AD", "PNFA", "BV", "SD"],
    "EVAL_BATCH_SIZE": 64,
    "BATCH_SIZE": 8,
    # training step (vsn_tpu/train/step.py)
    "EFFECTIVE_BATCH_SIZE": 128,
    "STEPS": 2500,
    "SEED": 42,
    "LR_BASE": 0.0003,
    "LR_FINAL": 1e-05,
    "LR_WARMUP": 50,
    "WD_BASE": 0.05,
    "WD_FINAL": 0.0001,
    "WD_WARMUP": 50,
    "GRADIENT_CLIP": False,
    "LABEL_SMOOTHING": False,
    "USE_SAM": False,
    "SAM_RHO": 0.05,
    "SAM_ADAPTIVE": False,
    "USE_EMA": False,
    "EMA_DECAY": 0.999,
    "EMA_N_MODELS": 3,
    "USE_MIXUP": False,
    "MIXUP_ALPHA": 0.3,
    "MIXUP_PROB": 0.5,
    "USE_CUTMIX": False,
    "CUTMIX_ALPHA": 1.0,
    "CUTMIX_PROB": 0.5,
    "USE_EXTENDED_DATA_AUGMENTATION": False,
    "WATCH_GRADIENTS": False,
    "USE_CHECKPOINT": False,
    "PRELOAD_DEVICE": False,
}

# Keys the JAX package reads as ``cfg.get(key, default)`` and that
# config-defaults.yaml does not list (vsn_tpu/models/resnet3d.py:188, 191).
READ_DEFAULTS = {
    "RESNET_VARIANT": "resnet18",
    "IN_CHANNELS": 1,
}

# vsn_tpu/configs/<name>.yaml, applied over DEFAULTS as the JAX load_config
# applies them (SEED false is normalized to None there).
PRESETS = {
    "resnet-5c-no_seed-baseline": {
        "ARCHITECTURE": "ResNet",
        "PATCH_SHAPE": [8, 8, 8],
        "DROPOUT": 0.1,
        "SEED": None,
        "BATCH_SIZE": 12,
        "PRELOAD_DATA": False,
    },
    "resnet-3c-no_seed-baseline": {
        "ARCHITECTURE": "ResNet",
        "PATCH_SHAPE": [8, 8, 8],
        "DROPOUT": 0.1,
        "SEED": None,
        "BATCH_SIZE": 12,
        "PRELOAD_DATA": False,
        "DISEASES": ["CN", "AD", "FTD"],
    },
}


class Config(dict):
    """Config mapping with attribute access and the derived keys the slice
    reads."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def replace(self, **kwargs: Any) -> "Config":
        return Config({**self, **kwargs})

    @property
    def num_classes(self) -> int:
        return len(self["DISEASES"])

    def gradient_accumulation_steps(self, world_size: int = 1) -> int:
        """ceil(EFFECTIVE_BATCH_SIZE / (BATCH_SIZE * world_size))
        (vsn_tpu/config.py:113-128)."""
        per_step = self["BATCH_SIZE"] * world_size
        if per_step <= 0:
            raise ValueError("BATCH_SIZE * world_size must be positive")
        if self["EFFECTIVE_BATCH_SIZE"] < per_step:
            raise ValueError(
                f"EFFECTIVE_BATCH_SIZE={self['EFFECTIVE_BATCH_SIZE']} smaller "
                f"than BATCH_SIZE*world={per_step}")
        return -(-self["EFFECTIVE_BATCH_SIZE"] // per_step)

    @property
    def input_size(self) -> tuple[int, int, int]:
        """RESHAPE_SIZE if set, else IMG_SIZE."""
        rs = self.get("RESHAPE_SIZE", False)
        return tuple(int(v) for v in (rs if rs else self["IMG_SIZE"]))


def load_config(extra_overrides: Mapping[str, Any] | None = None,
                preset: str | None = None) -> Config:
    """The slice's defaults, then the named preset (a key of ``PRESETS``),
    then ``extra_overrides``."""
    return Config({**DEFAULTS, **READ_DEFAULTS,
                   **(PRESETS[preset] if preset else {}),
                   **(extra_overrides or {})})
