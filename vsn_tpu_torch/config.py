"""Config keys of the port (port of vsn_tpu/config.py).

The port must run where only torch is installed, without importing the JAX
package or PyYAML, so the defaults are carried here as a dict. They equal
vsn_tpu/configs/config-defaults.yaml key for key (a CPU test holds them to
``vsn_tpu.config.load_config()``), and the experiment YAMLs the port runs
are carried as ``PRESETS`` (held to ``load_config`` of those files). Same
access style as the JAX Config: ``cfg.EMBED_DIM`` and ``cfg["EMBED_DIM"]``.

The two-level YAML protocol of the JAX package (a ``{KEY: {desc, value}}``
defaults file, override files applied key by key, the CLI's ``--fold`` and
``--seed`` last, the merged config saved to the run directory) runs on a
small reader and writer of its own (``load_yaml_values``, ``save_config``):
flat top-level keys whose values are scalars, flow lists ``[a, b]`` or
block lists ``- a``, resolved as PyYAML's ``safe_load`` resolves them
(YAML 1.1: ``true`` / ``false`` / ``yes`` / ``off`` ..., ``null`` and
``~``, ints, floats with a dot); ``save_config`` writes flat values that
``yaml.safe_load`` reads back.
"""

from __future__ import annotations

import json
import math
import os
import re
from pathlib import Path
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
    "USE_SYNC_BN": True,
    "UPDATE_BN_STATS": True,
    "WATCH_GRADIENTS": False,
    "USE_CHECKPOINT": False,
    "VAL_ATTN_WATCH": True,
    # saving / early stopping (vsn_tpu/train/trainer.py)
    "KEEP_BEST_N": 10,
    "METRIC_BEST_MODEL": "loss",
    "SAVE_EVERY": False,
    "VALIDATION_FREQUENCY": 5,
    "EARLY_STOPPING_PATIENCE": 300,
    "EARLY_STOPPING_METRIC": "loss",
    "EARLY_STOPPING_MIN_DELTA": 0.0005,
    # data / cross-validation and loading
    "KFOLD": 10,
    "FOLD": 0,
    "SPLIT": [7, 2, 1],
    "USE_BALANCED_SAMPLER": False,
    "PRELOAD_DATA": True,
    "PRELOAD_DEVICE": False,
    "PRELOAD_PRETRANSFORM": True,
    "NUM_WORKERS": 10,
    "PREFETCH_FACTOR": 8,
}

# Keys the JAX package reads as ``cfg.get(key, default)`` and that
# config-defaults.yaml does not list (vsn_tpu/models/resnet3d.py:188, 191;
# vsn_tpu/models/vit3d.py:535).
READ_DEFAULTS = {
    "RESNET_VARIANT": "resnet18",
    "IN_CHANNELS": 1,
    "USE_PALLAS_ATTENTION": True,
}

_VIT = {
    "ARCHITECTURE": "ViT",
    "RESHAPE_SIZE": [144, 160, 144],
    "PATCH_SHAPE": [16, 16, 16],
    "EMBED_DIM": 384,
    "DEPTH": 12,
    "HEADS": 6,
    "SEED": None,
    "BATCH_SIZE": 24,
}

_MEDVIT = {
    "ARCHITECTURE": "MedViT",
    "DEPTH": [3, 4, 10, 3],
    "HEADS": 32,
    "MLP_RATIO": 3,
    "SEED": None,
    "PRELOAD_DATA": False,
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
    "vit-5c-no_seed-baseline": dict(_VIT),
    "vit-3c-no_seed-baseline": dict(_VIT, DISEASES=["CN", "AD", "FTD"]),
    "medvit-5c-no_seed-baseline": dict(_MEDVIT),
    "medvit-3c-no_seed-baseline": dict(_MEDVIT, DISEASES=["CN", "AD", "FTD"]),
}


def normalize_seed(seed: Any) -> int | None:
    """The SEED flag: None / False / 'none' / 'false' / '' disable seeding
    (vsn_tpu/config.py normalize_seed)."""
    if seed is None or seed is False:
        return None
    if isinstance(seed, str):
        if seed.strip().lower() in ("none", "false", ""):
            return None
        return int(seed)
    if isinstance(seed, bool):  # True is not a valid seed
        raise ValueError("SEED=True is not a valid seed; use an integer")
    return int(seed)


class Config(dict):
    """Config mapping with attribute access and the derived keys the port
    reads."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def replace(self, **kwargs: Any) -> "Config":
        return Config({**self, **kwargs})

    def to_dict(self) -> dict:
        return dict(self)

    @property
    def num_classes(self) -> int:
        return len(self["DISEASES"])

    @property
    def seed_or_none(self) -> int | None:
        return normalize_seed(self.get("SEED"))

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


# --- the YAML subset of the config files ------------------------------------

_NULL = re.compile(r"~|null|Null|NULL|")
_TRUE = re.compile(r"yes|Yes|YES|true|True|TRUE|on|On|ON")
_FALSE = re.compile(r"no|No|NO|false|False|FALSE|off|Off|OFF")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_OCT = re.compile(r"[-+]?0[0-7_]+")
_HEX = re.compile(r"[-+]?0x[0-9a-fA-F_]+")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")


def _plain(text: str):
    """A plain scalar as PyYAML's safe resolver reads it (YAML 1.1)."""
    if _NULL.fullmatch(text):
        return None
    if _TRUE.fullmatch(text):
        return True
    if _FALSE.fullmatch(text):
        return False
    for pattern, base in ((_INT, 10), (_HEX, 16), (_OCT, 8)):
        if pattern.fullmatch(text):
            return int(text.replace("_", ""), base)
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if m := _INF.fullmatch(text):
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN.fullmatch(text):
        return math.nan
    return text


def _split_flow(text: str) -> list[str]:
    """The items of a flow list's inside, split at its top-level commas."""
    items, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(text):
        if quote:
            if ch == quote and text[i - 1] != "\\":
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(text[start:i])
            start = i + 1
    items.append(text[start:])
    return [item.strip() for item in items if item.strip()]


def _strip_comment(text: str) -> str:
    """``text`` without a trailing `` # comment`` outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _scalar(text: str):
    """A flow value: a quoted or plain scalar or a flow list."""
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"unterminated flow list: {text!r}")
        return [_scalar(item) for item in _split_flow(text[1:-1])]
    if text.startswith('"'):
        return json.loads(text)
    if text.startswith("'"):
        return text[1:-1].replace("''", "'")
    return _plain(text)


def _block(lines: list[tuple[int, str]]):
    """The value of a key whose inline value is empty: its block of more
    indented lines (or a list at the key's own indent) as a list of
    ``- item`` scalars or a mapping of ``key: value`` entries, an entry's
    deeper lines continuing its (plain, folded) scalar."""
    if not lines:
        return None
    if lines[0][1].startswith("- ") or lines[0][1] == "-":
        return [_scalar(text[1:]) for _, text in lines]
    indent = lines[0][0]
    entries = []   # (key, inline text, deeper lines)
    for ind, text in lines:
        if ind == indent:
            key, _, rest = text.partition(":")
            entries.append((key.strip(), rest.strip(), []))
        else:
            entries[-1][2].append((ind, text))
    return {key: (_block(sub) if sub and not inline else
                  _scalar(" ".join([inline] + [t for _, t in sub])))
            for key, inline, sub in entries}


def parse_yaml(text: str) -> dict:
    """A config file's top-level mapping (see the module docstring)."""
    entries: list[tuple[str, str, list]] = []
    for raw in text.splitlines():
        if not raw.strip() or raw.lstrip().startswith("#"):
            continue
        line = _strip_comment(raw)
        indent = len(line) - len(line.lstrip())
        body = line.strip()
        if indent == 0 and not body.startswith("-"):
            key, sep, rest = body.partition(":")
            if not sep:
                raise ValueError(f"not a 'KEY: value' line: {raw!r}")
            entries.append((key.strip(), rest.strip(), []))
        elif entries:
            entries[-1][2].append((indent, body))
        else:
            raise ValueError(f"a value before any key: {raw!r}")
    return {key: (_scalar(inline) if inline else _block(block))
            for key, inline, block in entries}


def _unwrap(node: Any) -> Any:
    """The ``value`` of a ``{desc, value}`` node."""
    if isinstance(node, Mapping) and "value" in node:
        return node["value"]
    return node


def load_yaml_values(path) -> dict:
    """A ``{KEY: {desc, value}}`` (or flat ``{KEY: value}``) file as a
    flat ``{KEY: value}`` (vsn_tpu/config.py load_yaml_values)."""
    raw = parse_yaml(Path(path).read_text())
    return {k: _unwrap(v) for k, v in raw.items()}


def _emit(value) -> str:
    """``value`` as a YAML flow value that ``yaml.safe_load`` reads back."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        mant, e, exp = text.partition("e")
        if "." not in mant:
            mant += ".0"
        if e and exp[0] not in "+-":
            exp = "+" + exp
        return mant + (e + exp if e else "")
    if isinstance(value, str):
        return json.dumps(value)
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_emit(v) for v in value) + "]"
    raise TypeError(f"config value of type {type(value).__name__}: {value!r}")


def save_config(cfg, run_dir, name: str = "config.yaml"):
    """Persist the merged config (flat values, sorted keys) to the run
    directory (vsn_tpu/config.py save_config)."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    path = run_dir / name
    path.write_text("".join(f"{k}: {_emit(v)}\n"
                            for k, v in sorted(dict(cfg).items())))
    return path


def load_config(overrides=None, preset: str | None = None,
                fold: int | None = None, seed: Any = "__unset__") -> Config:
    """The defaults, then the named preset (a key of ``PRESETS``), then
    ``overrides`` (a mapping, or the path of an override YAML as the JAX
    CLI's ``--config``), then the CLI's ``fold`` and ``seed``; SEED is
    normalized (vsn_tpu/config.py load_config)."""
    values = {**DEFAULTS, **READ_DEFAULTS, **(PRESETS[preset] if preset
                                             else {})}
    if isinstance(overrides, (str, os.PathLike)):
        overrides = load_yaml_values(overrides)
    values.update(overrides or {})
    if fold is not None:
        values["FOLD"] = int(fold)
    if seed != "__unset__":
        values["SEED"] = seed
    values["SEED"] = normalize_seed(values.get("SEED"))
    return Config(values)
