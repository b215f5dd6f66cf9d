"""Model zoo of the port (torch.nn): Swin-3D and ResNet-3D so far.

``build_model(cfg)`` maps the public ARCHITECTURE config key to a model.
"""

from vsn_tpu_torch.models.factory import build_model, MODEL_PRESETS  # noqa: F401
