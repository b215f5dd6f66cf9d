"""vsn_tpu_torch — the PyTorch + CUDA port of vsn_tpu for NVIDIA Hopper.

The JAX package ``vsn_tpu`` is the reference this package is held against;
module names mirror it. Ported so far: Swin-3D, ViT-3D, MedViT-3D and
ResNet-3D, each through config -> build_model -> init_train_state ->
make_train_step (SAM, EMA, MixUp, label smoothing; ShakeDrop, BatchNorm
statistics) and the eval chain (``eval/evaluate.py`` evaluate_checkpoint
on the JAX package's checkpoint files, TTA, bootstrap CIs, calibration),
with every TPU kernel on those paths rewritten by hand in CUDA C++ for
sm_90a (``csrc/``, built at first use into ``build/``). Models are built
on the CUDA card unless the caller asks for the CPU. This package imports
torch and never jax, pandas or msgpack.
"""

__version__ = "0.1.0"
