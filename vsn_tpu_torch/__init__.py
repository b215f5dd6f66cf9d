"""vsn_tpu_torch — the PyTorch + CUDA port of vsn_tpu for NVIDIA Hopper.

The JAX package ``vsn_tpu`` is the reference this package is held against;
module names mirror it. Ported so far: Swin-3D and ResNet-3D, each through
config -> build_model -> init_train_state -> make_train_step (SAM, EMA,
MixUp, label smoothing; ShakeDrop for Swin, BatchNorm statistics for the
ResNet) and Evaluator (eval transform, forward, softmax), with every TPU
kernel on those paths rewritten by hand in CUDA C++ for sm_90a (``csrc/``,
built at first use into ``build/``). Models are built on the CUDA card
unless the caller asks for the CPU. This package imports torch and never
jax.
"""

__version__ = "0.1.0"
