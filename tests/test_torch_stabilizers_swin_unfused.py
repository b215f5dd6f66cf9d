"""The port's unfused Swin-3D blocks (DynamicTanh norms, K4 attention) with
the stabilizer options (LAYER_SCALE, POST_NORM, ENABLE_STABLE and all
three) against the JAX package's XLA blocks on the CPU: the port's plain
residual order (branch -> post-norm -> LayerScale -> lam * x + beta *
branch, beta folded into the gains) around K4's plain version, against
JAX's ``ResidualBranch``. The geometries, weights and tolerance are
tests/test_torch_stabilizers_swin.py's (``check_against_jax``).
"""

import pytest

from tests.test_torch_stabilizers_swin import (
    OPTIONS,
    PADDED,
    TINY,
    check_against_jax,
)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_unfused_swin_option_matches_jax(option):
    geometry = PADDED if option == "all" else TINY
    check_against_jax(dict(geometry, NORM_LAYER="DynamicTanh",
                           **OPTIONS[option]), fused=False)
