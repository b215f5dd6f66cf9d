"""Adjoints of the K3 movers against ``jax.vjp`` of the JAX Pallas movers
(interpret mode, ``VSN_PALLAS_RELAYOUT=1``).

On the CPU the port's movers are plain reshape/permute/roll ops, which
autograd differentiates. On a CUDA device their backward is the JAX
adjoint launched through the same gather kernel: the opposite mover (or
windows_to_windows itself) with the roll negated. Both are held here: the
autograd adjoint against JAX, and that formula, run through the plain
forms, against the autograd adjoint. A move is a permutation, so every
comparison is exact."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vsn_tpu.ops import window_relayout as jrelayout
from vsn_tpu_torch.models.swin3d import window_partition
from vsn_tpu_torch.ops import window_relayout as wr

DIMS, WIN = (4, 6, 4), (2, 3, 2)
ROLLS = [(0, 0, 0), (1, 1, 1), (3, 5, 3)]


@pytest.fixture
def pallas_relayout(monkeypatch):
    monkeypatch.setenv("VSN_PALLAS_RELAYOUT", "1")


def _arrays(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, *DIMS, 3)).astype(np.float32)
    wins = window_partition(torch.from_numpy(x), WIN).numpy()
    return x, wins


def _cases(x, wins, roll):
    """(name, port input, JAX function of one array, adjoint formula)."""
    neg = tuple(-r for r in roll)
    return [
        ("spatial_to_windows", x,
         lambda a: jrelayout.spatial_to_windows(a, WIN, roll),
         lambda g: wr.windows_to_spatial_reference(g, WIN, DIMS, neg)),
        ("windows_to_windows", wins,
         lambda a: jrelayout.windows_to_windows(a, WIN, DIMS, roll),
         lambda g: wr.windows_to_windows_reference(g, WIN, DIMS, neg)),
        ("windows_to_spatial", wins,
         lambda a: jrelayout.windows_to_spatial(a, WIN, DIMS, roll),
         lambda g: wr.spatial_to_windows_reference(g, WIN, neg)),
    ]


def _port_vjp(name, src, roll, g):
    a = torch.from_numpy(src).requires_grad_()
    rest = (WIN, roll) if name == "spatial_to_windows" else (WIN, DIMS, roll)
    out = getattr(wr, name)(a, *rest)
    (grad,) = torch.autograd.grad(out, a, torch.from_numpy(g))
    return out.detach().numpy(), grad.numpy()


@pytest.mark.parametrize("roll", ROLLS)
def test_mover_adjoints_match_jax_vjp(roll, pallas_relayout):
    x, wins = _arrays(seed=sum(roll))
    rng = np.random.default_rng(1)
    for name, src, jfn, _ in _cases(x, wins, roll):
        out, vjp = jax.vjp(jfn, jnp.asarray(src))
        g = rng.standard_normal(out.shape).astype(np.float32)
        (want,) = vjp(jnp.asarray(g))
        got_out, got = _port_vjp(name, src, roll, g)
        np.testing.assert_array_equal(got_out, np.asarray(out), err_msg=name)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)


@pytest.mark.parametrize("roll", ROLLS + [(5, 11, 7)])
def test_adjoint_is_the_opposite_move_with_the_roll_negated(roll):
    """The formula the CUDA route's backward launches equals autograd."""
    x, wins = _arrays(seed=3)
    rng = np.random.default_rng(2)
    for name, src, _, adjoint in _cases(x, wins, roll):
        rest = (WIN, roll) if name == "spatial_to_windows" else (
            WIN, DIMS, roll)
        out = getattr(wr, name)(torch.from_numpy(src), *rest)
        g = rng.standard_normal(tuple(out.shape)).astype(np.float32)
        _, got = _port_vjp(name, src, roll, g)
        np.testing.assert_array_equal(adjoint(torch.from_numpy(g)).numpy(),
                                      got, err_msg=name)
