"""The attention probes' plain versions against the scripts' own Pallas bodies.

``ops/attn_probe.py`` ports scripts/perf_probe_attn_ablate.py (P1,
``kernel``) and scripts/perf_probe_attn_ablate2.py (P2-P4 ``copy_kernel``
and ``copy_ops_kernel``, P5 ``slot_kernel``). The scripts are loaded as they
are and each body runs in this file's own ``pl.pallas_call(...,
interpret=True)`` with plain BlockSpecs; the port's plain versions take the
same inputs: a few windows of the scripts' own (bf16 x, weights 0.05 z,
bias 0.1 z) and sensitive ones where every ablated piece matters (f32 x = 3 z
+ 1 + a per-row offset, weights fan_in^-0.5 z, bias z).

Limits: with f32 out the branch (out - x) within 4e-3 of its largest
value. Both sides round p, q, k, v, y and ao to bf16 at the same points, so
they differ where an f32 difference of a few ulps (XLA's and PyTorch's exp
on the CPU, the order of sums) moves a value across a bf16 rounding
boundary: one bf16 step (2^-8) of that value. At the sensitive inputs on
a CPU the worst was 2.3e-3 (``nobias``) and the RMS difference 2.4e-4
to 3.0e-4 of the branch's RMS in the variants with a softmax. With bf16 out, each element within one bf16 step of its own
magnitude plus that branch limit (where x + branch nearly cancels, the
branch's own differences are larger than the step). The copies exactly
equal.
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vsn_tpu_torch.ops import _build
from vsn_tpu_torch.ops import attn_probe as ap
from vsn_tpu_torch.probes import (
    C,
    HEADS,
    N,
    attn_ablate,
    attn_ablate2,
    script_inputs,
)

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = {"p1": ROOT / "scripts" / "perf_probe_attn_ablate.py",
           "p2": ROOT / "scripts" / "perf_probe_attn_ablate2.py"}
BW = 4            # windows per case (the scripts' N = 252, C = 96, 3 heads)
BRANCH_TOL = 4e-3


@pytest.fixture(scope="module")
def scripts():
    mods = {}
    for name, path in SCRIPTS.items():
        spec = importlib.util.spec_from_file_location(f"_probe_{name}", path)
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    return mods


@pytest.fixture(scope="module")
def inputs():
    """{"script": the scripts' inputs (bf16 x), "sensitive": f32 x and
    weights under which LN, the bias, the softmax and attention all move the
    branch}: (x, wqkv, bias, wproj) as CPU tensors."""
    xw, wqkv, bias, wproj = script_inputs("cpu", micro=1)
    rng = np.random.default_rng(7)
    z = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    x = 3 * z(BW, N, C) + 1 + 2 * z(BW, N, 1)
    return {"script": (xw[:BW].contiguous(), wqkv, bias, wproj),
            "sensitive": (x, z(C, 3 * C) * C ** -0.5, z(HEADS, N, N),
                          z(C, C) * C ** -0.5)}


def _blk(shape):
    return pl.BlockSpec(shape, lambda bi: (0,) * len(shape))


def _xspec(wb):
    return pl.BlockSpec((wb, N, C), lambda bi: (bi, 0, 0))


def _jax(body, x, weights, wb=1):
    """``body`` over x [BW, N, C] (wb windows per program) in interpret
    mode, with the weights as operands when given; the result as f32."""
    xj = jnp.asarray(x.float().numpy(),
                     jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)
    specs = [_xspec(wb)]
    args = [xj]
    if weights is not None:
        specs += [_blk((C, 3 * C)), _blk((HEADS, N, N)), _blk((C, C))]
        args += [jnp.asarray(w.numpy()) for w in weights]
    f = pl.pallas_call(body, grid=(x.shape[0] // wb,), in_specs=specs,
                       out_specs=_xspec(wb),
                       out_shape=jax.ShapeDtypeStruct(xj.shape, xj.dtype),
                       interpret=True)
    out = f(*args)
    assert out.dtype == xj.dtype
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _close(got, want, x):
    """The limits of the module docstring."""
    assert got.shape == want.shape
    got = got.float()
    branch = want - x.float()
    limit = BRANCH_TOL * branch.abs().max().item()
    if x.dtype == torch.float32:
        err = (got - x - branch).abs().max().item()
        assert err <= limit, err
        return
    step = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    excess = ((got - want).abs() - step - limit).max().item()
    assert excess <= 0, excess


@pytest.mark.parametrize("which", ["script", "sensitive"])
@pytest.mark.parametrize("variant", ap.ABLATIONS)
def test_attn_ablate_reference_matches_the_p1_body(scripts, inputs, variant,
                                                   which):
    x, *weights = inputs[which]
    want = _jax(functools.partial(scripts["p1"].kernel, variant=variant), x,
                weights)
    got = ap.attn_ablate_reference(variant, x, *weights)
    assert got.dtype == x.dtype
    _close(got, want, x)


@pytest.mark.parametrize("which", ["script", "sensitive"])
@pytest.mark.parametrize("wb", [1, 2])
@pytest.mark.parametrize("variant", ["full", "lin"])
def test_attn_slot_reference_matches_the_p5_body(scripts, inputs, variant, wb,
                                                 which):
    """bf16 x at the scripts' inputs, f32 x (bf16 operands, as
    full2d_wb8_f32) at the sensitive ones."""
    x, *weights = inputs[which]
    body = functools.partial(scripts["p2"].slot_kernel, wb=wb, variant=variant)
    want = _jax(body, x, weights, wb)
    got = ap.attn_slot_reference(wb, variant, x, *weights)
    assert got.dtype == x.dtype
    _close(got, want, x)


@pytest.mark.parametrize("body,wb,ops", [("copy_kernel", 1, False),
                                         ("copy_ops_kernel", 1, True),
                                         ("copy_kernel", 8, False)])
def test_copy_reference_matches_the_copy_bodies(scripts, body, wb, ops):
    """P2, P3 and P4 (8 windows per program over 16 windows)."""
    xw, *weights = script_inputs("cpu", micro=1)
    x = xw[:16].contiguous()
    want = _jax(getattr(scripts["p2"], body), x, weights if ops else None, wb)
    got = ap.copy_reference(x, wb, tuple(weights) if ops else None)
    assert got.dtype == x.dtype and torch.equal(got.float(), want)


def test_ablations_differ_at_the_sensitive_inputs(inputs):
    """Every ablation moves the branch far past the limit, so a kernel that
    ran the wrong variant cannot pass."""
    x, *w = inputs["sensitive"]
    full = ap.attn_ablate_reference("full2d", x, *w) - x
    for variant in ap.ABLATIONS[1:]:
        other = ap.attn_ablate_reference(variant, x, *w) - x
        assert (other - full).abs().max() > 25 * BRANCH_TOL * full.abs().max()


def test_cpu_wrappers_take_the_plain_versions_and_count_nothing(inputs):
    _build.launches.clear()
    x, *w = inputs["script"]
    for variant in ap.ABLATIONS:
        assert torch.equal(ap.attn_ablate(variant, x, *w),
                           ap.attn_ablate_reference(variant, x, *w))
    for variant in ap.SLOT_VARIANTS:
        assert torch.equal(ap.attn_slot(2, variant, x, *w),
                           ap.attn_slot_reference(2, variant, x, *w))
    assert torch.equal(ap.copy_windows(x, 4, tuple(w)), x)
    assert sum(_build.launches.values()) == 0


def test_arguments_are_checked(inputs):
    x, wqkv, bias, wproj = inputs["script"]
    with pytest.raises(ValueError, match="variant"):
        ap.attn_ablate("noproj", x, wqkv, bias, wproj)
    with pytest.raises(ValueError, match="variant"):
        ap.attn_slot(1, "full2d", x, wqkv, bias, wproj)
    with pytest.raises(ValueError, match="blocks of 3"):
        ap.attn_slot(3, "full", x, wqkv, bias, wproj)
    with pytest.raises(ValueError, match="wqkv"):
        ap.attn_ablate("full2d", x, wqkv.t().contiguous(), bias, wproj)
    with pytest.raises(ValueError, match="head dim"):
        ap.attn_ablate("full2d", x, wqkv, bias[:1], wproj)
    with pytest.raises(TypeError, match="bf16"):
        ap.copy_windows(x.float())
    with pytest.raises(ValueError, match="multiple of 8"):
        ap.copy_windows(x[:, :, :3].contiguous())


def test_runs_are_the_scripts_runs_in_their_order():
    """The probes' run names and order are the scripts' timeit calls;
    their launch keys are distinct, and the launches per call are 3 for a
    whole half-block, 2 without attention or without the GEMMs, 1 for a
    copy."""
    p1 = re.search(r'for variant in \(([^)]*)\)',
                   SCRIPTS["p1"].read_text(), re.S).group(1)
    assert [r.name for r in attn_ablate.RUNS] == re.findall(r'"(\w+)"', p1)
    assert [r.name for r in attn_ablate2.RUNS] == re.findall(
        r'timeit\("(\w+)"', SCRIPTS["p2"].read_text())
    runs = attn_ablate.RUNS + attn_ablate2.RUNS
    assert len({r.key for r in runs}) == len(runs) == 13
    assert {r.name: r.launches for r in runs if r.launches != 3} == {
        "linear_only": 2, "attn_only": 2, "copy_only": 1, "copy_ops": 1,
        "copy_only_wb8": 1, "lin2d_wb8": 2}


def test_probe_entry_points_run_on_the_cpu(capsys):
    """Both entry points at micro-batch 1 on the CPU: one line per run in
    the scripts' order after the host-clock note, nothing launched."""
    _build.launches.clear()
    times = attn_ablate.main("cpu", micro=1, reps=1, warmup=0)
    times.update(attn_ablate2.main("cpu", micro=1, reps=1, warmup=0))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("cpu: host-clock") and len(lines) == 15
    assert [ln.split()[0] for ln in lines[1:7] + lines[8:]] == list(times)
    assert all(t > 0 for t in times.values())
    assert sum(_build.launches.values()) == 0
