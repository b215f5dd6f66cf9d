"""The port imports no JAX, flax, PyYAML or triton, nor pandas, msgpack or
scikit-learn (the card's machine has none of the last three), and on CPU
tensors every kernel wrapper runs its plain version, forward and backward,
without launching anything."""

import subprocess
import sys
from pathlib import Path

import torch

from vsn_tpu_torch.ops import _build
from vsn_tpu_torch.ops import stem_im2col as stem
from vsn_tpu_torch.ops import swin_block_kernels as sbk
from vsn_tpu_torch.ops import window_attention as wa
from vsn_tpu_torch.ops import window_relayout as wr

ROOT = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax_flax_or_triton():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "vsn_tpu_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'triton',"
        " 'yaml', 'vsn_tpu', 'pandas', 'msgpack', 'sklearn'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(modules) >= 25
    for name in ("train.losses", "train.schedules", "train.optim",
                 "train.ema", "train.step", "data.mixers", "ops.stem_im2col",
                 "ops.conv_unfold", "models.resnet3d", "models.medvit3d",
                 "ops.window_attention",
                 "ops.attn_probe", "probes.__init__", "probes.attn_ablate",
                 "probes.attn_ablate2", "train.checkpoint",
                 "eval.bootstrap", "eval.calibration",
                 "eval.calibrate_predictions", "eval.tta", "eval.evaluate",
                 "utils.nifti", "data.folds", "data.preprocessing",
                 "data.synthetic", "data.pipeline", "utils.rng",
                 "data.sampler", "data.resident", "train.metrics",
                 "train.trainer", "train.cli", "utils.tracking",
                 "utils.profiling"):
        assert f"vsn_tpu_torch.{name}" in modules


def _attn_args(bw=4, n=6, c=8, heads=2):
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    return (r(bw, n, c), torch.ones(c), torch.zeros(c), r(3 * c, c),
            r(3 * c), r(heads, n, n), torch.zeros(2, n, dtype=torch.int32),
            r(c, c), r(c), torch.ones(2), torch.full((2,), 0.5), 0.5, heads)


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    _build.launches.clear()
    args = _attn_args()
    assert torch.equal(sbk.attn_half(*args), sbk.attn_half_reference(*args))
    x = torch.randn(6, 8)
    mlp = (x, torch.ones(8), torch.zeros(8), torch.randn(16, 8),
           torch.randn(16), torch.randn(8, 16), torch.randn(8),
           torch.ones(2), torch.full((2,), 0.5))
    assert torch.equal(sbk.ln_mlp(*mlp), sbk.ln_mlp_reference(*mlp))
    xg = args[0].clone().requires_grad_()
    sbk.attn_half(xg, *args[1:]).sum().backward()
    xg = x.clone().requires_grad_()
    sbk.ln_mlp(xg, *mlp[1:]).sum().backward()
    v = torch.randn(1, 4, 6, 4, 3)
    wins = wr.spatial_to_windows(v, (2, 3, 2), (1, 1, 1))
    assert torch.equal(wins,
                       wr.spatial_to_windows_reference(v, (2, 3, 2), (1, 1, 1)))
    wr.windows_to_windows(wins, (2, 3, 2), (4, 6, 4), (1, 1, 1))
    wr.windows_to_spatial(wins, (2, 3, 2), (4, 6, 4), (-1, -1, -1))
    xs = torch.randn(1, 6, 8, 6, 1)
    kern = torch.randn(7, 7, 7, 1, 8, requires_grad=True)
    y = stem.stem_conv_im2col(xs, kern, (1, 2, 2), (3, 3, 3))
    assert torch.equal(y, stem.stem_conv_reference(xs, kern, (1, 2, 2),
                                                   (3, 3, 3)))
    y.sum().backward()
    assert torch.equal(stem.stem_conv_dw(xs, torch.ones_like(y), (7, 7, 7),
                                         (1, 2, 2), (3, 3, 3)), kern.grad)
    qkv = torch.randn(4, 6, 24, requires_grad=True)
    k4 = (qkv, torch.randn(2, 6, 6), torch.zeros(2, 6, dtype=torch.int32), 0.5,
          2)
    out = wa.window_attention_qkv(*k4)
    assert torch.equal(out, wa.window_attention_qkv_reference(*k4))
    out.sum().backward()
    assert qkv.grad is not None
    q, k, v = (torch.randn(4, 2, 6, 3, requires_grad=True) for _ in range(3))
    v1 = (q, k, v, torch.randn(2, 6, 6), torch.zeros(2, 6, dtype=torch.int32),
          0.5)
    out = wa.window_attention(*v1)
    assert torch.equal(out, wa.window_attention_split_reference(*v1))
    out.sum().backward()
    assert q.grad is not None and v.grad is not None
    qkv = torch.randn(2, 4, 6, 4, 24, requires_grad=True)
    v3 = (qkv, torch.randn(2, 12, 12), torch.zeros(3, 12, dtype=torch.int32),
          0.5, 2, (2, 3, 2))
    out = wa.window_attention_windows(*v3)
    assert torch.equal(out, wa.window_attention_windows_reference(*v3))
    out.sum().backward()
    assert qkv.grad is not None
    assert sum(_build.launches.values()) == 0


def test_library_is_named_by_its_sources_and_builds_under_build():
    so = _build.library_path()
    assert so.parent == ROOT / "build"
    names = {p.name for p in _build.CSRC.glob("*.cu")}
    assert names == {"attn_half.cu", "attn_half_bwd.cu", "ln_mlp.cu",
                     "ln_mlp_bwd.cu", "stem_im2col.cu", "window_relayout.cu",
                     "window_attention_qkv.cu", "probe_copy.cu", "gemm.cu",
                     "row_kernels.cu"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_ptxas_report_parses_registers_and_spills():
    """probes/ptxas.py (registers and spills per kernel, from nvcc
    -Xptxas -v): a kernel with spills and one without."""
    from vsn_tpu_torch.probes.ptxas import parse

    text = (
        "ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1av\n"
        "    208 bytes stack frame, 196 bytes spill stores, 296 bytes spill "
        "loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers, 208 bytes "
        "cumulative stack size\n"
        "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1bv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers\n")
    assert parse(text) == [("_Z1av", 128, 196, 296), ("_Z1bv", 40, 0, 0)]


def test_ptxas_against_matches_kernels_by_demangled_name(monkeypatch,
                                                          tmp_path):
    """``--against``: a kernel's anonymous-namespace mangled name differs
    between two source trees, so the report pairs kernels by demangled
    name, and only those both trees compile."""
    from vsn_tpu_torch.probes import ptxas

    reports = {
        ptxas.CSRC: {"gemm.cu": [("_ZN_a1_k1", 180, 0, 0),
                                 ("_ZN_a1_k2", 48, 0, 0)]},
        tmp_path: {"gemm.cu": [("_ZN_b2_k1", 178, 0, 0),
                               ("_ZN_b2_k3", 64, 0, 0)]},
    }
    monkeypatch.setattr(ptxas, "report", lambda sources: reports[
        sources[0].parent])
    monkeypatch.setattr(ptxas, "_demangle", lambda names: [
        n.rsplit("_", 1)[1] for n in names])
    assert ptxas.against(tmp_path, ["gemm.cu"]) == [
        ("gemm.cu", "k1", 180, 178, 0)]

