"""The port imports no JAX, flax, PyYAML or triton, and on CPU tensors every
kernel wrapper runs its plain version, forward and backward, without
launching anything."""

import subprocess
import sys
from pathlib import Path

import torch

from vsn_tpu_torch.ops import _build
from vsn_tpu_torch.ops import stem_im2col as stem
from vsn_tpu_torch.ops import swin_block_kernels as sbk
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
        " 'yaml', 'vsn_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(modules) >= 25
    for name in ("train.losses", "train.schedules", "train.optim",
                 "train.ema", "train.step", "data.mixers", "ops.stem_im2col",
                 "ops.conv_unfold", "models.resnet3d"):
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
    assert sum(_build.launches.values()) == 0


def test_library_is_named_by_its_sources_and_builds_under_build():
    so = _build.library_path()
    assert so.parent == ROOT / "build"
    names = {p.name for p in _build.CSRC.glob("*.cu")}
    assert names == {"attn_half.cu", "attn_half_bwd.cu", "ln_mlp.cu",
                     "ln_mlp_bwd.cu", "stem_im2col.cu", "window_relayout.cu"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
