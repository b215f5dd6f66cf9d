"""Drive the port's Swin-3D and ResNet-3D training steps and inference paths
on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device, nvcc (on PATH or under CUDA_HOME) and the checkout;
it imports torch and the port (``vsn_tpu_torch``), never JAX. It runs on
one card (CUDA_VISIBLE_DEVICES defaults to 0). Models are built on the card
(``build_model``). Phases:

1. build the hand-written kernels from ``vsn_tpu_torch/csrc`` (one nvcc per
   source, in parallel, into build/);
2. print the card's name and power limit (nvidia-smi);
3. forward parity: every K1/K2/K3 call of a Swin-T eval forward at batch 2
   in f32 and in bf16, and at the eval path's batch 4 in bf16 (all four
   stages: shifted, unshifted, padded with -1 pad ids, clamped N = 150).
   K1/K2 parameters are replaced by seeded non-trivial ones (LayerNorm scale
   1 + 0.1 z, shifts and biases 0.1 z, projections fan_in^-0.5 z, an O(1)
   relative-position bias) and the samples get distinct forward and
   backward gains (gf != gb). Each K1/K2 call is checked with lam = 0 (the
   gained branch alone) and lam = 1 (the residual); f32 max|d| <= 1e-4 of
   the output scale (TF32 off), bf16 <= 2e-2; the movers bit-exact;
4. backward parity: the K1/K2/K3 calls of a training forward (ShakeDrop
   draws), f32 and bf16 at batch 2 and the training path's bf16 calls at
   micro-batch 8, with the same seeded parameters and gains, lam 0 and 1.
   Every gradient of K1b (dx, LN w/b, qkv w/b, bias, proj w/b) and K2b (dx,
   LN w/b, fc1 w/b, fc2 w/b) is held to the plain backward for one seeded
   cotangent, each relative to its own scale (f32 1e-4, bf16 2e-2); K1b
   also at saturated logits (bias 8 z + 45 and 8 z + 200, f32, as
   tests/test_swin_block_kernels.py saturates them): finite and within
   tolerance; the movers' adjoints bit-exact;
5. K5 parity: the stem conv K5f and its weight gradient K5w against their
   plain versions (the f32 conv of dtype-rounded operands, and its VJP) in
   f32 (1e-4 of scale, TF32 off) and bf16 (2e-2) at batch 2 on the
   geometries of tests/test_stem_im2col.py (ResNet and MedViT stems,
   stride 1, the odd 9x11x13 extent) and the ResNet stem at 16x18x16 x 64,
   then in bf16 at the slice's shape, x [12, 144, 168, 144, 1] (2e-2);
   their times beside the plain versions' and the library calls' (cuDNN
   conv3d in bf16, channels-last, and conv3d_weight);
6. the Swin eval path: Swin-T 5c with the flagship recipe's ShakeDrop eval
   gains, ``Evaluator`` over 8 seeded float16 144x168x144 volumes in
   batches of 4, launch counters 0 before and exactly 12 (K1) / 12 (K2) /
   7 (K3) per forward after, none of K5; probs finite, rows summing to 1,
   within 1e-2 of the plain path, argmax agreeing wherever the plain top
   two are further apart than twice that difference; ms per batch and vol/s
   of both paths;
7. the Swin training path: ``init_train_state`` -> ``make_train_step`` for
   Swin-T 5c in bf16 with the flagship recipe (SAM, EMA of 3, MixUp p = 0.5,
   ShakeDrop, label smoothing 0.1), micro-batch 8, two micro-batches per
   step, on 16 seeded float16 volumes and their MixUp partners laid out as
   bench.py lays them out. After one backward every parameter has a finite,
   non-zero gradient. Then one warm-up step and 3 timed steps on the kernel
   route with every launch counter at 0 before and exact after (per
   micro-batch and SAM pass: 12 K1f, 12 K1b, 12 K2f, 12 K2b, 7 movers and 7
   adjoints); losses and grad norms finite, nothing skipped, parameters
   finite and moved by the second step (lr is 0 at step 0 under LR_WARMUP
   50), EMA weights apart from the live ones; the EMA weights through
   ``Evaluator``; then the same initial state, batches and injected draws
   for 2 steps on the plain route: per-step loss within 2e-2 and grad norm
   within 5e-2 (relative) of the kernel route;
8. each Swin kernel's time per micro-batch at the training shapes beside
   its plain version's (the eval phase times the forwards at batch 4);
9. the ResNet eval path: ResNet-18 5c (resnet-5c-no_seed-baseline: head
   dropout 0.1, bf16), seeded weights whose BatchNorm statistics are
   re-estimated by ``make_bn_refresh_step`` over 8 volumes, ``Evaluator``
   over the 8 volumes in batches of 4: exactly 1 K5f and no other launch
   per forward; probs as in phase 6 against the plain stem;
10. the ResNet training path (the slice's main path): the same recipe
   without ShakeDrop (the ResNet has no residual gains), micro-batch 12 x
   2, injected head-dropout masks: every parameter reached by one
   backward; 1 + 3 steps with exactly 1 K5f and 1 K5w per micro-batch and
   SAM pass and no other launch; parameters and EMA as in phase 7; the
   BatchNorm statistics moved and the EMA's apart from the live ones; the
   EMA weights and statistics through ``Evaluator``; 2 plain-stem steps
   from the same state within 2e-2 / 5e-2;
11. each kernel's time beside its bound: the larger of the bytes its calls
   move (inputs read once, outputs written once) over 3.35 TB/s and the
   products they compute over 989 TFLOP/s (bf16), from this run's shapes.
torch.profiler runs over one Swin eval pass, one Swin and one ResNet train
step: device time by kernel and the device's idle share (traces in build/).

Every failure raises (exit code 1). The last lines are one JSON object of
per-kernel results and then {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

import numpy as np

BATCH, N_VOLUMES, SEED = 4, 8, 0
TRAIN_MICRO, TRAIN_ACCUM, TIMED_STEPS, PLAIN_STEPS = 8, 2, 3, 2
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_RTOL = {"loss": 2e-2, "grad_norm": 5e-2}  # kernel vs plain route, bf16
PATH_LAM = 1.0  # the residual x-gain every block of the main path passes

KERNELS = {  # name -> (source, TPU kernel it replaces)
    "attn_half": ("vsn_tpu_torch/csrc/attn_half.cu",
                  "vsn_tpu/ops/swin_block_kernels.py:525"),
    "attn_half_bwd": ("vsn_tpu_torch/csrc/attn_half_bwd.cu",
                      "vsn_tpu/ops/swin_block_kernels.py:560"),
    "ln_mlp": ("vsn_tpu_torch/csrc/ln_mlp.cu",
               "vsn_tpu/ops/swin_block_kernels.py:1025"),
    "ln_mlp_bwd": ("vsn_tpu_torch/csrc/ln_mlp_bwd.cu",
                   "vsn_tpu/ops/swin_block_kernels.py:1049"),
    "spatial_to_windows": ("vsn_tpu_torch/csrc/window_relayout.cu",
                           "vsn_tpu/ops/window_relayout.py:184"),
    "windows_to_windows": ("vsn_tpu_torch/csrc/window_relayout.cu",
                           "vsn_tpu/ops/window_relayout.py:257"),
    "windows_to_spatial": ("vsn_tpu_torch/csrc/window_relayout.cu",
                           "vsn_tpu/ops/window_relayout.py:335"),
    "spatial_to_windows_adjoint": ("vsn_tpu_torch/csrc/window_relayout.cu",
                                   "vsn_tpu/ops/window_relayout.py:141"),
    "windows_to_windows_adjoint": ("vsn_tpu_torch/csrc/window_relayout.cu",
                                   "vsn_tpu/ops/window_relayout.py:176"),
    "windows_to_spatial_adjoint": ("vsn_tpu_torch/csrc/window_relayout.cu",
                                   "vsn_tpu/ops/window_relayout.py:151"),
    "stem_im2col": ("vsn_tpu_torch/csrc/stem_im2col.cu",
                    "vsn_tpu/ops/stem_im2col.py:249"),
    "stem_im2col_dw": ("vsn_tpu_torch/csrc/stem_im2col.cu",
                       "vsn_tpu/ops/stem_im2col.py:291"),
}
STEM = ("stem_im2col", "stem_im2col_dw")
BLOCK_KERNELS = ("attn_half", "ln_mlp")
MOVERS = ("spatial_to_windows", "windows_to_windows", "windows_to_spatial")
# Launches per Swin-T forward: 12 blocks (depths 2+2+6+2), one K1 and one K2
# each; the window-resident stages 1, 2 and 4 enter through
# spatial_to_windows (3), stages 1 and 2 glue one shifted junction each
# (windows_to_windows, 2) and leave in the shifted layout
# (windows_to_spatial, 2); stage 4 is unshifted and leaves through a plain
# reshape, stage 3 (padded) uses no mover.
PER_FORWARD = {"attn_half": 12, "ln_mlp": 12, "spatial_to_windows": 3,
               "windows_to_windows": 2, "windows_to_spatial": 2}
# per micro-batch and SAM pass of training: the forward's launches, and the
# backward's mirror (K1b, K2b, one adjoint per mover call)
PER_PASS = {**PER_FORWARD, "attn_half_bwd": 12, "ln_mlp_bwd": 12,
            **{f"{m}_adjoint": PER_FORWARD[m] for m in MOVERS}}
# ResNet-18 launches per forward (the 7^3 stem conv) and per micro-batch and
# SAM pass of training (the stem and its weight gradient; dx is not taken)
RESNET_PER_FORWARD = {"stem_im2col": 1}
RESNET_PER_PASS = {"stem_im2col": 1, "stem_im2col_dw": 1}
RESNET_PRESET, RESNET_MICRO = "resnet-5c-no_seed-baseline", 12
# K5 parity geometries, (shape DHW, kernel, strides, C_out): those of
# tests/test_stem_im2col.py (the ResNet and MedViT stems, stride 1, odd
# extents) and the ResNet stem at 16x18x16 with 64 channels; then the
# slice's own stem call at micro-batch 12
STEM_GEOMS = [((12, 14, 12), (7, 7, 7), (1, 2, 2), 16),
              ((12, 14, 12), (3, 3, 3), (2, 2, 2), 16),
              ((8, 10, 8), (3, 3, 3), (1, 1, 1), 16),
              ((9, 11, 13), (3, 5, 3), (2, 2, 1), 16),
              ((16, 18, 16), (7, 7, 7), (1, 2, 2), 64)]
RESNET_STEM = ((144, 168, 144), (7, 7, 7), (1, 2, 2), 64)
# H100 SXM datasheet peaks: HBM bytes/s and dense FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# the forward call whose arguments set a kernel's work (bound_ms)
FORWARD_OF = {"attn_half_bwd": "attn_half", "ln_mlp_bwd": "ln_mlp",
              "stem_im2col_dw": "stem_im2col", "attention": "attn_half",
              "attention_bwd": "attn_half", "copy": "attn_half",
              **{f"{m}_adjoint": m for m in MOVERS}}
# attn_half cases the parity sets must cover at the flagship geometry
ATTN_CASES = {"shifted ids", "padded ids", "no mask", "N=150"}
# differentiable arguments of the block kernels: (index, gradient name)
DIFF = {
    "attn_half": ((0, "dx"), (1, "dnorm_w"), (2, "dnorm_b"), (3, "dqkv_w"),
                  (4, "dqkv_b"), (5, "dbias"), (7, "dproj_w"),
                  (8, "dproj_b")),
    "ln_mlp": ((0, "dx"), (1, "dnorm_w"), (2, "dnorm_b"), (3, "dfc1_w"),
               (4, "dfc1_b"), (5, "dfc2_w"), (6, "dfc2_b")),
}


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def kernel_table():
    """name -> (kernel wrapper, plain version) of the forward wrappers the
    model calls; the block kernels' plain versions carry the plain
    backward."""
    from vsn_tpu_torch.ops import swin_block_kernels as sbk
    from vsn_tpu_torch.ops import window_relayout as wr

    return {
        "attn_half": (sbk.attn_half, sbk.attn_half_reference),
        "ln_mlp": (sbk.ln_mlp, sbk.ln_mlp_reference),
        "spatial_to_windows": (wr.spatial_to_windows,
                               wr.spatial_to_windows_reference),
        "windows_to_windows": (wr.windows_to_windows,
                               wr.windows_to_windows_reference),
        "windows_to_spatial": (wr.windows_to_spatial,
                               wr.windows_to_spatial_reference),
    }


@contextmanager
def patched_model_ops(replace):
    """Route the model's kernel calls (models/swin3d.py names) through
    ``replace(name, kernel, plain)``."""
    from vsn_tpu_torch.models import swin3d

    table = kernel_table()
    new = {name: replace(name, *fns) for name, fns in table.items()}
    with mock.patch.multiple(swin3d, **new):
        yield


def record_calls(model, images, **kwargs):
    """Every kernel call of one forward, run through the plain versions:
    [(name, args)]. No graph is kept, and the tensors are ordinary ones, so
    the backward phase can differentiate through them."""
    import torch

    calls = []

    def recorder(name, kernel, plain):
        def fn(*args):
            calls.append((name, args))
            return plain(*args)
        return fn

    with torch.no_grad(), patched_model_ops(recorder):
        model(images, **kwargs)
    return calls


def sample_gains(b, device):
    """Distinct per-sample forward and backward gains, gf != gb in every
    sample, so a wrong sample index or a backward using gf shows."""
    import torch

    return (torch.linspace(0.6, 1.4, b, device=device),
            torch.linspace(1.25, 0.35, b, device=device))


def seeded_params(name, args, gen):
    """A K1/K2 call with its parameters and gains replaced by seeded
    non-trivial ones.

    Init-scale weights (trunc-normal 0.02, zero biases, unit LayerNorm) make
    the branches tiny against the residual, so a kernel missing a term could
    still agree. Here LayerNorm scale is 1 + 0.1 z, shifts and biases are
    0.1 z, projections are fan_in^-0.5 z (O(1) activations and logits at
    every width) and the relative-position bias is z: each term moves the
    output by far more than the tolerance. Activations and ids stay as the
    forward gave them; the movers' calls are returned as they are."""
    import torch

    if name not in BLOCK_KERNELS:
        return args
    x = args[0]
    c = x.shape[-1]

    def r(*shape, k=1.0):
        return (torch.randn(*shape, generator=gen) * k).to(x.device)

    if name == "attn_half":
        (x, _, _, _, qkv_b, bias, ids, _, _, gf, _, scale, heads) = args
        return (x, 1 + r(c, k=0.1), r(c, k=0.1), r(3 * c, c, k=c ** -0.5),
                None if qkv_b is None else r(3 * c, k=0.1),
                None if bias is None else r(*bias.shape), ids,
                r(c, c, k=c ** -0.5), r(c, k=0.1),
                *sample_gains(gf.shape[0], x.device), scale, heads)
    (x, _, _, fc1_w, _, _, _, gf, _) = args
    hid = fc1_w.shape[0]
    return (x, 1 + r(c, k=0.1), r(c, k=0.1), r(hid, c, k=c ** -0.5),
            r(hid, k=0.1), r(c, hid, k=hid ** -0.5), r(c, k=0.1),
            *sample_gains(gf.shape[0], x.device))


def case_kind(name, args):
    """The case a call exercises, e.g. 'shifted ids' or 'N=150'."""
    if name == "attn_half":
        ids = args[6]
        kinds = {"no mask" if ids is None else
                 "padded ids" if bool((ids < 0).any()) else "shifted ids",
                 f"N={args[0].shape[1]}"}
        return kinds if args[5] is not None else kinds | {"no bias"}
    if name == "ln_mlp":
        return {f"C={args[0].shape[-1]}"}
    return {f"roll={tuple(args[-1])}"}


def compare(name, kernel, plain, args, lam=None):
    """(max|d|, limit, ok) of one forward call of ``kernel`` against
    ``plain``."""
    import torch

    kw = {} if lam is None else {"lam": lam}
    with torch.inference_mode():
        got, want = kernel(*args, **kw), plain(*args, **kw)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(want.shape)}/{want.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    if name not in BLOCK_KERNELS:
        return err, 0.0, bool(torch.equal(got, want))
    dtype = str(want.dtype).removeprefix("torch.")
    limit = TOL[dtype] * max(1.0, want.float().abs().max().item())
    return err, limit, err <= limit


def _grads(fn, args, lam, dout, index):
    """Gradients of <fn(*args, lam), dout> w.r.t. the arguments at ``index``
    that are not None: {index: grad}."""
    import torch

    args = list(args)
    leaves = [i for i in index if args[i] is not None]
    for i in leaves:
        args[i] = args[i].detach().clone().requires_grad_()
    kw = {} if lam is None else {"lam": lam}
    out = fn(*args, **kw)
    if out.grad_fn is None:
        raise AssertionError("the output carries no graph")
    grads = torch.autograd.grad(out, [args[i] for i in leaves], dout)
    return out, dict(zip(leaves, grads))


def grad_compare(name, kernel, plain, args, lam, gen):
    """[(grad name, max|d|, limit, ok)] of the VJP of one call of ``kernel``
    against ``plain``'s for one seeded cotangent: block kernels to TOL of
    each gradient's own scale (and finite), movers bit-exact."""
    import torch

    x = args[0]
    if name in MOVERS:
        with torch.no_grad():
            shape = plain(*args).shape
    else:
        shape = x.shape   # K1 and K2 keep their input's shape
    dout = torch.randn(shape, generator=gen).to(x.device, x.dtype)
    if name in MOVERS:
        out, got = _grads(kernel, args, None, dout, (0,))
        ref, want = _grads(plain, args, None, dout, (0,))
        ok = torch.equal(out, ref) and torch.equal(got[0], want[0])
        err = (got[0].float() - want[0].float()).abs().max().item()
        return [("adjoint", err, 0.0, bool(ok))]
    index = [i for i, _ in DIFF[name]]
    _, got = _grads(kernel, args, lam, dout, index)
    _, want = _grads(plain, args, lam, dout, index)
    dtype = str(x.dtype).removeprefix("torch.")
    rows = []
    for i, gname in DIFF[name]:
        if i not in want:
            continue
        g, w = got[i].float(), want[i].float()
        if got[i].dtype != want[i].dtype or g.shape != w.shape:
            raise AssertionError(f"{name} {gname}: {got[i].dtype} "
                                 f"{tuple(g.shape)} vs {want[i].dtype} "
                                 f"{tuple(w.shape)}")
        err = (g - w).abs().max().item()
        limit = TOL[dtype] * w.abs().max().item()
        rows.append((gname, err, limit,
                     bool(torch.isfinite(g).all()) and err <= limit))
    return rows


def _report(label, groups, kinds, failed):
    for (name, check), g in groups.items():
        limit = ("bit-exact" if g["exact"] else
                 f"worst {g['ratio']:.3f} of the limit")
        log(f"parity {label} {name} {check}: {g['n']} calls "
            f"({', '.join(sorted(kinds[name]))}), max|d| "
            f"{g['err']:.3e} ({limit}) "
            f"{'ok' if not g['bad'] else 'FAIL in %d' % g['bad']}")
        if g["bad"]:
            failed.append(f"{label} {name} {check}")


def _group(groups, key, err, limit, ok):
    g = groups.setdefault(key, {"n": 0, "err": 0.0, "ratio": 0.0, "bad": 0,
                                "exact": not limit})
    g["n"] += 1
    g["err"] = max(g["err"], err)
    g["ratio"] = max(g["ratio"], err / limit if limit else 0.0)
    g["bad"] += not ok


def parity_phase(sets, table, gen):
    """Hold every recorded call of every set against its plain version.

    sets: {label: [(name, args)]}; table: kernel_table(). Logs one line per
    (set, kernel, check) and raises AssertionError naming every group that
    failed. Returns ({name: worst max|d|}, {label: {name: case kinds}})."""
    worst = collections.defaultdict(float)
    kinds = {}
    failed = []
    for label, calls in sets.items():
        kinds[label] = collections.defaultdict(set)
        groups = {}
        for name, args in calls:
            kernel, plain = table[name]
            args = seeded_params(name, args, gen)
            kinds[label][name] |= case_kind(name, args)
            checks = ((("branch", 0.0), ("residual", PATH_LAM))
                      if name in BLOCK_KERNELS else (("exact", None),))
            for check, lam in checks:
                err, limit, ok = compare(name, kernel, plain, args, lam)
                _group(groups, (name, check), err, limit, ok)
                worst[name] = max(worst[name], err)
        _report(label, groups, kinds[label], failed)
    if failed:
        raise AssertionError("kernels disagree with their plain versions: "
                             + "; ".join(failed))
    return dict(worst), kinds


def backward_name(name):
    return f"{name}_bwd" if name in BLOCK_KERNELS else f"{name}_adjoint"


def grad_parity_phase(sets, table, gen):
    """Hold the VJP of every recorded call against its plain version's, as
    ``parity_phase`` holds the forwards (lam 0 and 1 for the block kernels;
    one line per (set, backward kernel, check)). Returns ({backward kernel
    name: worst max|d|}, {label: {name: case kinds}})."""
    worst = collections.defaultdict(float)
    all_kinds = {}
    failed = []
    for label, calls in sets.items():
        kinds = all_kinds[label] = collections.defaultdict(set)
        groups = {}
        for name, args in calls:
            kernel, plain = table[name]
            args = seeded_params(name, args, gen)
            bname = backward_name(name)
            kinds[bname] |= case_kind(name, args)
            lams = (0.0, PATH_LAM) if name in BLOCK_KERNELS else (None,)
            for lam in lams:
                for gname, err, limit, ok in grad_compare(name, kernel, plain,
                                                          args, lam, gen):
                    check = gname if lam is None else f"{gname} lam={lam:g}"
                    _group(groups, (bname, check), err, limit, ok)
                    worst[bname] = max(worst[bname], err)
        _report(label, groups, kinds, failed)
    if failed:
        raise AssertionError("backward kernels disagree with their plain "
                             "versions: " + "; ".join(failed))
    return dict(worst), all_kinds


def saturation_phase(calls, table, gen, logits=(45.0, 200.0)):
    """K1b at saturated logits: a shifted, masked K1 call of ``calls`` (f32)
    with its bias set to 8 z + logit (z the seeded bias), so the logits sit
    near ``logit``; every gradient finite and within tolerance of the plain
    backward."""
    kernel, plain = table["attn_half"]
    name, args = next((n, a) for n, a in calls if n == "attn_half"
                      and a[6] is not None and a[5] is not None)
    args = list(seeded_params(name, args, gen))
    bias = args[5]
    for logit in logits:
        args[5] = bias * 8 + logit
        rows = grad_compare(name, kernel, plain, args, PATH_LAM, gen)
        ratio = max(err / limit for _, err, limit, _ in rows)
        bad = [g for g, _, _, ok in rows if not ok]
        log(f"parity saturated logits {logit:g}: K1b {len(rows)} grads, "
            f"worst {ratio:.3f} of the limit {'ok' if not bad else 'FAIL'}")
        if bad:
            raise AssertionError(f"K1b at logits {logit:g}: {bad}")


def volumes(n, seed):
    """Seeded float16 MRI-sized volumes [n, 144, 168, 144, 1]."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 144, 168, 144, 1), np.float32) * 50
            + 100).astype(np.float16)


def train_batch(cfg, device, seed):
    """One step's batch as bench.py lays it out: [A, micro, D, H, W, 1]
    float16 images and MixUp partners, one-hot labels, lam ~ Beta(0.3,
    0.3), apply with p = 0.5."""
    import torch

    rng = np.random.default_rng(seed)
    a, micro, k = TRAIN_ACCUM, cfg.BATCH_SIZE, cfg.num_classes
    shape = (a, micro, *cfg.input_size, 1)
    eye = np.eye(k, dtype=np.float32)
    batch = {
        "image": rng.standard_normal(shape, np.float32).astype(np.float16),
        "image2": rng.standard_normal(shape, np.float32).astype(np.float16),
        "label": eye[rng.integers(0, k, (a, micro))],
        "label2": eye[rng.integers(0, k, (a, micro))],
        "mix_lam": rng.beta(0.3, 0.3, (a, micro)).astype(np.float32),
        "mix_apply": rng.random((a, micro)) < cfg.MIXUP_PROB,
        "mix_bounds": np.zeros((a, micro, 6), np.int32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


class Draws:
    """The random draws of each (step, micro-batch, pass), drawn once from a
    generator seeded by ``draw_seed`` and handed to every route: Swin's
    residual gains, the ResNet's head-dropout mask (``model.draw``)."""

    def __init__(self, model, micro, device, seed):
        self.model, self.micro, self.device, self.seed = (model, micro,
                                                          device, seed)
        self.table = {}

    def __call__(self, step, idx, pass_idx):
        import torch
        from vsn_tpu_torch.train.step import draw_seed

        key = (step, idx, pass_idx)
        if key not in self.table:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(draw_seed(self.seed, *key))
            self.table[key] = self.model.draw(self.micro, self.device, gen)
        return self.table[key]


def train_route(model, cfg, state, batch, draws, steps, sync):
    """Run ``steps`` train steps; returns ([metrics as floats], [seconds
    each])."""
    from vsn_tpu_torch.train.schedules import lr_wd_schedules
    from vsn_tpu_torch.train.step import make_batch_transform, make_train_step

    lr, wd = lr_wd_schedules(cfg)
    step = make_train_step(model, cfg, lr, wd, make_batch_transform(cfg),
                           draws)
    metrics, secs = [], []
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        m = step(state, batch)
        sync()
        secs.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, secs


def first_backward_grads(model, cfg, state, batch, draws):
    """One accumulation pass; returns the names of parameters whose gradient
    is zero or not finite (every one must be reached)."""
    import torch
    from vsn_tpu_torch.train.step import make_batch_transform, make_grad_fn

    make_grad_fn(model, cfg, make_batch_transform(cfg), draws)(state, batch,
                                                               0)
    return [name for name, g in state.params.tree(state.params.grad).items()
            if not bool(torch.isfinite(g).all()) or not bool((g != 0).any())]


@contextmanager
def plain_stem():
    """Route the ResNet stem (ops/conv_unfold.py's call) through the plain
    conv, whose backward is autograd's conv VJP."""
    from vsn_tpu_torch.ops import conv_unfold, stem_im2col

    with mock.patch.object(conv_unfold, "stem_conv_im2col",
                           stem_im2col.stem_conv_reference):
        yield


def check_probs(probs, n, k):
    """[n, k] finite probabilities whose rows sum to 1."""
    if probs.shape != (n, k):
        raise AssertionError(f"probs shape {probs.shape}")
    if not np.isfinite(probs).all():
        raise AssertionError("non-finite probs")
    row_err = np.abs(probs.sum(1) - 1).max()
    if row_err > 1e-3:
        raise AssertionError(f"prob rows sum off by {row_err}")


def compare_probs(label, probs, plain):
    """The kernel path's probs within 1e-2 of the plain path's, and the
    same argmax for every volume whose top two plain probs are further
    apart than twice the largest difference (elsewhere the order is within
    rounding)."""
    d = float(np.abs(probs - plain).max())
    top2 = np.sort(plain, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * d
    agree = probs.argmax(1) == plain.argmax(1)
    log(f"{label} vs plain path: max|d probs| {d:.3e} (<= 1e-2), argmax "
        f"agrees on {int(agree.sum())}/{len(probs)} ({int(decided.sum())} "
        f"decided), probs range [{probs.min():.4f}, {probs.max():.4f}]")
    if d > 1e-2 or not agree[decided].all():
        raise AssertionError(f"{label}: kernel path probs differ from the "
                             f"plain path's by {d}, argmax {agree}")


def eval_rates(evaluator, images, plain, n_batches, label, card):
    """Eval vol/s of the kernel and the plain route (``plain()`` a context
    manager), in the order kernel, plain, plain, kernel."""
    import torch

    def timed():
        torch.cuda.synchronize()
        t = time.perf_counter()
        evaluator.predict(images)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    runs = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        if which == "plain":
            with plain():
                runs[which].append(timed())
        else:
            runs[which].append(timed())
    for which, secs in runs.items():
        mean = sum(secs) / len(secs)
        log(f"[{card}] {label} {which} path: {1e3 * mean / n_batches:.1f} ms "
            f"per batch of {evaluator.batch_size} (transfer + z-score + "
            f"forward + softmax), {len(images) / mean:.2f} vol/s")


def reach_every_parameter(model, cfg, state, batch, draws, label):
    """After one backward every parameter has a finite, non-zero
    gradient."""
    missing = first_backward_grads(model, cfg, state, batch, draws)
    n_params = len(state.params.names)
    log(f"{label} path: first backward reached {n_params - len(missing)} of "
        f"{n_params} parameters (non-zero, finite)")
    if missing:
        raise AssertionError(f"{label}: no gradient reached {missing}")


def params_moved(state, initial, after0, label):
    """Finite parameters that step 0 (lr 0 under LR_WARMUP) left alone and
    step 1 moved, and EMA weights apart from the live ones."""
    import torch

    flat = state.params.flat
    if not bool(torch.isfinite(flat).all()):
        raise AssertionError(f"{label}: non-finite parameters")
    if not torch.equal(after0, initial):
        raise AssertionError(f"{label}: step 0 (lr 0 under LR_WARMUP) moved "
                             "the parameters")
    moved = (flat - after0).abs().max().item()
    ema_gap = (state.ema.ema[:flat.numel()] - flat).abs().max().item()
    log(f"{label} path: parameters moved by {moved:.3e} after step 1, EMA "
        f"{ema_gap:.3e} from the live weights, skipped {int(state.skipped)}")
    if not moved > 0 or not ema_gap > 0:
        raise AssertionError(f"{label}: parameters did not move or the EMA "
                             "equals them")


def report_routes(label, kernel, plain, kernel_secs, plain_secs, vols,
                  recipe, card):
    """Check the plain route's steps against the kernel route's and log
    both routes' rates."""
    rel = check_train_metrics(kernel, plain)
    for i, (k, p) in enumerate(zip(kernel, plain)):
        log(f"{label} step {i}: loss {k['loss']:.5f} / plain {p['loss']:.5f}, "
            f"grad_norm {k['grad_norm']:.5f} / plain {p['grad_norm']:.5f}, "
            f"lr {k['lr']:.3e}")
    log(f"{label} path vs plain route: worst rel loss {rel['loss']:.3e} "
        f"(<= {TRAIN_RTOL['loss']}), grad_norm {rel['grad_norm']:.3e} "
        f"(<= {TRAIN_RTOL['grad_norm']})")
    for which, s in (("kernel", kernel_secs), ("plain", plain_secs)):
        mean = sum(s) / len(s)
        log(f"[{card}] {label} {which} route: {1e3 * mean:.1f} ms per step "
            f"of {vols} volumes ({recipe}), {vols / mean:.2f} vol/s (steps "
            f"{', '.join(f'{1e3 * t:.1f}' for t in s)} ms)")


def check_train_metrics(kernel, plain):
    """Finite losses and grad norms, nothing skipped, and the plain route's
    first steps within TRAIN_RTOL of the kernel route's."""
    for route, metrics in (("kernel", kernel), ("plain", plain)):
        for i, m in enumerate(metrics):
            if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
                raise AssertionError(f"{route} step {i}: {m}")
            if m["skipped"]:
                raise AssertionError(f"{route} step {i} skipped: {m}")
    worst = {}
    for i, (k, p) in enumerate(zip(kernel, plain)):
        for key, rtol in TRAIN_RTOL.items():
            rel = abs(k[key] - p[key]) / abs(p[key])
            worst[key] = max(worst.get(key, 0.0), rel)
            if rel > rtol:
                raise AssertionError(f"step {i} {key}: kernel {k[key]} vs "
                                     f"plain {p[key]} (rel {rel:.3e} > "
                                     f"{rtol})")
    return worst


def cuda_ms(fn, reps=3):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_times(calls, backward=True):
    """Per-kernel (ms, plain ms) summed over one forward's calls and (with
    ``backward``) their backward: the forward wrappers and K1b/K2b on the
    recorded arguments with one cotangent, the movers' adjoints as the
    opposite move."""
    import torch
    from vsn_tpu_torch.ops import swin_block_kernels as sbk
    from vsn_tpu_torch.ops import window_relayout as wr

    table = kernel_table()
    ms = collections.defaultdict(float)
    plain_ms = collections.defaultdict(float)
    neg = lambda roll: tuple(-r for r in roll)
    adjoints = {  # mover -> (adjoint kernel, plain adjoint) of (g, args)
        "spatial_to_windows": (
            lambda g, a: wr.windows_to_spatial(g, a[1], a[0].shape[1:4],
                                               neg(a[2])),
            lambda g, a: wr.windows_to_spatial_reference(
                g, a[1], a[0].shape[1:4], neg(a[2]))),
        "windows_to_windows": (
            lambda g, a: wr.windows_to_windows(g, a[1], a[2], neg(a[3])),
            lambda g, a: wr.windows_to_windows_reference(g, a[1], a[2],
                                                         neg(a[3]))),
        "windows_to_spatial": (
            lambda g, a: wr.spatial_to_windows(g, a[1], neg(a[3])),
            lambda g, a: wr.spatial_to_windows_reference(g, a[1],
                                                         neg(a[3]))),
    }
    with torch.no_grad():
        for name, args in calls:
            kernel, plain = table[name]
            ms[name] += cuda_ms(lambda: kernel(*args))
            plain_ms[name] += cuda_ms(lambda: plain(*args))
            if not backward:
                continue
            out = plain(*args)
            g = torch.randn(out.shape, device=out.device).to(out.dtype)
            bname = backward_name(name)
            if name == "attn_half":
                b_args = (*args[:8], args[10], g, *args[11:13])
                ms[bname] += cuda_ms(lambda: sbk.attn_half_backward(*b_args))
                plain_ms[bname] += cuda_ms(
                    lambda: sbk.attn_half_backward_reference(*b_args))
            elif name == "ln_mlp":
                b_args = (*args[:6], args[8], g)
                ms[bname] += cuda_ms(lambda: sbk.ln_mlp_backward(*b_args))
                plain_ms[bname] += cuda_ms(
                    lambda: sbk.ln_mlp_backward_reference(*b_args))
            else:
                adj, plain_adj = adjoints[name]
                ms[bname] += cuda_ms(lambda: adj(g, args))
                plain_ms[bname] += cuda_ms(lambda: plain_adj(g, args))
    return ms, plain_ms


def profile_phase(fn, label, per, n_units, card):
    """Device time by kernel and device idle share of one call of ``fn``
    (after a warm-up call outside the trace); trace in build/."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    trace = Path(__file__).resolve().parent / "build" / f"{label}_trace.json"
    trace.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not events:
        raise AssertionError("profiler recorded no device activity")
    by_name = collections.Counter()
    spans = []
    for e in events:
        by_name[e["name"][:72]] += e["dur"]
        spans.append((e["ts"], e["ts"] + e["dur"]))
    busy, end = 0.0, -1.0
    for s, e in sorted(spans):  # union of device intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    log(f"[{card}] profile {label}: device busy {busy / 1e3:.1f} ms of "
        f"{wall_us / 1e3:.1f} ms wall, idle share {1 - busy / wall_us:.3f} "
        f"(trace {trace.name}, profiler on)")
    for name, us in by_name.most_common(14):
        log(f"[{card}] profile {label}: {us / 1e3 / n_units:9.3f} ms per "
            f"{per} {100 * us / busy:5.1f}% of busy  {name}")


def stem_table():
    """name -> (K5 wrapper, plain version), with the signatures
    (x, kernel, strides, padding, dtype) and (x, g, kernel_shape, strides,
    padding, dtype)."""
    from vsn_tpu_torch.ops import stem_im2col as stem

    return {"stem_im2col": (stem.stem_conv_im2col, stem.stem_conv_reference),
            "stem_im2col_dw": (stem.stem_conv_dw, stem.stem_dw_reference)}


def stem_case(geom, batch, dtype, device, gen):
    """Seeded arguments of one stem call, (x, kernel, strides, padding, g):
    x [B, D, H, W, 1] in ``dtype``, an f32 kernel of O(1) outputs, and a
    cotangent g of the output's shape."""
    import torch
    from vsn_tpu_torch.ops.stem_im2col import output_shape

    shape, ks, strides, c_out = geom
    pad = tuple(k // 2 for k in ks)
    r = lambda *sh: torch.randn(*sh, generator=gen, device=device)
    taps = ks[0] * ks[1] * ks[2]
    x = r(batch, *shape, 1).to(dtype)
    kernel = r(*ks, 1, c_out) * taps ** -0.5
    g = r(batch, *output_shape(shape, ks, strides, pad), c_out).to(dtype)
    return x, kernel, strides, pad, g


def stem_calls(x, kernel, strides, pad, g, table):
    """{name: (kernel result, plain result)} of K5f and K5w on one case."""
    import torch

    dt = x.dtype
    out = {}
    with torch.no_grad():
        for name, args in (("stem_im2col", (x, kernel, strides, pad, dt)),
                           ("stem_im2col_dw", (x, g, tuple(kernel.shape[:3]),
                                               strides, pad, dt))):
            kernel_fn, plain = table[name]
            out[name] = (kernel_fn(*args), plain(*args))
    return out


def stem_parity_phase(cases, table):
    """Hold K5f and K5w against their plain versions on every case
    ({label: stem_case(...)}), each to TOL of the plain result's scale (f32
    with TF32 off, or bf16). Logs one line per case and kernel; raises
    naming every failure. Returns {name: worst max|d|}."""
    import torch

    worst = collections.defaultdict(float)
    failed = []
    for label, case in cases.items():
        for name, (got, want) in stem_calls(*case, table).items():
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{label} {name}: {got.dtype} "
                                     f"{tuple(got.shape)} vs {want.dtype} "
                                     f"{tuple(want.shape)}")
            dtype = str(case[0].dtype).removeprefix("torch.")
            err = (got.float() - want.float()).abs().max().item()
            limit = TOL[dtype] * want.float().abs().max().item()
            ok = bool(torch.isfinite(got).all()) and err <= limit
            log(f"parity stem {label} {name}: max|d| {err:.3e} "
                f"({err / limit:.3f} of the limit) {'ok' if ok else 'FAIL'}")
            worst[name] = max(worst[name], err)
            if not ok:
                failed.append(f"{label} {name}")
    if failed:
        raise AssertionError("stem kernels disagree with their plain "
                             "versions: " + "; ".join(failed))
    return dict(worst)


def stem_times(x, kernel, strides, pad, g, table):
    """{name: (ms, plain ms, library ms)} of K5f and K5w on one case; the
    library calls (cuDNN conv3d in bf16, channels-last, and its weight
    gradient) are yardsticks the port never calls."""
    import torch
    import torch.nn.functional as F

    dt = x.dtype
    xc = x[..., 0][:, None].contiguous(memory_format=torch.channels_last_3d)
    wc = kernel.to(dt).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    gc = g.permute(0, 4, 1, 2, 3)
    library = {
        "stem_im2col": lambda: F.conv3d(xc, wc, stride=strides,
                                        padding=pad),
        "stem_im2col_dw": lambda: torch.nn.grad.conv3d_weight(
            xc, wc.shape, gc, stride=strides, padding=pad),
    }
    out = {}
    with torch.no_grad():
        for name, args in (("stem_im2col", (x, kernel, strides, pad, dt)),
                           ("stem_im2col_dw", (x, g, tuple(kernel.shape[:3]),
                                               strides, pad, dt))):
            kernel_fn, plain = table[name]
            out[name] = (cuda_ms(lambda: kernel_fn(*args)),
                         cuda_ms(lambda: plain(*args), reps=1),
                         cuda_ms(library[name]))
    return out


def _nbytes(*tensors):
    import torch

    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def call_work(name, args):
    """(FLOP, bytes) of one call of kernel ``name`` on the forward
    arguments ``args`` (a backward kernel: on its forward call's arguments,
    with a cotangent and a data gradient the size of the output). Bytes
    count each input read once and each output written once; FLOP count
    the products the kernel computes from those inputs (the backward
    kernels recompute the forward's products they need)."""
    x = args[0]
    if name in ("attention", "attention_bwd", "copy"):
        # kernels not ported yet, at an attn_half call's shapes: K4f/V1f/V3f
        # (softmax(q k^T s + bias + mask) v from packed qkv: q k^T and p v),
        # K4b/V1b/V3b (s, dp, dv, dq, dk; dqkv and dbias out), and the copy
        # probe of perf_probe_attn_ablate2.py (x in, x out)
        bw, n, c = x.shape
        rows, bias = bw * n, args[5]
        if name == "copy":
            return 0, 2 * _nbytes(x)
        if name == "attention":
            return 4 * rows * n * c, 4 * _nbytes(x) + _nbytes(bias)
        return 10 * rows * n * c, 8 * _nbytes(x) + 2 * _nbytes(bias)
    if name in ("attn_half", "attn_half_bwd"):
        bw, n, c = x.shape
        rows = bw * n
        params = _nbytes(*args[1:9])
        if name == "attn_half":  # qkv, proj; q k^T and p v
            return 8 * rows * c * c + 4 * rows * n * c, 2 * _nbytes(x) + \
                params + _nbytes(*args[9:11])
        # recomputed qkv, dWproj, dao, dWqkv, dy; s, ao, dp, dv, dq, dk
        return 22 * rows * c * c + 12 * rows * n * c, 3 * _nbytes(x) + \
            2 * params + _nbytes(args[10])
    if name in ("ln_mlp", "ln_mlp_bwd"):
        rows, c = x.shape
        hid = args[3].shape[0]
        params = _nbytes(*args[1:7])
        if name == "ln_mlp":  # fc1, fc2
            return 4 * rows * c * hid, 2 * _nbytes(x) + params + \
                _nbytes(*args[7:9])
        # recomputed fc1, dW2, dh, dW1, dy
        return 10 * rows * c * hid, 3 * _nbytes(x) + 2 * params + \
            _nbytes(args[8])
    if name in STEM:  # args: (x, kernel, strides, padding, g)
        kernel, g = args[1], args[4]
        taps = kernel.shape[0] * kernel.shape[1] * kernel.shape[2]
        tokens = g.numel() // g.shape[-1]
        flops = 2 * taps * g.shape[-1] * tokens
        out = g if name == "stem_im2col" else kernel  # y like g, dW like W
        return flops, _nbytes(x, kernel if name == "stem_im2col" else g, out)
    return 0, 2 * _nbytes(x)  # a mover or its adjoint: read and write


def bound_ms(name, calls, dtype="bfloat16"):
    """(least ms, "bytes" or "operations") of kernel ``name`` over
    ``calls`` [(forward name, args)] on this card: the larger of the bytes
    over the HBM rate and the FLOP over the peak rate for ``dtype``."""
    base = FORWARD_OF.get(name, name)
    flops = nbytes = 0
    for cname, args in calls:
        if cname == base:
            f, b = call_work(name, args)
            flops, nbytes = flops + f, nbytes + b
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def check_counts(counts, expected, units, what):
    """Every kernel's launches in ``counts`` equal ``expected[name] *
    units`` (0 for a kernel the path must not launch)."""
    for name in KERNELS:
        want = expected.get(name, 0) * units
        if counts.get(name, 0) != want:
            raise AssertionError(f"{what} {name}: {counts.get(name, 0)} "
                                 f"launches, expected {want} "
                                 f"({expected.get(name, 0)} x {units})")


def refresh_statistics(model, cfg, images, micro):
    """Re-estimate the BatchNorm statistics of ``model``'s weights over
    ``images`` (float16, [N, D, H, W, 1], z-scored as for eval) in
    micro-batches of ``micro`` (make_bn_refresh_step) and load them into
    the model."""
    import torch
    from vsn_tpu_torch.data.augment import build_eval_transform
    from vsn_tpu_torch.train.step import make_bn_refresh_step

    device = next(model.parameters()).device
    x = torch.from_numpy(images).to(device)
    x = x.reshape(-1, micro, *x.shape[1:])
    batch = {"image": x, "label": torch.zeros(x.shape[0], micro,
                                              cfg.num_classes, device=device)}
    transform = build_eval_transform(cfg)
    variables = model.state_dict()
    stats = make_bn_refresh_step(
        model, cfg, lambda m, gen: (transform(m["image"]), m["label"]))(
        variables, batch)
    model.load_state_dict({**variables, **stats}, strict=True)
    return stats


def statistics_checks(state, initial_stats):
    """The BatchNorm statistics moved from ``initial_stats``, are finite,
    and the EMA's statistics differ from the live ones. Returns (moved,
    EMA gap) as max |d|."""
    import torch

    stats = state.model_state.flat
    ema = state.ema.ema[state.params.flat.numel():]
    if not bool(torch.isfinite(stats).all()):
        raise AssertionError("non-finite BatchNorm statistics")
    moved = (stats - initial_stats).abs().max().item()
    gap = (ema - stats).abs().max().item()
    if not moved > 0 or not gap > 0:
        raise AssertionError(f"BatchNorm statistics moved by {moved}, EMA "
                             f"statistics {gap} from the live ones")
    return moved, gap


def main() -> int:
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)")
    if torch.cuda.device_count() != 1:
        raise SystemExit("chip_smoke: runs on one card; set "
                         "CUDA_VISIBLE_DEVICES to one device")
    from vsn_tpu_torch.config import load_config
    from vsn_tpu_torch.data.augment import zscore
    from vsn_tpu_torch.eval.evaluate import Evaluator
    from vsn_tpu_torch.models import build_model
    from vsn_tpu_torch.models.swin3d import init_weights
    from vsn_tpu_torch.ops import _build
    from vsn_tpu_torch.train.step import (
        eval_params,
        init_train_state,
        make_batch_transform,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    t_start = time.perf_counter()

    # 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> "
        f"{so.relative_to(_build.BUILD_DIR.parent)}")

    # 2. card -------------------------------------------------------------
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 3. forward parity at every stage shape ------------------------------
    cfg = load_config(dict(USE_SHAKEDROP=True))  # flagship: bf16, ShakeDrop
    models = {}
    for dtype_name, fp16 in (("float32", False), ("bfloat16", True)):
        m = build_model(cfg.replace(FP16=fp16))
        models[dtype_name] = init_weights(m,
                                          torch.Generator().manual_seed(SEED))
    model = models["bfloat16"]
    evaluator = Evaluator(cfg, model, batch_size=BATCH)
    table = kernel_table()
    sets = {}
    for dtype_name, m in models.items():
        x = zscore(torch.from_numpy(volumes(2, seed=SEED + 1)).to(device))
        sets[f"{dtype_name} B=2"] = record_calls(m, x)
    x = torch.from_numpy(volumes(BATCH, seed=SEED + 2)).to(device)
    sets[f"bfloat16 B={BATCH}"] = record_calls(model, evaluator.transform(x))
    worst, kinds = parity_phase(sets, table,
                                torch.Generator().manual_seed(SEED + 3))
    for label, by_name in kinds.items():
        if not ATTN_CASES <= by_name["attn_half"]:
            raise AssertionError(f"parity set {label} lacks attn_half cases "
                                 f"{ATTN_CASES - by_name['attn_half']}")
    eval_calls = sets.pop(f"bfloat16 B={BATCH}")  # timed in phase 6
    del sets

    # 4. backward parity on training forwards -----------------------------
    train_cfg = load_config(dict(
        USE_SAM=True, USE_EMA=True, USE_MIXUP=True, MIXUP_PROB=0.5,
        USE_SHAKEDROP=True, LABEL_SMOOTHING=0.1, SEED=SEED,
        BATCH_SIZE=TRAIN_MICRO, EFFECTIVE_BATCH_SIZE=TRAIN_MICRO * TRAIN_ACCUM))
    if train_cfg.gradient_accumulation_steps() != TRAIN_ACCUM:
        raise AssertionError("the training config must accumulate "
                             f"{TRAIN_ACCUM} micro-batches")
    gsets = {}
    for dtype_name, m in models.items():
        x = zscore(torch.from_numpy(volumes(2, seed=SEED + 4)).to(device))
        gsets[f"{dtype_name} B=2"] = record_calls(
            m.train(), x, generator=torch.Generator(device).manual_seed(1))
    batch = train_batch(train_cfg, device, SEED + 5)
    micro0 = {k: v[0] for k, v in batch.items()}
    images8, _ = make_batch_transform(train_cfg)(micro0)
    gsets[f"bfloat16 B={TRAIN_MICRO}"] = record_calls(
        model.train(), images8.to(torch.bfloat16),
        generator=torch.Generator(device).manual_seed(2))
    for m in models.values():
        m.eval()
    gen = torch.Generator().manual_seed(SEED + 6)
    bworst, bkinds = grad_parity_phase(gsets, table, gen)
    worst.update(bworst)
    for label, by_name in bkinds.items():
        if not ATTN_CASES <= by_name["attn_half_bwd"]:
            raise AssertionError(f"backward set {label} lacks attn_half cases "
                                 f"{ATTN_CASES - by_name['attn_half_bwd']}")
    saturation_phase(gsets["float32 B=2"], table, gen)
    train_calls = gsets.pop(f"bfloat16 B={TRAIN_MICRO}")  # timed in phase 8
    del gsets, models, x, images8

    # 5. K5f / K5w parity and timings -------------------------------------
    stable = stem_table()
    sgen = torch.Generator(device).manual_seed(SEED + 9)
    cases = {f"{dt} {geom[0]} k{geom[1]} s{geom[2]} C{geom[3]}":
             stem_case(geom, 2, getattr(torch, dt), device, sgen)
             for dt in ("float32", "bfloat16") for geom in STEM_GEOMS}
    full = f"bfloat16 micro {RESNET_MICRO} (the ResNet stem)"
    cases[full] = stem_case(RESNET_STEM, RESNET_MICRO, torch.bfloat16,
                            device, sgen)
    worst.update(stem_parity_phase(cases, stable))
    stem_call = [("stem_im2col", cases[full])]
    stem_ms = stem_times(*cases[full], stable)
    stem_bound = {name: bound_ms(name, stem_call) for name in STEM}
    del cases, stem_call
    torch.cuda.empty_cache()

    # 6. the Swin eval path -----------------------------------------------
    images = volumes(N_VOLUMES, seed=SEED)
    n_batches = -(-N_VOLUMES // BATCH)
    _build.launches.clear()
    t0 = time.perf_counter()
    probs = evaluator.predict(images)
    sync()
    first_s = time.perf_counter() - t0
    counts = {name: _build.launches[name] for name in KERNELS}
    log(f"eval path: {N_VOLUMES} volumes in {n_batches} batches of {BATCH}, "
        f"first run {first_s:.2f} s, launches {counts}")
    check_counts(counts, PER_FORWARD, n_batches, "eval")
    check_probs(probs, N_VOLUMES, cfg.num_classes)
    with patched_model_ops(lambda name, kernel, plain: plain):
        probs_plain = evaluator.predict(images)
    compare_probs("eval path", probs, probs_plain)
    eval_rates(evaluator, images,
               lambda: patched_model_ops(lambda name, kernel, p: p),
               n_batches, "eval", card)
    ems, eplain = kernel_times(eval_calls, backward=False)
    for name in PER_FORWARD:
        log(f"[{card}] eval {name}: {ems[name]:.3f} ms per forward at batch "
            f"{BATCH} (plain {eplain[name]:.3f} ms)")
    profile_phase(lambda: evaluator.predict(images), "eval", "forward",
                  n_batches, card)
    del evaluator, model, eval_calls

    # 7. the Swin training path -------------------------------------------
    model = init_weights(build_model(train_cfg),
                         torch.Generator().manual_seed(SEED))
    state = init_train_state(train_cfg, model)
    initial = state.params.flat.clone()
    draws = Draws(model, TRAIN_MICRO, device, SEED)
    reach_every_parameter(model, train_cfg, state, batch, draws, "train")
    _build.launches.clear()
    kernel_metrics, secs = train_route(model, train_cfg, state, batch, draws,
                                       1, sync)
    after0 = state.params.flat.clone()
    more, more_secs = train_route(model, train_cfg, state, batch, draws,
                                  TIMED_STEPS, sync)
    counts = {name: _build.launches[name] for name in KERNELS}
    kernel_metrics += more
    steps = 1 + TIMED_STEPS
    passes = steps * TRAIN_ACCUM * (2 if train_cfg.USE_SAM else 1)
    log(f"train path: {steps} steps of {TRAIN_ACCUM} x {TRAIN_MICRO} volumes "
        f"(SAM: 2 passes), launches {counts}")
    check_counts(counts, PER_PASS, passes, "train")
    path_counts = dict(counts)
    params_moved(state, initial, after0, "train")
    ema_probs = Evaluator(train_cfg, model, batch_size=BATCH).predict(
        images[:BATCH], eval_params(state, use_ema=True))
    check_probs(ema_probs, BATCH, train_cfg.num_classes)
    log(f"train path: EMA weights through Evaluator, probs range "
        f"[{ema_probs.min():.4f}, {ema_probs.max():.4f}]")
    profile_phase(lambda: train_route(model, train_cfg, state, batch, draws,
                                      1, sync), "train", "step", 1, card)
    with torch.no_grad():
        state.params.flat.copy_(initial)
    del state
    pstate = init_train_state(train_cfg, model)
    with patched_model_ops(lambda name, kernel, plain: plain):
        plain_metrics, plain_secs = train_route(model, train_cfg, pstate,
                                                batch, draws, PLAIN_STEPS,
                                                sync)
    report_routes("train", kernel_metrics, plain_metrics, more_secs,
                  plain_secs, TRAIN_ACCUM * TRAIN_MICRO,
                  f"SAM + EMA + MixUp + ShakeDrop, micro {TRAIN_MICRO} x "
                  f"{TRAIN_ACCUM}", card)
    log(f"[{card}] train kernel route warm-up step {1e3 * secs[0]:.1f} ms; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del pstate, batch, model, draws

    # 8. Swin kernel timings at the training shapes -----------------------
    ms, plain_ms = kernel_times(train_calls)
    bounds = {name: bound_ms(name, train_calls) for name in KERNELS
              if name not in STEM}
    stage1 = [next(c for c in train_calls if c[0] == "attn_half")]
    for what, name, calls in (
            ("K4f / V1f / V3f, attention from packed qkv", "attention",
             train_calls),
            ("K4b / V1b / V3b, its VJP", "attention_bwd", train_calls),
            ("P1, K1f variants at one stage-1 call", "attn_half", stage1),
            ("P2-P5 copy probe at one stage-1 call", "copy", stage1)):
        t, by = bound_ms(name, calls)
        log(f"[{card}] not ported: {what}: bound {t:.3f} ms by {by} at the "
            f"attn_half calls of a micro-batch of {TRAIN_MICRO}")
    del train_calls, stage1
    torch.cuda.empty_cache()

    # 9. the ResNet eval path ---------------------------------------------
    from vsn_tpu_torch.models.resnet3d import init_weights as resnet_init

    rcfg = load_config(preset=RESNET_PRESET)
    rmodel = resnet_init(build_model(rcfg), torch.Generator().manual_seed(SEED))
    refresh_statistics(rmodel, rcfg, volumes(2 * BATCH, seed=SEED + 7), BATCH)
    revaluator = Evaluator(rcfg, rmodel, batch_size=BATCH)
    _build.launches.clear()
    rprobs = revaluator.predict(images)
    sync()
    counts = {name: _build.launches[name] for name in KERNELS}
    log(f"resnet eval path: {N_VOLUMES} volumes in {n_batches} batches of "
        f"{BATCH}, launches {counts}")
    check_counts(counts, RESNET_PER_FORWARD, n_batches, "resnet eval")
    check_probs(rprobs, N_VOLUMES, rcfg.num_classes)
    with plain_stem():
        rprobs_plain = revaluator.predict(images)
    compare_probs("resnet eval path", rprobs, rprobs_plain)
    eval_rates(revaluator, images, plain_stem, n_batches, "resnet eval",
               card)
    del revaluator, rmodel

    # 10. the ResNet training path ----------------------------------------
    rtrain_cfg = load_config(dict(
        USE_SAM=True, USE_EMA=True, USE_MIXUP=True, MIXUP_PROB=0.5,
        LABEL_SMOOTHING=0.1, SEED=SEED, BATCH_SIZE=RESNET_MICRO,
        EFFECTIVE_BATCH_SIZE=RESNET_MICRO * TRAIN_ACCUM), preset=RESNET_PRESET)
    if rtrain_cfg.gradient_accumulation_steps() != TRAIN_ACCUM:
        raise AssertionError("the ResNet training config must accumulate "
                             f"{TRAIN_ACCUM} micro-batches")
    model = resnet_init(build_model(rtrain_cfg),
                        torch.Generator().manual_seed(SEED))
    state = init_train_state(rtrain_cfg, model)
    initial = state.params.flat.clone()
    initial_stats = state.model_state.flat.clone()
    rbatch = train_batch(rtrain_cfg, device, SEED + 8)
    draws = Draws(model, RESNET_MICRO, device, SEED)
    reach_every_parameter(model, rtrain_cfg, state, rbatch, draws,
                          "resnet train")
    with torch.no_grad():  # that pass moved the statistics
        state.model_state.flat.copy_(initial_stats)
    _build.launches.clear()
    kernel_metrics, secs = train_route(model, rtrain_cfg, state, rbatch,
                                       draws, 1, sync)
    after0 = state.params.flat.clone()
    more, more_secs = train_route(model, rtrain_cfg, state, rbatch, draws,
                                  TIMED_STEPS, sync)
    counts = {name: _build.launches[name] for name in KERNELS}
    kernel_metrics += more
    log(f"resnet train path: {steps} steps of {TRAIN_ACCUM} x {RESNET_MICRO} "
        f"volumes (SAM: 2 passes), launches {counts}")
    check_counts(counts, RESNET_PER_PASS, passes, "resnet train")
    path_counts.update({name: counts[name] for name in STEM})
    params_moved(state, initial, after0, "resnet train")
    moved, gap = statistics_checks(state, initial_stats)
    log(f"resnet train path: BatchNorm statistics moved by {moved:.3e}, EMA "
        f"statistics {gap:.3e} from the live ones")
    ema_probs = Evaluator(rtrain_cfg, model, batch_size=BATCH).predict(
        images[:BATCH], eval_params(state, use_ema=True))
    check_probs(ema_probs, BATCH, rtrain_cfg.num_classes)
    log(f"resnet train path: EMA weights and statistics through Evaluator, "
        f"probs range [{ema_probs.min():.4f}, {ema_probs.max():.4f}]")
    profile_phase(lambda: train_route(model, rtrain_cfg, state, rbatch, draws,
                                      1, sync), "resnet_train", "step", 1,
                  card)
    with torch.no_grad():
        state.params.flat.copy_(initial)
        state.model_state.flat.copy_(initial_stats)
    del state
    pstate = init_train_state(rtrain_cfg, model)
    with plain_stem():
        plain_metrics, plain_secs = train_route(model, rtrain_cfg, pstate,
                                                rbatch, draws, PLAIN_STEPS,
                                                sync)
    report_routes("resnet train", kernel_metrics, plain_metrics, more_secs,
                  plain_secs, TRAIN_ACCUM * RESNET_MICRO,
                  f"SAM + EMA + MixUp + head dropout, micro {RESNET_MICRO} x "
                  f"{TRAIN_ACCUM}", card)
    log(f"[{card}] resnet train kernel route warm-up step "
        f"{1e3 * secs[0]:.1f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del pstate, rbatch, model, draws

    # 11. per-kernel times beside their bounds ----------------------------
    library_ms = dict.fromkeys(KERNELS)
    for name in STEM:
        ms[name], plain_ms[name], library_ms[name] = stem_ms[name]
        bounds[name] = stem_bound[name]
    for name in KERNELS:
        per = (f"micro-batch of {RESNET_MICRO}" if name in STEM
               else f"micro-batch of {TRAIN_MICRO}")
        lib = ("no single call" if library_ms[name] is None
               else f"{library_ms[name]:.3f} ms")
        log(f"[{card}] {name}: {ms[name]:.3f} ms per {per} (plain "
            f"{plain_ms[name]:.3f} ms, library {lib}, bound "
            f"{bounds[name][0]:.3f} ms by {bounds[name][1]})")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    result = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": path_counts[name], "max_abs_err": worst[name],
         "ms": ms[name], "plain_ms": plain_ms[name],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library_ms[name]}
        for name, (src, rep) in KERNELS.items()]}
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
