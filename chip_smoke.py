"""Drive the port's Swin-3D training step and inference path on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device, nvcc (on PATH or under CUDA_HOME) and the checkout;
it imports torch and the port (``vsn_tpu_torch``), never JAX. It runs on
one card (CUDA_VISIBLE_DEVICES defaults to 0). Phases:

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
5. the eval path: Swin-T 5c with the flagship recipe's ShakeDrop eval
   gains, ``Evaluator`` over 8 seeded float16 144x168x144 volumes in
   batches of 4, launch counters 0 before and exactly 12 (K1) / 12 (K2) /
   7 (K3) per forward after; probs finite, rows summing to 1, within 1e-2
   of the plain path; eval ms per batch and vol/s of both paths;
6. the training path (the slice's main path): ``init_train_state`` ->
   ``make_train_step`` for Swin-T 5c in bf16 with the flagship recipe (SAM,
   EMA of 3, MixUp p = 0.5, ShakeDrop, label smoothing 0.1), micro-batch 8,
   two micro-batches per step, on 16 seeded float16 volumes and their MixUp
   partners laid out as bench.py lays them out. After one backward every
   parameter has a finite, non-zero gradient. Then one warm-up step and 3
   timed steps on the kernel route with every launch counter at 0 before
   and exact after (per micro-batch and SAM pass: 12 K1f, 12 K1b, 12 K2f,
   12 K2b, 7 movers and 7 adjoints); losses and grad norms finite, nothing
   skipped, parameters finite and moved by the second step (lr is 0 at step
   0 under LR_WARMUP 50), EMA weights apart from the live ones; the EMA
   weights through ``Evaluator``; then the same initial state, batches and
   injected draws for 2 steps on the plain route: per-step loss within 2e-2
   and grad norm within 5e-2 (relative) of the kernel route;
7. timings on the card: each kernel's time per micro-batch at the training
   shapes beside its plain version's (the eval phase times the forwards at
   batch 4);
8. torch.profiler over one eval pass and one kernel-route train step:
   device time by kernel and the device's idle share (traces in build/).

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
}
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
    """The residual-gain draws of each (step, micro-batch, pass), drawn once
    from a generator seeded by ``draw_seed`` and handed to every route."""

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
            gains = self.model.residual_gains(self.micro, self.device, gen)
            self.table[key] = [
                pair for blk, g in zip(self.model.blocks(), gains)
                if blk.drop_path_rate > 0.0 for pair in (g[:2], g[2:])]
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
        init_weights(m, torch.Generator().manual_seed(SEED))
        models[dtype_name] = m.to(device)
    model = models["bfloat16"]
    evaluator = Evaluator(cfg, model, batch_size=BATCH, device=device)
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
    eval_calls = sets.pop(f"bfloat16 B={BATCH}")  # timed in phase 5
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
    train_calls = gsets.pop(f"bfloat16 B={TRAIN_MICRO}")  # timed in phase 7
    del gsets, models, x, images8

    # 5. the eval path ----------------------------------------------------
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
    for name in KERNELS:
        if counts[name] != PER_FORWARD.get(name, 0) * n_batches:
            raise AssertionError(f"eval {name}: {counts[name]} launches, "
                                 f"expected {PER_FORWARD.get(name, 0)} per "
                                 f"forward x {n_batches}")
    if probs.shape != (N_VOLUMES, cfg.num_classes):
        raise AssertionError(f"probs shape {probs.shape}")
    if not np.isfinite(probs).all():
        raise AssertionError("non-finite probs")
    row_err = np.abs(probs.sum(1) - 1).max()
    if row_err > 1e-3:
        raise AssertionError(f"prob rows sum off by {row_err}")
    with patched_model_ops(lambda name, kernel, plain: plain):
        probs_plain = evaluator.predict(images)
    d = np.abs(probs - probs_plain).max()
    agree = int((probs.argmax(1) == probs_plain.argmax(1)).sum())
    log(f"eval path vs plain path: max|d probs| {d:.3e} (<= 1e-2), argmax "
        f"agrees on {agree}/{N_VOLUMES}, probs range "
        f"[{probs.min():.4f}, {probs.max():.4f}]")
    if d > 1e-2:
        raise AssertionError(f"kernel path probs differ from plain by {d}")

    def timed(fn):
        sync()
        t = time.perf_counter()
        fn()
        sync()
        return time.perf_counter() - t

    runs = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        if which == "plain":
            with patched_model_ops(lambda name, kernel, p: p):
                runs[which].append(timed(lambda: evaluator.predict(images)))
        else:
            runs[which].append(timed(lambda: evaluator.predict(images)))
    for which, secs in runs.items():
        s = sum(secs) / len(secs)
        log(f"[{card}] eval {which} path: {1e3 * s / n_batches:.1f} ms per "
            f"batch of {BATCH} (transfer + z-score + forward + softmax), "
            f"{N_VOLUMES / s:.2f} vol/s")
    ems, eplain = kernel_times(eval_calls, backward=False)
    for name in PER_FORWARD:
        log(f"[{card}] eval {name}: {ems[name]:.3f} ms per forward at batch "
            f"{BATCH} (plain {eplain[name]:.3f} ms)")
    profile_phase(lambda: evaluator.predict(images), "eval", "forward",
                  n_batches, card)
    del evaluator, model, eval_calls

    # 6. the training path ------------------------------------------------
    model = build_model(train_cfg)
    init_weights(model, torch.Generator().manual_seed(SEED))
    model.to(device)
    state = init_train_state(train_cfg, model)
    initial = state.params.flat.clone()
    draws = Draws(model, TRAIN_MICRO, device, SEED)
    missing = first_backward_grads(model, train_cfg, state, batch, draws)
    n_params = len(state.params.names)
    log(f"train path: first backward reached {n_params - len(missing)} of "
        f"{n_params} parameters (non-zero, finite)")
    if missing:
        raise AssertionError(f"no gradient reached {missing}")
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
    for name, per in PER_PASS.items():
        if counts[name] != per * passes:
            raise AssertionError(f"train {name}: {counts[name]} launches, "
                                 f"expected {per} per micro-batch and pass "
                                 f"x {passes}")
    flat = state.params.flat
    if not bool(torch.isfinite(flat).all()):
        raise AssertionError("non-finite parameters after training")
    if not torch.equal(after0, initial):
        raise AssertionError("step 0 (lr 0 under LR_WARMUP) moved the "
                             "parameters")
    moved = (flat - after0).abs().max().item()
    ema_gap = (state.ema.ema - flat).abs().max().item()
    log(f"train path: parameters moved by {moved:.3e} after step 1, EMA "
        f"{ema_gap:.3e} from the live weights, skipped {int(state.skipped)}")
    if not moved > 0 or not ema_gap > 0:
        raise AssertionError("parameters did not move or EMA equals them")
    ema_model = build_model(train_cfg).to(device)
    ema_model.load_state_dict(eval_params(state, use_ema=True), strict=True)
    ema_probs = Evaluator(train_cfg, ema_model, batch_size=BATCH,
                          device=device).predict(images[:BATCH])
    if not np.isfinite(ema_probs).all():
        raise AssertionError("non-finite probs from the EMA weights")
    log(f"train path: EMA weights through Evaluator, probs range "
        f"[{ema_probs.min():.4f}, {ema_probs.max():.4f}]")
    del ema_model
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
    rel = check_train_metrics(kernel_metrics, plain_metrics)
    for i, (k, p) in enumerate(zip(kernel_metrics, plain_metrics)):
        log(f"train step {i}: loss {k['loss']:.5f} / plain {p['loss']:.5f}, "
            f"grad_norm {k['grad_norm']:.5f} / plain {p['grad_norm']:.5f}, "
            f"lr {k['lr']:.3e}")
    log(f"train path vs plain route: worst rel loss {rel['loss']:.3e} "
        f"(<= {TRAIN_RTOL['loss']}), grad_norm {rel['grad_norm']:.3e} "
        f"(<= {TRAIN_RTOL['grad_norm']})")
    vols = TRAIN_ACCUM * TRAIN_MICRO
    for which, s in (("kernel", more_secs), ("plain", plain_secs)):
        mean = sum(s) / len(s)
        log(f"[{card}] train {which} route: {1e3 * mean:.1f} ms per step of "
            f"{vols} volumes (SAM + EMA + MixUp + ShakeDrop, micro "
            f"{TRAIN_MICRO} x {TRAIN_ACCUM}), {vols / mean:.2f} vol/s "
            f"(steps {', '.join(f'{1e3 * t:.1f}' for t in s)} ms)")
    log(f"[{card}] train kernel route warm-up step {1e3 * secs[0]:.1f} ms; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del pstate, batch

    # 7. kernel timings at the training shapes ----------------------------
    ms, plain_ms = kernel_times(train_calls)
    for name in KERNELS:
        log(f"[{card}] {name}: {ms[name]:.3f} ms per micro-batch of "
            f"{TRAIN_MICRO} (plain {plain_ms[name]:.3f} ms)")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    result = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": worst[name],
         "ms": ms[name], "plain_ms": plain_ms[name]}
        for name, (src, rep) in KERNELS.items()]}
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
