"""The attention-ablation probes, run on the card:

    python -m vsn_tpu_torch.probes.attn_ablate    # P1: six ablations of K1
    python -m vsn_tpu_torch.probes.attn_ablate2   # P2-P5: copies, wb = 8 / 1

Counterparts of ``scripts/perf_probe_attn_ablate.py`` and
``scripts/perf_probe_attn_ablate2.py``: the scripts' inputs at one stage-1
K1 call (micro-batch 8, window (6, 7, 6), C = 96, 3 heads: x [8, 36, 42,
36, 96] partitioned to [1728, 252, 96] bf16; wqkv, bias, wproj from
``np.random.default_rng(0)``), the scripts' runs in their order and with
their names, one ``name  ms`` line each, timed with CUDA events after a
warm-up. The kernels are ``ops/attn_probe.py``'s.
"""

from __future__ import annotations

import subprocess
import time
from dataclasses import dataclass

import numpy as np
import torch

from vsn_tpu_torch.models.swin3d import window_partition
from vsn_tpu_torch.ops import attn_probe as ap

MICRO = 8
GRID = (36, 42, 36)
WINDOW = (6, 7, 6)
C, HEADS = 96, 3
N = WINDOW[0] * WINDOW[1] * WINDOW[2]
REPS, WARMUP = 6, 2  # the scripts' timeit


@dataclass(frozen=True)
class Run:
    """One run of a probe script: its name there, the probe (P1-P5), the
    wrapper (``kind``: attn_ablate, attn_slot or copy_windows), its variant
    ("copy" or "ops" for a copy), windows per block and whether x is f32."""

    name: str
    probe: str
    kind: str
    variant: str
    wb: int = 1
    f32: bool = False

    @property
    def key(self) -> str:
        """The run's launch counter (``_build.launches``)."""
        return ap.launch_key(self.kind, self.variant, self.wb, self.f32)

    @property
    def launches(self) -> int:
        """CUDA launches per call."""
        return ap.launches_per_call(self.kind, self.variant)

    def x(self, xw):
        """The run's x made from the bf16 windows (f32 for ``f32``)."""
        return xw.float() if self.f32 else xw

    def kernel(self, x, wqkv, bias, wproj):
        if self.kind == "copy_windows":
            ops = (wqkv, bias, wproj) if self.variant == "ops" else None
            return ap.copy_windows(x, self.wb, ops)
        if self.kind == "attn_slot":
            return ap.attn_slot(self.wb, self.variant, x, wqkv, bias, wproj)
        return ap.attn_ablate(self.variant, x, wqkv, bias, wproj)

    def plain(self, x, wqkv, bias, wproj, qkv=None):
        """The plain version; ``qkv``, for P1 / P5, stands for launch 1's
        output (``attn_probe._probe_math``)."""
        if self.kind == "copy_windows":
            ops = (wqkv, bias, wproj) if self.variant == "ops" else None
            return ap.copy_reference(x, self.wb, ops)
        if self.kind == "attn_slot":
            return ap.attn_slot_reference(self.wb, self.variant, x, wqkv,
                                          bias, wproj, qkv)
        return ap.attn_ablate_reference(self.variant, x, wqkv, bias, wproj,
                                        qkv)


def script_inputs(device, micro=MICRO, seed=0):
    """(xw [micro * 216, 252, 96] bf16, wqkv, bias, wproj) on ``device``, drawn
    as the scripts' ``main`` draws them."""
    rng = np.random.default_rng(seed)
    x5 = rng.standard_normal((micro, *GRID, C)).astype(np.float32)
    xw = window_partition(torch.from_numpy(x5).to(device, torch.bfloat16),
                          WINDOW).contiguous()
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    wqkv = f32(rng.standard_normal((C, 3 * C)) * 0.05)
    bias = f32(rng.standard_normal((HEADS, N, N)) * 0.1)
    wproj = f32(rng.standard_normal((C, C)) * 0.05)
    return xw, wqkv, bias, wproj


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or the
    note that the times are the host's."""
    if device.type != "cuda":
        return "cpu: host-clock times, not a device measurement"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_run(fn, device, reps=REPS, warmup=WARMUP) -> float:
    """ms per call of ``fn``: CUDA events over ``reps`` calls after
    ``warmup`` on a card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def run_probes(runs, device="cuda", micro=MICRO, reps=REPS, warmup=WARMUP,
               width=16):
    """Time every run of ``runs`` on the scripts' inputs and print one line
    each after the card's; returns {run name: ms}."""
    device = torch.device(device)
    print(card_line(device), flush=True)
    xw, wqkv, bias, wproj = script_inputs(device, micro)
    times = {}
    for run in runs:
        x = run.x(xw)
        times[run.name] = time_run(lambda: run.kernel(x, wqkv, bias, wproj),
                                   device, reps, warmup)
        print(f"{run.name:{width}s} {times[run.name]:9.3f} ms", flush=True)
        del x
    return times
