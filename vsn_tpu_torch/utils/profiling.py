"""Step timing and trace capture of the trainer (port of
vsn_tpu/utils/profiling.py).

``StepTrace`` captures a ``torch.profiler`` trace (host and, on the card,
CUDA activity) of the steps [start, start + n_steps) into a directory
(``train_fold(profile_dir=...)``, CLI ``--profile-dir``), as a Chrome
trace ``trace.json``.

``StepTimer`` times every step. The JAX timer measures host dispatch time
per step (its steps run asynchronously and the percentiles converge to the
device's step time once the queue is full); on the card the port measures
the device's time between two CUDA events recorded on the current stream
around each step, read back only when ``read()`` is called (at
validation, where the host waits for the card anyway), so timing adds no
synchronization to a step. On the CPU a step runs eagerly, and its wall
time is its time.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np


class StepTrace:
    """A ``torch.profiler`` trace of steps [start, start + n_steps). Call
    ``before_step(i)`` / ``after_step(i)`` around each step with the
    0-based loop index. No-op when ``profile_dir`` is None."""

    def __init__(self, profile_dir, start: int = 2, n_steps: int = 5):
        self.dir = Path(profile_dir) if profile_dir else None
        self.start = int(start)
        self.stop_at = int(start) + int(n_steps)
        self._prof = None

    def before_step(self, i: int):
        if self.dir and self._prof is None and i == self.start:
            import torch
            from torch.profiler import ProfilerActivity, profile

            self.dir.mkdir(parents=True, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()

    def after_step(self, i: int):
        if self._prof is not None and i + 1 >= self.stop_at:
            self.close()

    def close(self):
        if self._prof is not None:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            self._prof.export_chrome_trace(str(self.dir / "trace.json"))
            self._prof = None


class StepTimer:
    """Per-step times with summary percentiles (see the module docstring
    for what is timed on the card and on the CPU)."""

    def __init__(self, device=None):
        import torch

        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.durations: list[float] = []
        self._pending: list = []
        self._t0 = None

    def start(self):
        if self.cuda:
            import torch

            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is None:
            return
        if self.cuda:
            import torch

            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._pending.append((self._t0, end))
        else:
            self.durations.append(time.perf_counter() - self._t0)
        self._t0 = None

    def read(self):
        """Move the finished steps' event times into ``durations`` (waits
        for the last recorded step)."""
        for start, end in self._pending:
            end.synchronize()
            self.durations.append(start.elapsed_time(end) / 1e3)
        self._pending = []

    def summary(self, skip_warmup: int = 1) -> dict:
        self.read()
        d = np.asarray(self.durations[skip_warmup:] or self.durations)
        if len(d) == 0:
            return {}
        return {
            "steps": len(d),
            "mean_s": float(d.mean()),
            "p50_s": float(np.percentile(d, 50)),
            "p90_s": float(np.percentile(d, 90)),
            "max_s": float(d.max()),
            "steps_per_sec": float(1.0 / d.mean()),
        }
