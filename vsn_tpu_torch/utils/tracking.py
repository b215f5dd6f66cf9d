"""Run tracking: a local JSONL logger (port of vsn_tpu/utils/tracking.py).

The run directory is the source of truth: ``metrics.jsonl`` (one row per
validation, then the summary), ``summary.json``, ``config.yaml`` and the
checkpoints. The JAX tracker mirrors to W&B when the package is
installed; the card's machine has none, so the port writes the files only.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class Tracker:
    """Minimal run tracker: log(dict), summary, files in ``run_dir``."""

    def __init__(self, run_dir, run_id: str, filename: str = "events.jsonl"):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.run_id = run_id
        self._f = open(self.run_dir / filename, "a")
        self.summary: dict = {}

    def log(self, metrics: dict, step: int | None = None):
        row = {"_time": time.time(), **metrics}
        if step is not None:
            row["step"] = step
        self._f.write(json.dumps(row, default=float) + "\n")
        self._f.flush()

    def set_summary(self, **kwargs):
        self.summary.update(kwargs)
        with open(self.run_dir / "summary.json", "w") as f:
            json.dump(self.summary, f, indent=2, default=float)

    def finish(self):
        if self.summary:
            # the summary also rides in the metric stream, so one JSONL read
            # gives the whole run (step_time percentiles included)
            self._f.write(json.dumps({"kind": "summary", **self.summary},
                                     default=float) + "\n")
        self._f.close()
