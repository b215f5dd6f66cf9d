"""P1: six ablations of the stage-1 attention half-block, one window per
block (port of ``scripts/perf_probe_attn_ablate.py``).

  full2d       the whole body: LN, qkv, attention, proj, residual
  noln         LN replaced by identity
  nosm         softmax replaced by 0.001 s (keeps both products)
  nobias       bias add skipped
  linear_only  qkv and proj products only (no attention launch)
  attn_only    per-head attention only (no LN affine, qkv or proj; q = k =
               v = LN(x))

Usage: python -m vsn_tpu_torch.probes.attn_ablate
"""

from __future__ import annotations

from vsn_tpu_torch.ops.attn_probe import ABLATIONS
from vsn_tpu_torch.probes import MICRO, REPS, WARMUP, Run, run_probes

RUNS = tuple(Run(v, "P1", "attn_ablate", v) for v in ABLATIONS)


def main(device="cuda", micro=MICRO, reps=REPS, warmup=WARMUP):
    """Time every P1 run on ``device``; returns {run name: ms}."""
    return run_probes(RUNS, device, micro, reps, warmup, width=14)


if __name__ == "__main__":
    main()
