"""P2-P5: what moving the stage-1 activations costs against the compute,
and windows per block (port of ``scripts/perf_probe_attn_ablate2.py``).

  copy_only      out = x, one window per block (P2)
  copy_ops       out = x, wqkv, bias and wproj passed and not read (P3)
  copy_only_wb8  out = x, 8 windows per block (P4)
  lin2d_wb8      LN + qkv + proj at 8 windows per block (P5)
  full2d_wb8     the whole body at 8 windows per block (P5)
  full2d_wb8_f32 the same with f32 x and out, bf16 operands (P5)
  full2d_wb1     the whole body at 1 window per block (P5)

Usage: python -m vsn_tpu_torch.probes.attn_ablate2
"""

from __future__ import annotations

from vsn_tpu_torch.probes import MICRO, REPS, WARMUP, Run, run_probes

RUNS = (
    Run("copy_only", "P2", "copy_windows", "copy", 1),
    Run("copy_ops", "P3", "copy_windows", "ops", 1),
    Run("copy_only_wb8", "P4", "copy_windows", "copy", 8),
    Run("lin2d_wb8", "P5", "attn_slot", "lin", 8),
    Run("full2d_wb8", "P5", "attn_slot", "full", 8),
    Run("full2d_wb8_f32", "P5", "attn_slot", "full", 8, f32=True),
    Run("full2d_wb1", "P5", "attn_slot", "full", 1),
)


def main(device="cuda", micro=MICRO, reps=REPS, warmup=WARMUP):
    """Time every P2-P5 run on ``device``; returns {run name: ms}."""
    return run_probes(RUNS, device, micro, reps, warmup)


if __name__ == "__main__":
    main()
