"""Training CLI (port of vsn_tpu/train/cli.py; the same flags as the
reference entry point, train/train_transformer.py:96-160, plus
``--device``):

    python -m vsn_tpu_torch.train.cli \
        --training-csv-dir /data/folds --save-dir /runs \
        --intermediate-dir /cache --config configs/swin-5c.yaml \
        --fold 0 --seed 42 [--checkpoint /runs/model_xxx_0_last.ckpt]

Trains one fold on the CUDA card (``--device cpu`` on the CPU), writes
``summary_{run}_{fold}.json`` into the save directory and prints the same
summary as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.train.trainer import new_run_id, train_fold


def get_args(argv=None):
    p = argparse.ArgumentParser(description="vsn_tpu_torch trainer")
    p.add_argument("--training-csv-dir", required=True,
                   help="directory with fold_0.csv .. fold_{K-1}.csv")
    p.add_argument("--save-dir", required=True,
                   help="checkpoint/run directory")
    p.add_argument("--intermediate-dir", required=True,
                   help="preprocessing cache directory")
    p.add_argument("--config", default=None, help="override YAML")
    p.add_argument("--fold", type=int, default=None)
    p.add_argument("--seed", default="__unset__",
                   help="int, or none/false to disable")
    p.add_argument("--runname", default=None, help="run id (default: random)")
    p.add_argument("--checkpoint", default=None, help="resume checkpoint")
    p.add_argument("--max-steps", type=int, default=None,
                   help="cap steps (smoke tests)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of a few steps here")
    p.add_argument("--profile-steps", type=int, default=5,
                   help="trace window length when --profile-dir is set")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = get_args(argv)
    cfg = load_config(args.config, fold=args.fold, seed=args.seed)
    summary = train_fold(
        cfg,
        csv_dir=args.training_csv_dir,
        save_dir=args.save_dir,
        cache_dir=args.intermediate_dir,
        run_id=args.runname or new_run_id(),
        resume_from=args.checkpoint,
        max_steps=args.max_steps,
        profile_dir=args.profile_dir,
        profile_steps=args.profile_steps,
        device=args.device,
    )
    brief = {k: v for k, v in summary.items() if k != "history"}
    out = Path(args.save_dir) / f"summary_{summary['run_id']}_" \
                                f"{summary['fold']}.json"
    with open(out, "w") as f:
        json.dump(brief, f, indent=2)
    print(json.dumps(brief))
    return summary


if __name__ == "__main__":
    main()
