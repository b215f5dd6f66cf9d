"""Host-side RNG plumbing (port of vsn_tpu/utils/rng.py's numpy part).

The JAX package derives a key hierarchy (base, component, rank / epoch /
step) from the run's seed; the input pipeline's host decisions (sampler
orders, MixUp / CutMix plans) come from numpy Generators keyed by (seed,
component, epoch), which the port carries as they are, so a seeded run
draws the same epochs and plans in both packages. The JAX keys have no
analogue here: the port's device draws come from torch Generators seeded
per (step, micro-batch, pass) (``train/step.py`` ``draw_seed``).
"""

from __future__ import annotations

import numpy as np

# Component offsets, mirroring the reference's "+1 val / +2 mixup" scheme.
COMPONENT_OFFSETS = {
    "init": 0,
    "train": 1,
    "val": 2,
    "mixup": 3,
    "cutmix": 4,
    "augment": 5,
    "sampler": 6,
    "dropout": 7,
    "tta": 8,
    "bootstrap": 9,
    "shakedrop": 10,
}


def epoch_rng(seed: int | None, component: str,
              epoch: int) -> np.random.Generator:
    """numpy Generator keyed by (seed, component, epoch); unseeded (fresh
    entropy) when ``seed`` is None."""
    if seed is None:
        return np.random.default_rng()
    ss = np.random.SeedSequence(
        entropy=seed, spawn_key=(COMPONENT_OFFSETS[component], epoch))
    return np.random.default_rng(ss)


def component_seed(seed: int, component: str) -> int:
    """A 63-bit seed for a torch Generator of one component of the run
    (the port's counterpart of ``component_key``)."""
    ss = np.random.SeedSequence(entropy=seed,
                                spawn_key=(COMPONENT_OFFSETS[component],))
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))
