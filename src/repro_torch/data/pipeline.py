"""Synthetic data, the port's copy of the CNN half of
``repro/data/pipeline.py``.  numpy only: a batch is a pure function of
``(seed, step)``, so the port and the reference see the same images."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticImageData:
    """NHWC image batches in the GxM contract ({"image", "label"}), from a
    pure ``(seed, step)`` -> batch function."""
    hw: int
    n_classes: int
    global_batch: int
    channels: int = 3
    seed: int = 0
    n_shards: int = 1
    shard: int = 0

    def batch_at(self, step: int) -> dict:
        if self.global_batch % self.n_shards:
            raise ValueError(f"batch {self.global_batch} does not split into "
                             f"{self.n_shards} shards")
        local = self.global_batch // self.n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        labels = rng.integers(self.n_classes,
                              size=(local,)).astype(np.int32)
        x = rng.standard_normal(
            (local, self.hw, self.hw, self.channels)).astype(np.float32)
        # class-dependent mean shift: a learnable signal
        x += (labels[:, None, None, None].astype(np.float32)
              / self.n_classes - 0.5)
        return {"image": x, "label": labels}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
