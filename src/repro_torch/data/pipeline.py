"""Data pipelines, the port's copy of ``repro/data/pipeline.py``: the
synthetic LM token stream, a memory-mapped token file and synthetic images.
numpy only: a batch is a pure function of ``(seed, step)``, so the port and
the reference see the same tokens and images, bit for bit, and a restart
at step S resumes the same stream."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLMData:
    """Zipf-distributed token stream with next-token structure (a model can
    learn it): ``{"tokens", "labels"}`` int32 (local_batch, seq_len),
    labels the tokens shifted by one."""
    vocab: int
    seq_len: int
    global_batch: int
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
        # Markov-ish stream: token_{i+1} = f(token_i) with noise
        base = rng.zipf(1.5, size=(local, self.seq_len + 1)) % self.vocab
        drift = (np.arange(self.seq_len + 1)[None, :] * 7) % self.vocab
        toks = ((base + drift) % self.vocab).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


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


@dataclasses.dataclass
class TokenFileData:
    """Memory-mapped flat token file (uint16/uint32), a deterministic chunk
    shuffle per epoch; the same (seed, step) -> batch contract."""
    path: str
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0
    dtype: str = "uint16"

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        self._n_chunks = (len(self._data) - 1) // self.seq_len

    def batch_at(self, step: int) -> dict:
        local = self.global_batch // self.n_shards
        per_epoch = max(self._n_chunks // self.global_batch, 1)
        epoch, pos = divmod(step, per_epoch)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch]))
        perm = rng.permutation(self._n_chunks)
        start = pos * self.global_batch + self.shard * local
        idx = perm[start:start + local] % self._n_chunks
        rows = np.stack([
            self._data[i * self.seq_len:i * self.seq_len + self.seq_len + 1]
            for i in idx]).astype(np.int32) % self.vocab
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def make_pipeline(cfg, *, seq_len: int, global_batch: int, seed: int = 0,
                  n_shards: int = 1, shard: int = 0, path: str | None = None):
    """The LM pipeline of ``cfg``: ``TokenFileData`` over ``path`` when
    given, else ``SyntheticLMData``."""
    if path:
        return TokenFileData(path, cfg.vocab, seq_len, global_batch,
                             seed=seed, n_shards=n_shards, shard=shard)
    return SyntheticLMData(cfg.vocab, seq_len, global_batch, seed=seed,
                           n_shards=n_shards, shard=shard)
