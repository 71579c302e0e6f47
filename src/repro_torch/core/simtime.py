"""Simulated time and seeded randomness, the port's copy of
``repro/core/simtime.py``: the determinism under the training chaos
harness (``train/chaos.py``) and, in the reference, its serving fleet's.

Every resilience number this repo reports (detection latency, recovery
overhead, goodput, tail latency) is a pure function of a seeded schedule
replayed against a ``SimClock``: ``sleep`` *advances* instead of blocking,
so backoff and timeout policies cost modeled seconds, bit-reproducibly.
``seeded_rng`` is the one way schedules draw randomness — a
``SeedSequence`` over integer components, so "same seed -> same schedule"
holds across platforms and numpy versions.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SimClock:
    """Simulated time: ``sleep`` advances instead of blocking, so backoff
    and detection timeouts cost *modeled* seconds, deterministically."""
    t: float = 0.0

    def time(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += float(s)

    def advance(self, s: float) -> None:
        self.t += float(s)

    def advance_to(self, t: float) -> None:
        """Jump forward to absolute time ``t`` (no-op if already past it) —
        the event-loop form of ``advance`` used by the fleet router's
        discrete-event simulation."""
        self.t = max(self.t, float(t))


def seeded_rng(*components: int) -> np.random.Generator:
    """A ``default_rng`` over ``SeedSequence(components)`` — the shared
    schedule-RNG helper: every chaos schedule derives from one of these so
    generation is reproducible bit for bit."""
    return np.random.default_rng(
        np.random.SeedSequence([int(c) for c in components]))
