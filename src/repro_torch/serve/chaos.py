"""Seeded fault injection for the serving fleet, the port's copy of
``repro/serve/chaos.py``: the serving-side sibling of ``train/chaos.py``.

The training harness injects faults per *step*; a serving fleet lives in
continuous time, so every event here fires at a simulated-time instant
``t`` and the ``ServeChaosEngine`` is queried by the ``FleetRouter``'s
discrete-event loop:

  ReplicaDeath   the replica stops answering health pings and never
                 completes in-flight work — detection is the router's
                 health sweep, recovery is eviction + respawn with warm
                 caches re-seeded from the survivors
  SlowReplica    service times multiply by ``factor`` until ``until`` —
                 the straggler hedged requests route around
  FlakyInfer     the replica's next ``times`` dispatches fail after
                 ``cost_s`` of burned service time (transient OOM / flaky
                 accelerator) — the bounded-backoff retry path
  RequestBurst   ``n`` extra arrivals land at once at ``t`` — the
                 admission-control / load-shed / degrade-to-int8 path

``ServeChaosSchedule.generate(seed, ...)`` draws a reproducible schedule
from ``core.simtime.seeded_rng``; the ``REPRO_SERVE_CHAOS`` knob feeds it
from ``launch/serve_cnn.py``.  Replica 0 is never killed (something must
survive to re-seed caches from), and at most ``n_replicas - 1`` deaths are
drawn so the fleet never empties.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.simtime import seeded_rng


# -- fault vocabulary ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReplicaDeath:
    t: float
    replica: str


@dataclasses.dataclass(frozen=True)
class SlowReplica:
    t: float
    replica: str
    factor: float = 3.0
    until: float | None = None      # recovers at `until` (None = forever)


@dataclasses.dataclass(frozen=True)
class FlakyInfer:
    t: float
    replica: str
    times: int = 1
    cost_s: float = 0.25            # service time burned before the failure


@dataclasses.dataclass(frozen=True)
class RequestBurst:
    t: float
    n: int


_KINDS = ("death", "slow", "flaky", "burst")


@dataclasses.dataclass(frozen=True)
class ServeChaosSchedule:
    events: tuple
    seed: int | None = None

    @staticmethod
    def generate(seed: int, *, horizon_s: float, replicas,
                 kinds=_KINDS, intensity: float = 1.0
                 ) -> "ServeChaosSchedule":
        """~1 event per 20 simulated seconds at unit intensity, bit
        reproducible for a given seed.  Replica 0 is immortal and the
        fleet never empties."""
        replicas = list(replicas)
        rng = seeded_rng(0x5E4E, seed)
        n = max(1, round(horizon_s / 20.0 * intensity))
        mortal = replicas[1:]
        events = []
        for _ in range(n):
            kind = kinds[int(rng.integers(len(kinds)))]
            t = round(float(rng.uniform(0.0, horizon_s)), 3)
            if kind == "death" and mortal:
                events.append(ReplicaDeath(t, mortal.pop(
                    int(rng.integers(len(mortal))))))
            elif kind == "slow" and len(replicas) > 1:
                events.append(SlowReplica(
                    t, replicas[int(rng.integers(1, len(replicas)))],
                    factor=float(2.0 + 2.0 * rng.random()),
                    until=t + float(rng.uniform(5.0, 20.0))))
            elif kind == "flaky":
                events.append(FlakyInfer(
                    t, replicas[int(rng.integers(len(replicas)))],
                    times=int(rng.integers(1, 3))))
            else:
                events.append(RequestBurst(t, n=int(rng.integers(4, 17))))
        return ServeChaosSchedule(
            tuple(sorted(events, key=lambda e: (e.t, repr(e)))), seed=seed)


class ServeChaosEngine:
    """Answers the router's fault queries from a ``ServeChaosSchedule``.

    Stateless in simulated time except for the flaky-infer tokens (each
    ``FlakyInfer`` arms ``times`` one-shot failures once the clock passes
    its ``t``), so a replayed schedule produces identical answers.
    """

    def __init__(self, schedule: ServeChaosSchedule):
        self.schedule = schedule
        self.injected: list[dict] = []
        self._armed_flaky: set[int] = set()
        self._flaky_tokens: dict[str, int] = {}

    # -- router-facing queries ------------------------------------------------

    def is_dead(self, replica: str, t: float, *, born: float = 0.0) -> bool:
        """A death event kills one *incarnation*: a replica respawned at
        ``born`` after the death is a fresh process and starts healthy."""
        return any(isinstance(ev, ReplicaDeath) and ev.replica == replica
                   and born <= ev.t <= t for ev in self.schedule.events)

    def death_times(self) -> dict[str, float]:
        return {ev.replica: ev.t for ev in self.schedule.events
                if isinstance(ev, ReplicaDeath)}

    def slow_factor(self, replica: str, t: float) -> float:
        f = 1.0
        for ev in self.schedule.events:
            if isinstance(ev, SlowReplica) and ev.replica == replica \
                    and ev.t <= t and (ev.until is None or t < ev.until):
                f = max(f, ev.factor)
        return f

    def take_infer_fault(self, replica: str, t: float) -> FlakyInfer | None:
        """Consume one armed flaky-infer token for ``replica`` (None when
        the replica is currently reliable)."""
        for i, ev in enumerate(self.schedule.events):
            if isinstance(ev, FlakyInfer) and ev.t <= t \
                    and i not in self._armed_flaky:
                self._armed_flaky.add(i)
                self._flaky_tokens[ev.replica] = \
                    self._flaky_tokens.get(ev.replica, 0) + ev.times
        if self._flaky_tokens.get(replica, 0) > 0:
            self._flaky_tokens[replica] -= 1
            self.injected.append({"kind": "infer_fault", "t": t,
                                  "replica": replica})
            return next(ev for ev in self.schedule.events
                        if isinstance(ev, FlakyInfer) and ev.replica ==
                        replica and ev.t <= t)
        return None

    def bursts(self) -> list[RequestBurst]:
        return [ev for ev in self.schedule.events
                if isinstance(ev, RequestBurst)]
