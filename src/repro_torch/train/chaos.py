"""Deterministic, seeded fault injection for the resilient training loop,
the port's copy of ``repro/train/chaos.py``.

The chaos harness plays the 1000-host failure model against a *simulated*
multi-host clock, so every detection/eviction/recovery decision — and
therefore the resilience bench's goodput numbers — is a pure function of
the schedule, never of wall-clock noise:

  StepFault           the step raises once (preemption, OOM, flaky NIC)
  HostDeath           a host stops heart-beating; while it is still in the
                      loop's ``alive`` set, every step fails with a
                      collective timeout (a dead peer hangs the all-reduce)
  SlowHost            a host's step durations multiply by ``factor`` —
                      the straggler the §II-F work-division argument evicts
  CorruptCheckpoint   flip a byte in a leaf of the newest checkpoint
                      (silent storage corruption — CRC catches it on load)
  TornCheckpoint      mid-write crash artifacts: a partial ``step_<N>``
                      directory newer than the newest valid checkpoint (a
                      non-atomic writer's wreckage) plus a stale ``.tmp-*``
                      dir (what the atomic writer leaves behind)
  FlakySaves          the next N ``save`` calls raise (transient storage
                      outage — the loop's bounded-retry/backoff path)

``ChaosEngine`` binds to a ``ResilientLoop`` (pass ``chaos=engine``): it
supplies the simulated clock, the failure hook and the per-host heartbeat
source, wraps the checkpointer for save-fault injection, and reads the
loop's ``alive`` set back so an injected collective failure stops the
moment the dead host is evicted.  ``ChaosSchedule.generate(seed, ...)``
draws a reproducible schedule — the ``REPRO_CHAOS`` knob feeds it from
``launch/train.py``.

Under data parallelism every rank runs an engine on the same schedule, so
step faults and collective timeouts fire on every rank at the same step;
the checkpoint attacks and the save faults act only where ``writer`` is
True (the rank that writes the checkpoints), so a newest checkpoint is
corrupted once, not once a rank.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil

import numpy as np

from repro_torch.core.simtime import SimClock, seeded_rng  # noqa: F401
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.fault_tolerance import Heartbeat


class ChaosError(RuntimeError):
    """An injected failure (step fault / collective timeout)."""


# -- fault vocabulary ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepFault:
    step: int
    message: str = "injected step fault"
    cost_s: float = 0.5             # simulated time burned by the failure


@dataclasses.dataclass(frozen=True)
class HostDeath:
    step: int
    host: str


@dataclasses.dataclass(frozen=True)
class SlowHost:
    step: int
    host: str
    factor: float = 3.0
    until: int | None = None        # recovers at `until` (None = forever)


@dataclasses.dataclass(frozen=True)
class CorruptCheckpoint:
    step: int                       # fires once a checkpoint exists


@dataclasses.dataclass(frozen=True)
class TornCheckpoint:
    step: int                       # fires once a checkpoint exists to tear


@dataclasses.dataclass(frozen=True)
class FlakySaves:
    step: int
    times: int = 1


_KINDS = ("step_fault", "death", "slow", "corrupt", "torn", "flaky_save")


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    events: tuple
    seed: int | None = None

    @staticmethod
    def generate(seed: int, *, n_steps: int, hosts, kinds=_KINDS,
                 intensity: float = 1.0) -> "ChaosSchedule":
        """A reproducible random schedule: ~2% of steps fault at unit
        intensity.  Host 0 is never killed (something must survive), and at
        most ``len(hosts) - 1`` deaths are drawn so the fleet never empties.
        Same seed -> identical schedule, bit for bit."""
        hosts = list(hosts)
        rng = seeded_rng(0xC4A05, seed)
        n = max(1, round(n_steps * 0.02 * intensity))
        mortal = hosts[1:]
        events = []
        for _ in range(n):
            kind = kinds[int(rng.integers(len(kinds)))]
            step = int(rng.integers(1, max(2, n_steps)))
            if kind == "death" and mortal:
                events.append(HostDeath(step, mortal.pop(
                    int(rng.integers(len(mortal))))))
            elif kind == "slow" and len(hosts) > 1:
                events.append(SlowHost(
                    step, hosts[int(rng.integers(1, len(hosts)))],
                    factor=float(2.0 + 2.0 * rng.random()),
                    until=step + int(rng.integers(5, 30))))
            elif kind == "corrupt":
                events.append(CorruptCheckpoint(step))
            elif kind == "torn":
                events.append(TornCheckpoint(step))
            elif kind == "flaky_save":
                events.append(FlakySaves(step, times=int(rng.integers(1, 3))))
            else:
                events.append(StepFault(step))
        return ChaosSchedule(tuple(sorted(events, key=lambda e: e.step)),
                             seed=seed)


# -- checkpoint attack helpers (also used directly by tests) ------------------

def corrupt_latest(ckpt_dir) -> int | None:
    """Flip a byte in one leaf of the newest checkpoint; returns the step
    attacked (None when no checkpoint exists yet)."""
    step = ckpt_lib.latest_step(ckpt_dir)
    if step is None:
        return None
    path = pathlib.Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((path / "manifest.json").read_text())
    fname = sorted(m["file"] for m in manifest["leaves"].values())[0]
    f = path / fname
    raw = bytearray(f.read_bytes())
    raw[-1] ^= 0xFF
    f.write_bytes(bytes(raw))
    return step


def torn_checkpoint(ckpt_dir) -> int | None:
    """Leave mid-write crash wreckage: copy the newest checkpoint to a
    *newer* step number, truncate one leaf and drop another (the partial
    write a non-atomic writer strands), plus a stale ``.tmp-*`` directory
    (the atomic writer's).  Walk-back restore must skip both."""
    latest = ckpt_lib.latest_step(ckpt_dir)
    if latest is None:
        return None
    src = pathlib.Path(ckpt_dir) / f"step_{latest}"
    step = latest + 1
    dst = pathlib.Path(ckpt_dir) / f"step_{step}"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    leaves = sorted(p for p in dst.iterdir() if p.suffix == ".npy")
    raw = leaves[0].read_bytes()
    leaves[0].write_bytes(raw[:max(1, len(raw) // 2)])
    if len(leaves) > 1:
        leaves[-1].unlink()
    tmp = pathlib.Path(ckpt_dir) / f".tmp-step_{step + 1}"
    if tmp.exists():
        shutil.rmtree(tmp)
    shutil.copytree(src, tmp)
    return step


class _FlakyCheckpointer:
    """Checkpointer proxy: ``save`` raises while the engine says the
    storage is out; everything else delegates."""

    def __init__(self, inner, engine: "ChaosEngine"):
        self._inner = inner
        self._engine = engine

    def save(self, step, tree):
        if self._engine.take_save_fault():
            raise IOError("chaos: injected transient checkpoint-save failure")
        return self._inner.save(step, tree)

    def __getattr__(self, name):
        return getattr(self._inner, name)


# -- the engine ---------------------------------------------------------------

class ChaosEngine:
    """Replays a ``ChaosSchedule`` against a ``ResilientLoop``.

    The engine owns the ``SimClock`` and advances it: each successful step
    costs ``step_s`` x the slowest alive host's factor; each collective
    failure costs ``collective_timeout_s``; each injected step fault costs
    its ``cost_s``.  Goodput under a schedule is then
    ``t(fault_free) / t(schedule)`` — fully deterministic.
    """

    def __init__(self, schedule: ChaosSchedule, *, hosts, ckpt_dir,
                 step_s: float = 1.0, collective_timeout_s: float = 2.0,
                 clock: SimClock | None = None, writer: bool = True):
        self.schedule = schedule
        self.hosts = list(hosts)
        self.ckpt_dir = ckpt_dir
        self.step_s = step_s
        self.collective_timeout_s = collective_timeout_s
        self.clock = clock or SimClock()
        self.dead: set[str] = set()
        self.slow: dict[str, SlowHost] = {}
        self.injected: list[dict] = []
        self._fired: set[int] = set()
        self._flaky_saves = 0
        self._loop = None
        self.writer = writer

    def bind(self, loop) -> None:
        self._loop = loop
        loop.checkpointer = _FlakyCheckpointer(loop.checkpointer, self)

    def make_heartbeat(self, *, window: int = 8,
                       threshold: float = 1.5) -> Heartbeat:
        """A Heartbeat scaled to simulated time: the dead timeout is a few
        collective timeouts, so a dead host is detected after a handful of
        failed attempts instead of 300 wall seconds."""
        return Heartbeat(window=window, threshold=threshold,
                         timeout_s=2.5 * max(self.collective_timeout_s,
                                             self.step_s),
                         clock=self.clock.time)

    # -- loop-facing hooks ----------------------------------------------------

    def _alive(self) -> set[str]:
        return set(self._loop.alive) if self._loop is not None \
            else set(self.hosts)

    def take_save_fault(self) -> bool:
        if self._flaky_saves > 0:
            self._flaky_saves -= 1
            self._log("save_fault")
            return True
        return False

    def _drain_saves(self) -> None:
        """Join the loop's in-flight async save before attacking the
        checkpoint directory — the attack must hit a *durable* checkpoint,
        not race a background writer (replay determinism)."""
        if self._loop is None:
            return
        try:
            self._loop.checkpointer.wait()
        except Exception:  # noqa: BLE001 — the loop's retry path owns it
            pass

    def _log(self, kind: str, **fields) -> None:
        self.injected.append({"kind": kind, "t": self.clock.time(), **fields})

    def _apply_due(self, step: int) -> None:
        for i, ev in enumerate(self.schedule.events):
            if i in self._fired or ev.step > step:
                continue
            if isinstance(ev, HostDeath):
                self.dead.add(ev.host)
            elif isinstance(ev, SlowHost):
                self.slow[ev.host] = ev
            elif isinstance(ev, (CorruptCheckpoint, TornCheckpoint,
                                 FlakySaves)) and not self.writer:
                pass                    # the writer rank attacks its files
            elif isinstance(ev, CorruptCheckpoint):
                self._drain_saves()
                attacked = corrupt_latest(self.ckpt_dir)
                if attacked is None:
                    continue            # no checkpoint yet — stay armed
                self._fired.add(i)
                self._log("CorruptCheckpoint", step=step, attacked=attacked)
                continue
            elif isinstance(ev, TornCheckpoint):
                self._drain_saves()
                attacked = torn_checkpoint(self.ckpt_dir)
                if attacked is None:
                    continue
                self._fired.add(i)
                self._log("TornCheckpoint", step=step, attacked=attacked)
                continue
            elif isinstance(ev, FlakySaves):
                self._flaky_saves += ev.times
            elif isinstance(ev, StepFault):
                self._fired.add(i)
                self._log("step_fault", step=step)
                self.clock.advance(ev.cost_s)
                raise ChaosError(f"{ev.message} @ step {step}")
            self._fired.add(i)
            self._log(type(ev).__name__, step=step,
                      host=getattr(ev, "host", None))

    def failure_hook(self, step: int) -> None:
        """Install as the loop's ``failure_hook`` (runs before every step).
        Applies due schedule events, then fails the collective while any
        dead host is still considered alive by the loop."""
        self._apply_due(step)
        dead_alive = self.dead & self._alive()
        if dead_alive:
            self.clock.advance(self.collective_timeout_s)
            self._log("collective_timeout", step=step,
                      hosts=sorted(dead_alive))
            raise ChaosError(
                f"collective timeout: no heartbeat from {sorted(dead_alive)}")

    def liveness(self, step: int) -> list[str]:
        """Hosts that answer an out-of-band liveness ping right now —
        everyone except the dead.  Never advances the clock (pings are
        cheap and concurrent with the hung collective)."""
        return sorted(self._alive() - self.dead)

    def heartbeat_source(self, step: int, dt: float) -> dict:
        """Simulated per-host step durations; advances the clock by the
        slowest alive host (synchronous data parallelism).  Dead hosts are
        absent — their ``last_seen`` goes stale until the timeout fires."""
        alive = self._alive() - self.dead
        durations = {}
        for h in sorted(alive):
            ev = self.slow.get(h)
            factor = ev.factor if ev is not None and \
                (ev.until is None or step < ev.until) else 1.0
            durations[h] = self.step_s * factor
        self.clock.advance(max(durations.values()) if durations
                           else self.step_s)
        return durations
