"""Fault tolerance: heartbeats, straggler detection, restart-on-failure,
elastic re-scale: the self-healing loop, the port's copy of
``repro/train/fault_tolerance.py``.

At 1000+ nodes the failure model is: (a) a host dies mid-step (restart from
checkpoint), (b) a host slows down (straggler — detect and evict), (c) a
checkpoint is corrupt or half-written (walk back to the newest verifiable
one), (d) capacity changes (elastic — fold the state onto the new mesh).
``ResilientLoop`` drives all four without operator intervention:

  * per-host heartbeat recording each step (durations come from the real
    wall clock, or from an injected ``heartbeat_source`` — the chaos
    harness in ``train/chaos.py`` simulates a multi-host fleet this way);
  * dead-host / straggler detection on a policy cadence (``policy_every``)
    *and* on every step failure (a dead host fails the collective — the
    fix is eviction, not retry);
  * eviction -> elastic re-scale: the victims leave ``alive``, an optional
    ``elastic_fn(state, alive)`` folds the state onto the narrower mesh
    (the DP CNN path sum-folds the int8 error-feedback residual so no
    gradient mass is lost — ``train.distributed.reshard_cnn_state``), and
    the folded state is synchronously checkpointed before training resumes;
  * under data parallelism every rank runs the loop on its own process in
    step with the others: ``snapshot_fn`` gives the tree a checkpoint holds
    (the data-parallel CNN state gathered over the group, a collective
    every rank calls at the same step) and only the ``writer`` rank writes
    it (``train.distributed.cnn_dp_resilience`` makes both and the
    ``restore_fn`` that waits for the writer); with ``group`` the loop
    recovers only from faults every rank raises at the same step, before
    the step's collectives, and a failed collective ends the run;
  * checkpoint I/O runs under bounded retries with exponential backoff, and
    restore walks back past corrupt/partial checkpoints
    (``checkpoint.restore_latest``);
  * every recovery action lands in a structured event log (``events``) —
    restarts, evictions, lost steps, skipped checkpoints, recovery
    wall-time — summarized by ``resilience_summary()``.

The simulated-time seam: ``clock`` is any object with ``time()``/``sleep``;
``Heartbeat`` takes a ``clock`` *callable*.  Production uses the wall clock,
the chaos harness and the resilience bench inject ``chaos.SimClock`` so
detection timing (and therefore goodput) is deterministic.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.train import checkpoint as ckpt_lib


class _WallClock:
    sleep = staticmethod(time.sleep)
    time = staticmethod(time.time)


@dataclasses.dataclass
class Heartbeat:
    """Per-host step-duration tracker with dead-host/straggler detection.

    ``clock`` is the time source ``record``/``dead`` fall back to when no
    explicit ``now`` is passed — wall clock by default, a simulated clock
    under the chaos harness (mixing wall-clock ``_last_seen`` stamps with
    injected ``now`` comparisons was the PR-5 inconsistency)."""
    window: int = 20
    threshold: float = 1.5          # x median = straggler
    timeout_s: float = 300.0        # no heartbeat at all = dead
    clock: object = time.time

    def __post_init__(self):
        self._durations: dict[str, list[float]] = {}
        self._last_seen: dict[str, float] = {}

    def record(self, host: str, duration_s: float, now: float | None = None):
        self._durations.setdefault(host, []).append(duration_s)
        self._durations[host] = self._durations[host][-self.window:]
        self._last_seen[host] = self.clock() if now is None else now

    def ping(self, host: str, now: float | None = None):
        """Liveness only — refresh ``last_seen`` without a duration sample.
        Heartbeats are out-of-band from the training collective: a host
        stuck in a hung all-reduce still answers pings, so a collective
        failure must not make the whole fleet look dead at once."""
        self._last_seen[host] = self.clock() if now is None else now

    def medians(self) -> dict[str, float]:
        """Per-host median step duration over the window — the public read
        API (``RebalancePlan`` and the straggler policy consume this)."""
        return {h: float(np.median(d))
                for h, d in self._durations.items() if d}

    def stragglers(self) -> list[str]:
        meds = self.medians()
        if len(meds) < 2:
            return []
        global_med = float(np.median(list(meds.values())))
        return [h for h, m in meds.items()
                if m > self.threshold * global_med]

    def dead(self, now: float | None = None) -> list[str]:
        now = self.clock() if now is None else now
        return [h for h, t in self._last_seen.items()
                if now - t > self.timeout_s]

    def forget(self, host: str) -> None:
        """Drop a host's history (evicted — it must not keep tripping the
        dead/straggler detectors)."""
        self._durations.pop(host, None)
        self._last_seen.pop(host, None)


@dataclasses.dataclass
class RebalancePlan:
    """Straggler mitigation: shrink the straggler's micro-batch share and
    grow the fast hosts' (the §II-F work-division argument, at host scale)."""
    shares: dict

    @staticmethod
    def from_heartbeat(hb: Heartbeat, hosts: list[str]) -> "RebalancePlan":
        meds = hb.medians()
        speed = {h: 1.0 / meds.get(h, 1.0) for h in hosts}
        total = sum(speed.values())
        return RebalancePlan({h: s / total for h, s in speed.items()})


class ResilientLoop:
    """Wraps a train loop with self-healing recovery (module docstring has
    the policy map).  Legacy single-host use is the degenerate case: one
    host, wall clock, no elastic hook — behaviour identical to the PR-5
    loop plus walk-back restore and checkpoint-I/O retries.

    ``elastic_fn(state, alive) -> (state, step_fn)`` re-builds the training
    state and step for the narrower fleet after an eviction; with ``None``
    an eviction only drops the host from ``alive`` (membership change, the
    LM trainer's simulated-host case).  ``chaos`` is a
    ``train.chaos.ChaosEngine``: it supplies the clock, failure hook and
    per-host heartbeat source, and gets bound back to this loop so injected
    collective failures stop once the dead host is evicted.

    ``snapshot_fn(state) -> tree`` (default: the state itself) is what a
    checkpoint holds; it is called on every rank at each save point, so it
    may run collectives.  ``writer`` False makes a rank that takes part in
    those collectives but writes no checkpoint (the data-parallel ranks
    but rank 0).  A step's metrics that are not scalars (a gradient tree)
    are left out of ``metrics_log``.

    ``group`` is the process group a data-parallel ``step_fn`` runs its
    collectives over.  With one, the loop recovers only from what
    ``failure_hook`` raises: it runs before the step's collectives, and
    the chaos harness raises there on every rank at the same step.  An
    error past it (a failed or timed-out collective, or an error on one
    rank) ends the run on that rank, whose peers' collectives then fail
    in turn: no rank retries or restores alone.  ``restore_fn`` then runs
    once, not under the I/O retries (it meets the other ranks), and the
    eviction policy takes the group's rank 0's decision, so that every
    rank's membership agrees.
    """

    def __init__(self, *, step_fn, state, data, ckpt_dir,
                 ckpt_every: int = 50, max_retries: int = 3,
                 failure_hook=None, restore_fn=None,
                 hosts=("host0",), clock=None, policy_every: int = 10,
                 elastic_fn=None, heartbeat_source=None, heartbeat=None,
                 liveness_source=None, min_hosts: int = 1,
                 io_retries: int = 3, io_backoff_s: float = 0.05,
                 keep: int = 3, chaos=None, snapshot_fn=None,
                 writer: bool = True, group=None):
        if chaos is not None:
            clock = chaos.clock if clock is None else clock
            hosts = chaos.hosts if tuple(hosts) == ("host0",) else hosts
            failure_hook = failure_hook or chaos.failure_hook
            heartbeat_source = heartbeat_source or chaos.heartbeat_source
            liveness_source = liveness_source or chaos.liveness
        self.step_fn = step_fn
        self.state = state
        self.data = data
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.failure_hook = failure_hook
        self.restore_fn = restore_fn or self._default_restore
        self.clock = clock or _WallClock()
        self.checkpointer = ckpt_lib.AsyncCheckpointer(ckpt_dir, keep=keep)
        self.heartbeat = heartbeat if heartbeat is not None else \
            Heartbeat(clock=self.clock.time)
        self.alive: list[str] = list(hosts)
        self.policy_every = policy_every
        self.elastic_fn = elastic_fn
        self.heartbeat_source = heartbeat_source
        self.liveness_source = liveness_source
        self.min_hosts = min_hosts
        self.io_retries = io_retries
        self.io_backoff_s = io_backoff_s
        self.snapshot_fn = snapshot_fn
        self.writer = writer
        self.group = group
        self.restarts = 0
        self.evictions = 0
        self.lost_steps = 0
        self.steps_run = 0
        self.io_retries_used = 0
        self.metrics_log: list[dict] = []
        self.events: list[dict] = []
        if chaos is not None:
            chaos.bind(self)

    # -- bookkeeping ----------------------------------------------------------

    def event(self, kind: str, **fields) -> None:
        self.events.append({"kind": kind, "t": self.clock.time(), **fields})

    def resilience_summary(self) -> dict:
        recovery = sum(e.get("recovery_s", 0.0) for e in self.events)
        return {"restarts": self.restarts, "evictions": self.evictions,
                "lost_steps": self.lost_steps, "steps_run": self.steps_run,
                "io_retries": self.io_retries_used,
                "recovery_s": round(recovery, 6),
                "n_hosts": len(self.alive), "n_events": len(self.events)}

    # -- checkpoint I/O (bounded retries, exponential backoff) ----------------

    def _io_retry(self, fn, *, what: str, step: int, fatal: bool = False):
        delay = self.io_backoff_s
        for attempt in range(self.io_retries + 1):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001
                self.io_retries_used += 1
                self.event("io_retry", step=step, what=what,
                           attempt=attempt + 1, error=repr(e))
                if attempt == self.io_retries:
                    if fatal:
                        raise
                    self.event("io_giveup", step=step, what=what)
                    return None
                self.clock.sleep(delay)
                delay *= 2

    def _save(self, step: int, *, sync: bool = False) -> None:
        tree = self.state if self.snapshot_fn is None \
            else self.snapshot_fn(self.state)
        if not self.writer:
            return
        if sync:
            self._io_retry(
                lambda: ckpt_lib.save(self.ckpt_dir, step, tree,
                                      keep=self.checkpointer.keep),
                what="sync_save", step=step)
        else:
            self._io_retry(lambda: self.checkpointer.save(step, tree),
                           what="async_save", step=step)

    def _drain_async_save(self, step: int) -> None:
        """Join any in-flight background save; a failure there is logged
        (and the next save's retry loop will surface it), never allowed to
        mask the recovery we're in the middle of."""
        try:
            self.checkpointer.wait()
        except Exception as e:  # noqa: BLE001
            self.event("async_save_error", step=step, error=repr(e))

    def _default_restore(self, state_template):
        skips = []
        state, step = ckpt_lib.restore_latest(
            self.ckpt_dir, state_template,
            on_skip=lambda s, e: skips.append((s, repr(e))))
        for s, err in skips:
            self.event("ckpt_skipped", step=s, error=err)
        return state, step

    # -- heartbeats + eviction policy -----------------------------------------

    def _ping_liveness(self, step: int) -> None:
        """Out-of-band liveness: after a step failure the collective tells
        us nothing, but responsive hosts still answer pings — only the
        truly dead host's ``last_seen`` goes stale.  Without this, a hung
        collective would age out the *whole* fleet together and eviction
        could never satisfy ``min_hosts``."""
        if self.liveness_source is None:
            return
        now = self.clock.time()
        for host in self.liveness_source(step):
            if host in self.alive:
                self.heartbeat.ping(host, now=now)

    def _record_heartbeats(self, step: int, dt: float) -> None:
        if self.heartbeat_source is not None:
            durations = self.heartbeat_source(step, dt)
        else:
            durations = {h: dt for h in self.alive}
        now = self.clock.time()
        for host, d in durations.items():
            if d is not None and host in self.alive:
                self.heartbeat.record(host, float(d), now=now)

    def _maybe_evict(self, step: int) -> bool:
        """Dead-host/straggler sweep: evict, fold, checkpoint, resume.
        Returns True iff an eviction happened (state/step_fn may be new)."""
        now = self.clock.time()
        dead = [h for h in self.heartbeat.dead(now) if h in self.alive]
        stragglers = [h for h in self.heartbeat.stragglers()
                      if h in self.alive and h not in dead]
        if self.group is not None:
            import torch.distributed as dist
            box = [(dead, stragglers)]
            dist.broadcast_object_list(
                box, src=dist.get_global_rank(self.group, 0),
                group=self.group)
            dead, stragglers = box[0]
        victims = dead + stragglers
        if not victims:
            return False
        if len(self.alive) - len(victims) < self.min_hosts:
            self.event("eviction_skipped", step=step, hosts=victims,
                       reason=f"would leave < {self.min_hosts} hosts")
            return False
        t0 = now
        self._drain_async_save(step)
        for h in victims:
            self.alive.remove(h)
            self.heartbeat.forget(h)
        self.evictions += len(victims)
        if self.elastic_fn is not None:
            self.state, self.step_fn = self.elastic_fn(self.state,
                                                       list(self.alive))
        # durable point AFTER the fold: restores from here on see the
        # re-scaled state, and walk-back skips the pre-fold shapes
        self._save(step, sync=True)
        self.event("eviction", step=step, hosts=victims, dead=dead,
                   stragglers=stragglers, n_alive=len(self.alive),
                   recovery_s=self.clock.time() - t0)
        return True

    # -- the loop -------------------------------------------------------------

    def run(self, n_steps: int, start_step: int = 0):
        step = start_step
        retries = 0
        while step < n_steps:
            past_hook = False
            try:
                t0 = self.clock.time()
                if self.failure_hook is not None:
                    self.failure_hook(step)
                past_hook = True
                batch = self.data.batch_at(step)
                self.state, metrics = self.step_fn(self.state, batch)
                self._record_heartbeats(step, self.clock.time() - t0)
                self.steps_run += 1
                self.metrics_log.append(
                    {"step": step,
                     **{k: float(v) for k, v in metrics.items()
                        if not isinstance(v, dict)}})
                step += 1
                retries = 0
                if step % self.ckpt_every == 0:
                    self._save(step)
                if self.policy_every and step % self.policy_every == 0:
                    self._maybe_evict(step)
            except Exception as e:  # noqa: BLE001
                if self.group is not None and past_hook:
                    raise
                retries += 1
                self.restarts += 1
                self.event("step_failure", step=step, error=repr(e),
                           retry=retries)
                self._ping_liveness(step)
                if self._maybe_evict(step):
                    # a dead host fails the collective on every retry;
                    # eviction (not restore) is the recovery — the state is
                    # still the last good one, so resume at the same step
                    retries = 0
                    continue
                if retries > self.max_retries:
                    raise
                self._drain_async_save(step)
                prev = step
                t_r = self.clock.time()
                if self.group is not None:
                    self.state, step = self.restore_fn(self.state)
                else:
                    self.state, step = self._io_retry(
                        lambda: self.restore_fn(self.state),
                        what="restore", step=step, fatal=True)
                self.lost_steps += max(0, prev - step)
                self.event("restart", step=prev, restored_step=step,
                           lost_steps=max(0, prev - step),
                           recovery_s=self.clock.time() - t_r)
        # drain, don't raise: a failed background save after the last step
        # is an event, not a training failure
        self._drain_async_save(step)
        return self.state


def elastic_reshard(ckpt_dir, step, state_template, device=None):
    """Re-scale: restore a checkpoint onto another data group (or
    device).  Leaves are stored whole, so this is a restore onto
    ``device``; the data pipeline's cursor (the global step) does not
    depend on the layout."""
    return ckpt_lib.restore(ckpt_dir, step, state_template, device=device)


def elastic_reshard_cnn(ckpt_dir, step, state_template, group=None, *,
                        device=None):
    """Elastic re-scale for the data-parallel CNN train state
    (``train/distributed.py``): params and step restore as usual, but the
    int8 error-feedback residual holds one accumulator per *old* rank and
    cannot simply move onto a narrower group.  Restore it whole (the
    template has the old width), sum-fold the residual's rows onto the new
    group's width (no gradient mass that was not yet applied is dropped)
    and keep this rank's row, on ``device``
    (``distributed.reshard_cnn_state``)."""
    from repro_torch.train.distributed import reshard_cnn_state
    state = ckpt_lib.restore(ckpt_dir, step, state_template, device=device)
    return reshard_cnn_state(state, group, device=device)
