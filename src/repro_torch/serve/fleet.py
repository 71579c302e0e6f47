"""Resilient multi-replica serving fleet, the port's copy of
``repro/serve/fleet.py``, with its names, policies and simulated time.

``FleetRouter`` fronts N replicas behind one bounded request queue and a
discrete-event loop over ``core.simtime.SimClock``, so every latency,
detection, and recovery number is a pure function of the seeded arrival +
fault schedule, and no decision reads a wall clock or the card:

  * **deadlines + bounded-backoff retry** — a failed dispatch (flaky
    accelerator) re-queues on a *different* replica after an exponential
    backoff, bounded by ``max_retries``;
  * **hedged requests** — a dispatch that outlives ``hedge_after_s``
    (straggler replica) gets a clone on an idle replica; the first
    completion wins and the loser is cancelled — the p99-tail policy;
  * **health-checked eviction + respawn** — replicas are pinged on a
    cadence; one silent past ``health_timeout_s`` is evicted (its in-flight
    requests reassigned) and respawned after ``respawn_after_s`` with warm
    plan caches re-seeded from the surviving replicas'
    ``TuneCache.export_entries`` — a cold respawn would pay
    ``cold_service_s`` on its first dispatch, a re-seeded one does not;
  * **admission control / load shedding** — arrivals beyond ``queue_bound``
    are rejected outright; arrivals beyond the SLO-feasible queue depth
    (the depth that can still drain within the deadline at the live fleet's
    service rate) are *degraded* instead of rejected;
  * **graceful degradation** — degraded requests run the int8 twin:
    ``q8_service_factor`` cheaper in the model, the ``quantized=True``
    twin engine's ``infer`` (K3 on the card) on the real path.  A request
    whose f32 dispatch would bust its deadline is flipped to the degrade
    path at dispatch time, so every *admitted* request either completes
    within its deadline or was handed to the int8 path — the SLO
    invariant (``slo_handled_rate``).

Replicas are real ``CnnInferenceEngine`` pairs (f32 through K1 + the
quantized twin) in ``launch/serve_cnn.py --fleet``, and service-time
models where requests carry no image — the router cannot tell the
difference: it charges modeled seconds either way and calls ``infer`` only
when a request actually carries an image, and then keeps the logits row on
the host (numpy), as the reference does.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools

import numpy as np

from repro_torch.core.simtime import SimClock, seeded_rng


@dataclasses.dataclass
class Request:
    """One inference request and its lifecycle under the router."""
    rid: int
    t_arrival: float
    deadline_s: float
    image: object = None            # None: a modeled request
    status: str = "queued"          # queued | running | done | shed | failed
    degraded: bool = False          # handed to the int8 twin
    hedged: bool = False
    retries: int = 0
    t_done: float | None = None
    result: object = None           # logits row on the real-engine path
    avoid: set = dataclasses.field(default_factory=set)
    dispatches: list = dataclasses.field(default_factory=list)

    @property
    def latency_s(self) -> float | None:
        return None if self.t_done is None else self.t_done - self.t_arrival

    @property
    def in_deadline(self) -> bool:
        return self.t_done is not None and \
            self.latency_s <= self.deadline_s + 1e-9

    @property
    def slo_handled(self) -> bool:
        """The SLO invariant: completed within deadline, or handed to the
        degrade path (which always admits rather than rejects)."""
        return self.status == "done" and (self.in_deadline or self.degraded)


class Replica:
    """One serving replica: an (optional) real engine pair plus the
    service-time model the router charges.

    ``infer_fn``/``q8_infer_fn`` take an (n, H, W, 3) batch and return
    logits — on the real path these are ``CnnInferenceEngine.infer`` bound
    methods (f32 and the ``quantized=True`` twin), whose tensors ``infer``
    brings to the host.  ``cache`` is the
    replica's ``TuneCache``: the respawn path exports a survivor's entries
    into a fresh replica so it never re-tunes (``cold_service_s`` models
    the first-dispatch tune+compile a cold spawn would pay).
    """

    def __init__(self, name: str, *, infer_fn=None, q8_infer_fn=None,
                 cache=None, service_s: float = 1.0,
                 q8_service_factor: float = 0.55,
                 cold_service_s: float = 0.0):
        self.name = name
        self.infer_fn = infer_fn
        self.q8_infer_fn = q8_infer_fn
        self.cache = cache
        self.service_s = float(service_s)
        self.q8_service_factor = float(q8_service_factor)
        self.cold_service_s = float(cold_service_s)
        self.busy_rid: int | None = None
        self.busy_epoch: int | None = None
        self.dispatched = 0

    # -- warm-cache plumbing (TuneCache payloads) -----------------------------
    def warm_entries(self) -> int:
        return len(self.cache) if self.cache is not None else 0

    def export_warm(self) -> dict:
        return self.cache.export_entries() if self.cache is not None else {}

    def seed_warm(self, payload: dict) -> int:
        if self.cache is None or not payload:
            return 0
        return self.cache.merge_entries(payload, persist=False)

    # -- the service model ----------------------------------------------------
    def service_time(self, *, degraded: bool = False,
                     slow_factor: float = 1.0) -> float:
        s = self.service_s * slow_factor
        if degraded:
            s *= self.q8_service_factor
        if self.dispatched == 0 and self.warm_entries() == 0:
            s += self.cold_service_s      # cold spawn: first dispatch tunes
        return s

    def infer(self, images, *, degraded: bool = False):
        """Logits of ``images`` from the f32 engine, or the int8 twin where
        ``degraded`` (and one is given), as a host numpy array (the
        engine's tensor through ``.cpu()``); None without an engine."""
        fn = self.q8_infer_fn if degraded and self.q8_infer_fn is not None \
            else self.infer_fn
        if fn is None:
            return None
        logits = fn(images)
        return logits.detach().cpu().numpy() if hasattr(logits, "detach") \
            else np.asarray(logits)


class FleetRouter:
    """Event-driven router over a replica fleet (module docstring has the
    policy map).  ``run(arrivals)`` replays ``(t, image)`` arrivals (plus
    the chaos schedule's bursts) to completion and returns ``report()``.
    """

    def __init__(self, replicas, *, clock: SimClock | None = None,
                 chaos=None, deadline_s: float = 6.0, queue_bound: int = 32,
                 slo_depth: int | None = None, hedge_after_s: float | None = None,
                 max_retries: int = 3, backoff_s: float = 0.25,
                 health_every_s: float = 1.0, health_timeout_s: float = 2.5,
                 respawn_after_s: float = 4.0, degrade: bool = True,
                 replica_factory=None, burst_image_fn=None):
        self.live: dict[str, Replica] = {r.name: r for r in replicas}
        assert self.live, "a fleet needs at least one replica"
        self.clock = clock or SimClock()
        self.chaos = chaos
        self.deadline_s = float(deadline_s)
        self.queue_bound = int(queue_bound)
        self._slo_depth_override = slo_depth
        self.hedge_after_s = 1.5 * max(r.service_s for r in replicas) \
            if hedge_after_s is None else hedge_after_s
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.health_every_s = float(health_every_s)
        self.health_timeout_s = float(health_timeout_s)
        self.respawn_after_s = float(respawn_after_s)
        self.degrade_enabled = bool(degrade)
        self.replica_factory = replica_factory
        self.burst_image_fn = burst_image_fn
        self.queue: list[int] = []            # FIFO of queued rids
        self.requests: dict[int, Request] = {}
        self.last_ok: dict[str, float] = {n: 0.0 for n in self.live}
        self.born: dict[str, float] = {n: 0.0 for n in self.live}
        self.events: list[dict] = []
        self.evictions = 0
        self.respawns = 0
        self.hedges = 0
        self.reseeded_entries = 0
        self._heap: list[tuple] = []
        self._seq = itertools.count()
        self._rids = itertools.count()
        self._epochs = itertools.count(1)
        self._health_armed = False

    # -- bookkeeping ----------------------------------------------------------

    def event(self, kind: str, **fields) -> None:
        self.events.append({"kind": kind, "t": round(self.clock.time(), 6),
                            **fields})

    def _push(self, t: float, kind: str, data=None) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), kind, data))

    def _slo_depth(self) -> int:
        """Queue depth still drainable within the deadline at the live
        fleet's f32 service rate; deeper arrivals get the degrade path."""
        if self._slo_depth_override is not None:
            return self._slo_depth_override
        if not self.live:
            return 0
        svc = sum(r.service_s for r in self.live.values()) / len(self.live)
        return max(1, int((self.deadline_s / svc - 1.0) * len(self.live)))

    def _outstanding(self) -> bool:
        return any(r.status in ("queued", "running")
                   for r in self.requests.values())

    def _arm_health(self) -> None:
        if not self._health_armed and self._outstanding():
            self._health_armed = True
            self._push(self.clock.time() + self.health_every_s, "health")

    # -- the event loop -------------------------------------------------------

    def run(self, arrivals) -> dict:
        """Replay ``(t, image)`` arrivals plus the chaos bursts; returns
        ``report()``.  Deterministic: the heap orders ties by push
        sequence, and every decision reads only simulated time."""
        for t, image in arrivals:
            self._push(float(t), "arrival", image)
        if self.chaos is not None:
            for b in self.chaos.bursts():
                for i in range(b.n):
                    image = self.burst_image_fn(i) \
                        if self.burst_image_fn is not None else None
                    self._push(float(b.t), "arrival", image)
        handlers = {"arrival": self._on_arrival, "complete": self._on_complete,
                    "fault": self._on_fault, "retry": self._on_retry,
                    "hedge": self._on_hedge, "health": self._on_health,
                    "respawn": self._on_respawn}
        while self._heap:
            t, _, kind, data = heapq.heappop(self._heap)
            self.clock.advance_to(t)
            handlers[kind](t, data)
        return self.report()

    # -- admission ------------------------------------------------------------

    def _on_arrival(self, t: float, image) -> None:
        req = Request(next(self._rids), t, self.deadline_s, image=image)
        self.requests[req.rid] = req
        if len(self.queue) >= self.queue_bound:
            req.status = "shed"
            self.event("shed", rid=req.rid, queue_depth=len(self.queue))
            return
        if self.degrade_enabled and len(self.queue) >= self._slo_depth():
            req.degraded = True
            self.event("degrade_admission", rid=req.rid,
                       queue_depth=len(self.queue))
        self.queue.append(req.rid)
        self._dispatch(t)
        self._arm_health()

    # -- dispatch -------------------------------------------------------------

    def _idle(self) -> list[Replica]:
        return [r for r in self.live.values() if r.busy_rid is None]

    def _dispatch(self, t: float) -> None:
        while self.queue:
            idle = self._idle()
            if not idle:
                return
            rid = self.queue.pop(0)
            req = self.requests[rid]
            preferred = [r for r in idle if r.name not in req.avoid] or idle
            # least-loaded first, name as the deterministic tiebreak
            rep = min(preferred, key=lambda r: (r.dispatched, r.name))
            self._start(req, rep, t)

    def _start(self, req: Request, rep: Replica, t: float,
               hedge: bool = False) -> None:
        slow = self.chaos.slow_factor(rep.name, t) if self.chaos else 1.0
        if self.degrade_enabled and not req.degraded and \
                t + rep.service_time(slow_factor=slow) > \
                req.t_arrival + req.deadline_s:
            # the f32 path would bust the deadline: hand to the int8 twin
            req.degraded = True
            self.event("degrade_deadline", rid=req.rid, replica=rep.name)
        svc = rep.service_time(degraded=req.degraded, slow_factor=slow)
        epoch = next(self._epochs)
        rep.busy_rid, rep.busy_epoch = req.rid, epoch
        rep.dispatched += 1
        req.status = "running"
        req.dispatches.append((rep.name, epoch))
        fault = self.chaos.take_infer_fault(rep.name, t) \
            if self.chaos else None
        if fault is not None:
            self._push(t + fault.cost_s, "fault", (rep.name, req.rid, epoch))
        elif self.chaos is not None and self._dead(rep.name, t):
            pass        # dispatched into a dead replica: hangs until evicted
        else:
            self._push(t + svc, "complete", (rep.name, req.rid, epoch))
        if not hedge and self.hedge_after_s is not None:
            self._push(t + self.hedge_after_s, "hedge",
                       (rep.name, req.rid, epoch))

    def _dead(self, name: str, t: float) -> bool:
        return self.chaos is not None and \
            self.chaos.is_dead(name, t, born=self.born[name])

    def _stale(self, name: str, epoch: int) -> bool:
        rep = self.live.get(name)
        return rep is None or rep.busy_epoch != epoch

    # -- completions / failures ----------------------------------------------

    def _on_complete(self, t: float, data) -> None:
        name, rid, epoch = data
        if self._stale(name, epoch):
            return
        if self._dead(name, t):
            return      # died mid-service: the result never made it out
        rep = self.live[name]
        rep.busy_rid = rep.busy_epoch = None
        req = self.requests[rid]
        req.status, req.t_done = "done", t
        if req.image is not None:
            logits = rep.infer(np.asarray(req.image)[None],
                               degraded=req.degraded)
            req.result = None if logits is None else np.asarray(logits)[0]
        # a hedged twin may still be running the same request: cancel it
        for other, oe in req.dispatches:
            if other != name and not self._stale(other, oe):
                twin = self.live[other]
                twin.busy_rid = twin.busy_epoch = None
                self.event("hedge_cancel", rid=rid, replica=other)
        self._dispatch(t)

    def _on_fault(self, t: float, data) -> None:
        name, rid, epoch = data
        if self._stale(name, epoch):
            return
        rep = self.live[name]
        rep.busy_rid = rep.busy_epoch = None
        self._requeue(self.requests[rid], t, failed_on=name, backoff=True)
        self._dispatch(t)

    def _requeue(self, req: Request, t: float, *, failed_on: str,
                 backoff: bool) -> None:
        """Bounded retry on a different replica (flaky infer / eviction)."""
        if req.status == "done":
            return
        req.retries += 1
        req.avoid.add(failed_on)
        if req.retries > self.max_retries:
            req.status = "failed"
            self.event("retries_exhausted", rid=req.rid)
            return
        req.status = "queued"
        if backoff:
            delay = self.backoff_s * (2 ** (req.retries - 1))
            self.event("retry_backoff", rid=req.rid, replica=failed_on,
                       delay_s=round(delay, 6))
            self._push(t + delay, "retry", req.rid)
        else:
            self.queue.insert(0, req.rid)

    def _on_retry(self, t: float, rid: int) -> None:
        req = self.requests[rid]
        if req.status != "queued" or rid in self.queue:
            return
        self.queue.insert(0, rid)       # retries go to the head: oldest first
        self._dispatch(t)

    # -- hedging --------------------------------------------------------------

    def _on_hedge(self, t: float, data) -> None:
        name, rid, epoch = data
        req = self.requests[rid]
        if req.status != "running" or self._stale(name, epoch):
            return
        idle = [r for r in self._idle()
                if r.name != name and r.name not in req.avoid]
        if not idle:
            return
        rep = min(idle, key=lambda r: (r.dispatched, r.name))
        req.hedged = True
        self.hedges += 1
        self.event("hedge", rid=rid, slow=name, to=rep.name)
        self._start(req, rep, t, hedge=True)

    # -- health / eviction / respawn ------------------------------------------

    def _on_health(self, t: float, _) -> None:
        self._health_armed = False
        for name in list(self.live):
            if self._dead(name, t):
                if t - self.last_ok[name] > self.health_timeout_s:
                    self._evict(name, t)
            else:
                self.last_ok[name] = t
        self._dispatch(t)
        self._arm_health()

    def _evict(self, name: str, t: float) -> None:
        rep = self.live.pop(name)
        self.evictions += 1
        self.event("eviction", replica=name,
                   silent_s=round(t - self.last_ok[name], 6))
        if rep.busy_rid is not None:
            req = self.requests[rep.busy_rid]
            rep.busy_rid = rep.busy_epoch = None
            # reassign unless a hedged twin is still live on another replica
            still_running = any(not self._stale(n, e)
                                for n, e in req.dispatches)
            if req.status == "running" and not still_running:
                self._requeue(req, t, failed_on=name, backoff=False)
                self.event("reassign", rid=req.rid, replica=name)
        if self.replica_factory is not None:
            self._push(t + self.respawn_after_s, "respawn", name)

    def _on_respawn(self, t: float, name: str) -> None:
        rep = self.replica_factory(name)
        donors = sorted(self.live.values(),
                        key=lambda r: (-r.warm_entries(), r.name))
        n = rep.seed_warm(donors[0].export_warm()) if donors else 0
        self.reseeded_entries += n
        self.respawns += 1
        self.event("respawn", replica=name, reseeded_entries=n,
                   warm=bool(n))
        self.live[name] = rep
        self.last_ok[name] = t
        self.born[name] = t
        self._dispatch(t)
        self._arm_health()

    # -- the scorecard --------------------------------------------------------

    def report(self) -> dict:
        reqs = list(self.requests.values())
        offered = len(reqs)
        shed = sum(1 for r in reqs if r.status == "shed")
        admitted = offered - shed
        done = [r for r in reqs if r.status == "done"]
        in_deadline = sum(1 for r in done if r.in_deadline)
        degraded_done = sum(1 for r in done if r.degraded)
        lat_ms = sorted(1e3 * r.latency_s for r in done)
        pct = (lambda p: round(float(np.percentile(lat_ms, p)), 3)) \
            if lat_ms else (lambda p: None)
        return {
            "offered": offered,
            "admitted": admitted,
            "shed": shed,
            "completed": len(done),
            "failed": sum(1 for r in reqs if r.status == "failed"),
            "in_deadline": in_deadline,
            "degraded_completed": degraded_done,
            "hedges": self.hedges,
            "retries": sum(r.retries for r in reqs),
            "evictions": self.evictions,
            "respawns": self.respawns,
            "reseeded_entries": self.reseeded_entries,
            "goodput": round(in_deadline / max(offered, 1), 6),
            "shed_rate": round(shed / max(offered, 1), 6),
            "degrade_rate": round(degraded_done / max(admitted, 1), 6),
            "slo_handled_rate": round(
                sum(1 for r in reqs if r.slo_handled) / max(admitted, 1), 6),
            "p50_ms": pct(50),
            "p99_ms": pct(99),
            "max_ms": round(lat_ms[-1], 3) if lat_ms else None,
            "sim_time_s": round(self.clock.time(), 6),
            "events": list(self.events),
        }


def poisson_arrivals(seed: int, *, n: int, rate_per_s: float,
                     t0: float = 0.0) -> list[tuple[float, None]]:
    """Seeded Poisson-process arrival schedule (exponential gaps) — the
    open-loop traffic model the reference's bench replays."""
    rng = seeded_rng(0xA881, seed)
    gaps = rng.exponential(1.0 / rate_per_s, size=n)
    t, out = t0, []
    for g in gaps:
        t += float(g)
        out.append((round(t, 6), None))
    return out
