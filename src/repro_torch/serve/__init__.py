"""Resilient serving fleet over the port's GxM inference engine, the
counterpart of ``repro/serve``: ``FleetRouter`` + ``Replica`` (deadlines,
retries, hedging, eviction + warm-cache respawn, load shed,
degrade-to-int8) and the seeded ``ServeChaosEngine`` fault harness that
replays against it."""
from repro_torch.serve.chaos import (FlakyInfer, ReplicaDeath, RequestBurst,
                                     ServeChaosEngine, ServeChaosSchedule,
                                     SlowReplica)
from repro_torch.serve.fleet import (FleetRouter, Replica, Request,
                                     poisson_arrivals)

__all__ = [
    "FlakyInfer", "FleetRouter", "Replica", "ReplicaDeath", "Request",
    "RequestBurst", "ServeChaosEngine", "ServeChaosSchedule", "SlowReplica",
    "poisson_arrivals",
]
