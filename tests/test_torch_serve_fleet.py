"""The port's serving fleet (``repro_torch.serve``) against the JAX
package's (``repro.serve``): the seeded arrivals and chaos schedules draw
the reference's exact floats, and every scenario of the reference's
``tests/test_serve_fleet.py`` gives the reference's report, events
included, with modelled requests.  Then a real-engine fleet on the port's
CPU engines (reduced ResNet-50, 32x32): the reference test's degrade flip,
top-1 and padded-lane checks on the port's own engine pair (the JAX
engine's ``mesh=`` path fails on the installed jax, so it cannot be the
oracle there), and ``run_fleet`` through the serving CLI."""
import json

import numpy as np
import pytest
import torch

import repro.serve as ref
import repro_torch.serve as port
from repro.tune.cache import TuneCache as RefCache
from repro_torch.tune.cache import TuneCache as PortCache

SEEDS = range(12)


def _events(schedule):
    return [(type(e).__name__, dataclass_fields(e)) for e in schedule.events]


def dataclass_fields(e):
    return tuple(sorted(vars(e).items()))


@pytest.mark.parametrize("seed", SEEDS)
def test_poisson_arrivals_equal_the_reference(seed):
    for n, rate in ((30, 1.5), (7, 0.25), (200, 40.0)):
        assert port.poisson_arrivals(seed, n=n, rate_per_s=rate, t0=1.0) \
            == ref.poisson_arrivals(seed, n=n, rate_per_s=rate, t0=1.0)


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_schedule_equals_the_reference(seed):
    for kw in (dict(horizon_s=200.0, replicas=["r0", "r1", "r2"]),
               dict(horizon_s=15.0, replicas=["r0", "r1", "r2", "r3"]),
               dict(horizon_s=400.0, replicas=["a", "b"], intensity=2.0,
                    kinds=("death", "flaky"))):
        a = port.ServeChaosSchedule.generate(seed, **kw)
        b = ref.ServeChaosSchedule.generate(seed, **kw)
        assert _events(a) == _events(b) and a.seed == b.seed


def test_chaos_engine_queries_equal_the_reference():
    def events(lib):
        return (lib.SlowReplica(5.0, "r1", factor=3.0, until=10.0),
                lib.FlakyInfer(20.0, "r0", times=2),
                lib.ReplicaDeath(10.0, "r2"), lib.RequestBurst(3.0, 5))
    a = port.ServeChaosEngine(port.ServeChaosSchedule(events(port)))
    b = ref.ServeChaosEngine(ref.ServeChaosSchedule(events(ref)))
    for t in (0.0, 4.0, 7.0, 10.0, 19.0, 21.0, 22.0, 23.0, 50.0):
        for r in ("r0", "r1", "r2"):
            assert a.slow_factor(r, t) == b.slow_factor(r, t)
            assert a.is_dead(r, t) == b.is_dead(r, t)
            assert a.is_dead(r, t, born=20.0) == b.is_dead(r, t, born=20.0)
            assert (a.take_infer_fault(r, t) is None) \
                == (b.take_infer_fault(r, t) is None)
    assert a.injected == b.injected
    assert a.death_times() == b.death_times()
    assert [(x.t, x.n) for x in a.bursts()] == [(x.t, x.n) for x in b.bursts()]


# -- the modelled fleet, scenario by scenario ---------------------------------

def _fleet(lib, cache_cls, n=3, tmp_path=None, warm=6, tag=""):
    def make(name, *, seed_warm=True):
        cache = None
        if tmp_path is not None:
            cache = cache_cls(str(tmp_path / f"{tag}{name}.json"))
            if seed_warm:
                cache.merge_entries(
                    {f"sig{i}": {"blocking": {"hb": 4}, "source": "t",
                                 "score_us": 1.0} for i in range(warm)},
                    persist=False)
        return lib.Replica(name, cache=cache, service_s=1.0,
                           cold_service_s=3.0 if cache is not None else 0.0)
    return [make(f"r{i}") for i in range(n)], \
        lambda name: make(name, seed_warm=False)


def _fault_free(lib, cache_cls, tmp_path):
    replicas, _ = _fleet(lib, cache_cls)
    return lib.FleetRouter(replicas, deadline_s=6.0), 30


def _deterministic(lib, cache_cls, tmp_path):
    replicas, _ = _fleet(lib, cache_cls)
    chaos = lib.ServeChaosEngine(lib.ServeChaosSchedule((
        lib.SlowReplica(3.0, "r1", factor=4.0, until=12.0),
        lib.FlakyInfer(6.0, "r2"), lib.RequestBurst(9.0, 8))))
    return lib.FleetRouter(replicas, chaos=chaos, deadline_s=6.0), 30


def _warm_respawn(lib, cache_cls, tmp_path):
    replicas, factory = _fleet(lib, cache_cls, tmp_path=tmp_path,
                               tag=lib.__name__)
    chaos = lib.ServeChaosEngine(lib.ServeChaosSchedule((
        lib.ReplicaDeath(5.0, "r1"),)))
    return lib.FleetRouter(replicas, chaos=chaos, deadline_s=8.0,
                           replica_factory=factory), 40


def _cold_respawn(lib, cache_cls, tmp_path):
    """A death with a factory whose respawn finds no survivor cache to
    seed from (every replica cacheless but charged a cold start)."""
    def make(name):
        return lib.Replica(name, cache=cache_cls(
            str(tmp_path / f"{lib.__name__}cold{name}.json")),
            service_s=1.0, cold_service_s=3.0)
    replicas = [make(f"r{i}") for i in range(3)]
    chaos = lib.ServeChaosEngine(lib.ServeChaosSchedule((
        lib.ReplicaDeath(4.0, "r2"),)))
    return lib.FleetRouter(replicas, chaos=chaos, deadline_s=8.0,
                           replica_factory=make), 40


def _hedging(lib, cache_cls, tmp_path):
    replicas, _ = _fleet(lib, cache_cls)
    chaos = lib.ServeChaosEngine(lib.ServeChaosSchedule((
        lib.SlowReplica(0.0, "r1", factor=10.0),)))
    return lib.FleetRouter(replicas, chaos=chaos, deadline_s=6.0,
                           hedge_after_s=1.5), 20


def _flaky_retry(lib, cache_cls, tmp_path):
    replicas, _ = _fleet(lib, cache_cls)
    chaos = lib.ServeChaosEngine(lib.ServeChaosSchedule((
        lib.FlakyInfer(0.0, "r0", times=2),)))
    return lib.FleetRouter(replicas, chaos=chaos, deadline_s=6.0), 10


def _bounded_retries(lib, cache_cls, tmp_path):
    replicas, _ = _fleet(lib, cache_cls, n=2)
    chaos = lib.ServeChaosEngine(lib.ServeChaosSchedule(
        tuple(lib.FlakyInfer(0.0, f"r{i}", times=50) for i in range(2))))
    return lib.FleetRouter(replicas, chaos=chaos, deadline_s=30.0,
                           max_retries=2, hedge_after_s=None), 0


def _shed_and_degrade(lib, cache_cls, tmp_path):
    replicas, _ = _fleet(lib, cache_cls)
    chaos = lib.ServeChaosEngine(lib.ServeChaosSchedule((
        lib.RequestBurst(5.0, 60),)))
    return lib.FleetRouter(replicas, chaos=chaos, deadline_s=6.0,
                           queue_bound=20), 30


def _degrade_disabled(lib, cache_cls, tmp_path):
    replicas, _ = _fleet(lib, cache_cls)
    chaos = lib.ServeChaosEngine(lib.ServeChaosSchedule((
        lib.RequestBurst(5.0, 40),)))
    return lib.FleetRouter(replicas, chaos=chaos, deadline_s=6.0,
                           queue_bound=100, degrade=False), 20


def _seeded_chaos(lib, cache_cls, tmp_path):
    """``run_fleet``'s shape: four replicas, a respawning factory and a
    generated schedule over the arrivals' horizon."""
    names = [f"r{i}" for i in range(4)]
    arrivals = lib.poisson_arrivals(0, n=24, rate_per_s=1.5)
    schedule = lib.ServeChaosSchedule.generate(
        3, horizon_s=max(t for t, _ in arrivals), replicas=names,
        intensity=8.0)
    make = lambda name: lib.Replica(name)  # noqa: E731
    return lib.FleetRouter([make(n) for n in names],
                           chaos=lib.ServeChaosEngine(schedule),
                           replica_factory=make), 24


SCENARIOS = {"fault_free": _fault_free, "bit_determinism": _deterministic,
             "warm_respawn": _warm_respawn, "cold_respawn": _cold_respawn,
             "hedging": _hedging, "flaky_retry": _flaky_retry,
             "bounded_retries": _bounded_retries,
             "shed_and_degrade": _shed_and_degrade,
             "degrade_disabled": _degrade_disabled,
             "seeded_chaos": _seeded_chaos}


def _run(lib, cache_cls, scenario, tmp_path):
    router, n = SCENARIOS[scenario](lib, cache_cls, tmp_path)
    arrivals = [(0.0, None)] if n == 0 else \
        lib.poisson_arrivals(0, n=n, rate_per_s=1.5)
    return router, router.run(arrivals)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_fleet_report_equals_the_reference(scenario, tmp_path):
    """The whole report, events included, as JSON: every counter, rate,
    latency percentile and event of the port's router equals the
    reference's."""
    router, got = _run(port, PortCache, scenario, tmp_path)
    _, want = _run(ref, RefCache, scenario, tmp_path)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    again = _run(port, PortCache, scenario, tmp_path / "again")[1] \
        if scenario != "bit_determinism" else got
    assert again == got
    assert all(r.status in ("done", "shed", "failed")
               for r in router.requests.values())


def test_the_reference_scenarios_hold_on_the_port(tmp_path):
    """The reference test's own assertions on the port's reports."""
    _, rep = _run(port, PortCache, "fault_free", tmp_path)
    assert rep["offered"] == rep["completed"] == rep["in_deadline"] == 30
    assert rep["evictions"] == rep["hedges"] == rep["retries"] == 0
    router, rep = _run(port, PortCache, "warm_respawn", tmp_path)
    assert rep["evictions"] == 1 and rep["respawns"] == 1
    assert rep["reseeded_entries"] == 6
    assert router.live["r1"].warm_entries() == 6 and router.born["r1"] > 5.0
    assert rep["failed"] == 0 and rep["slo_handled_rate"] == 1.0
    router, rep = _run(port, PortCache, "hedging", tmp_path)
    assert rep["hedges"] > 0 and rep["goodput"] == 1.0
    assert any(e["kind"] == "hedge_cancel" for e in rep["events"])
    router, rep = _run(port, PortCache, "flaky_retry", tmp_path)
    assert rep["retries"] == 2 and rep["failed"] == 0
    assert [e["delay_s"] for e in rep["events"]
            if e["kind"] == "retry_backoff"] == [0.25, 0.25]
    for r in router.requests.values():
        if r.retries:
            assert r.dispatches[-1][0] not in r.avoid
    _, rep = _run(port, PortCache, "bounded_retries", tmp_path)
    assert rep["failed"] == 1 and rep["retries"] == 3
    _, rep = _run(port, PortCache, "shed_and_degrade", tmp_path)
    assert rep["shed"] > 0 and rep["degraded_completed"] > 0
    assert rep["slo_handled_rate"] == 1.0
    _, off = _run(port, PortCache, "degrade_disabled", tmp_path)
    assert off["degraded_completed"] == 0 and off["slo_handled_rate"] < 1.0
    replicas, factory = _fleet(port, PortCache, tmp_path=tmp_path,
                               tag="cold")
    cold = factory("rX")
    assert cold.service_time() == 1.0 + 3.0
    cold.seed_warm(replicas[0].export_warm())
    assert cold.service_time() == 1.0


# -- the real-engine fleet on the port's CPU engines -------------------------

@pytest.fixture(scope="module")
def engine_pair():
    from repro_torch.graph import GxM, resnet50
    from repro_torch.graph.serving import CnnInferenceEngine

    def gxm():
        return GxM(resnet50(10, stages=(1, 1, 1, 1)), device="cpu",
                   num_classes=10)
    f32_gxm = gxm()
    params = f32_gxm.init(torch.Generator().manual_seed(0))
    f32 = CnnInferenceEngine(f32_gxm, params, image_hw=(32, 32),
                             buckets=(2,))
    f32.warmup(autotune="off")
    q8 = CnnInferenceEngine(gxm(), params, image_hw=(32, 32), buckets=(2,),
                            quantized=True)
    q8.warmup(autotune="off")
    return params, f32, q8


def test_real_fleet_degrade_flip_keeps_top1_and_lane_invariance(engine_pair,
                                                                rng):
    """The reference test's checks on the port's engines: a request the
    router flips to the int8 twin mid-burst agrees with the f32 forward on
    top-1; every other result is the f32 engine's bits; a flipped
    request's result is the twin's bits alone and beside a junk lane."""
    params, f32, q8 = engine_pair
    replicas = [port.Replica(f"r{i}", infer_fn=f32.infer,
                             q8_infer_fn=q8.infer, service_s=1.0)
                for i in range(2)]
    images = rng.standard_normal((10, 32, 32, 3)).astype(np.float32)
    chaos = port.ServeChaosEngine(port.ServeChaosSchedule((
        port.RequestBurst(0.5, 6),)))
    router = port.FleetRouter(replicas, chaos=chaos, deadline_s=3.0,
                              queue_bound=64, slo_depth=2,
                              burst_image_fn=lambda i: images[4 + i])
    rep = router.run([(0.1 * i, images[i]) for i in range(4)])
    assert rep["completed"] == rep["offered"] == 10
    assert rep["degraded_completed"] > 0, "the burst never forced a degrade"
    assert rep["slo_handled_rate"] == 1.0
    # the same arrivals as modelled requests: the router's decisions do
    # not depend on the engines
    modelled = port.FleetRouter(
        [port.Replica(f"r{i}", service_s=1.0) for i in range(2)],
        chaos=port.ServeChaosEngine(port.ServeChaosSchedule((
            port.RequestBurst(0.5, 6),))),
        deadline_s=3.0, queue_bound=64, slo_depth=2)
    assert modelled.run([(0.1 * i, None) for i in range(4)]) == rep

    with torch.no_grad():
        forward = f32.gxm.infer(params, torch.from_numpy(images)).numpy()
    for req in router.requests.values():
        assert isinstance(req.result, np.ndarray)
        idx = next(i for i, img in enumerate(images)
                   if np.array_equal(img, req.image))
        assert int(np.argmax(req.result)) == int(np.argmax(forward[idx])), \
            (idx, req.degraded)
        if not req.degraded:
            np.testing.assert_array_equal(
                req.result, f32.infer(req.image[None]).numpy()[0])
    flipped = next(r for r in router.requests.values() if r.degraded)
    solo = q8.infer(np.asarray(flipped.image)[None]).numpy()[0]
    np.testing.assert_array_equal(solo, flipped.result)
    junk = 100 * rng.standard_normal((32, 32, 3)).astype(np.float32)
    padded = q8.gxm.infer(q8.qparams, torch.from_numpy(
        np.stack([flipped.image, junk])))
    np.testing.assert_array_equal(padded[0].numpy(), flipped.result)


def test_run_fleet_through_the_cli(capsys):
    from repro_torch.launch import serve_cnn
    summary = serve_cnn.main(["--smoke", "--fleet", "2", "--device", "cpu",
                              "--autotune", "off", "--fleet-chaos-seed",
                              "3", "--requests", "12"])
    assert summary["fleet"] == 2 and summary["offered"] >= 12
    assert summary["slo_handled_rate"] == 1.0
    assert summary["completed"] + summary["shed"] + summary["failed"] \
        == summary["offered"]
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == summary
