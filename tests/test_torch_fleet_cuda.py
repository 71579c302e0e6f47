"""The serving fleet on the card: ``serve.FleetRouter`` over replicas
sharing a reduced ResNet-50 engine pair (one block a stage, 10 classes,
32 x 32; f32 through K1 and the calibrated int8 twin through K3) under a
fault schedule with a death, a straggler, flaky dispatches and a burst.
Every result is the bits of ``engine.infer`` of its image alone (the f32
engine's, or the twin's for a degraded request), K1 and K3 launch once a
lane-aligned conv of each f32 and each degraded completion, and the report
equals the modelled replay's.

These need an NVIDIA GPU with ``nvcc``; elsewhere they skip.  On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_fleet_cuda.py
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def test_fleet_results_are_the_engines_bits_on_the_card(cuda):
    from repro_torch.core.conv import lane_ok
    from repro_torch.graph import GxM, resnet50
    from repro_torch.graph.serving import CnnInferenceEngine
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.kernels import conv2d_q8 as k3
    from repro_torch.serve import (FlakyInfer, FleetRouter, Replica,
                                   ReplicaDeath, RequestBurst,
                                   ServeChaosEngine, ServeChaosSchedule,
                                   SlowReplica, poisson_arrivals)

    def gxm():
        return GxM(resnet50(10, stages=(1, 1, 1, 1)), device="cuda",
                   num_classes=10)
    f32_gxm = gxm()
    params = f32_gxm.init(torch.Generator().manual_seed(0))
    f32 = CnnInferenceEngine(f32_gxm, params, image_hw=(32, 32),
                             max_batch=4)
    f32.warmup(autotune="off")
    q8 = CnnInferenceEngine(gxm(), params, image_hw=(32, 32), max_batch=4,
                            quantized=True)
    q8.warmup(autotune="off")
    per_fwd = sum(1 for t in f32_gxm.etg.tasks if t.op == "conv"
                  and lane_ok(t.attrs["c"], t.attrs["k"]))
    rng = np.random.default_rng(0)
    images = rng.standard_normal((20, 32, 32, 3)).astype(np.float32)
    arrivals = poisson_arrivals(0, n=14, rate_per_s=1.5)
    schedule = ServeChaosSchedule((
        ReplicaDeath(2.0, "r1"), SlowReplica(1.0, "r2", factor=3.0,
                                             until=7.0),
        FlakyInfer(1.5, "r0"), RequestBurst(4.0, 6)))

    def router(real):
        def make(name):
            return Replica(name, infer_fn=f32.infer if real else None,
                           q8_infer_fn=q8.infer if real else None)
        return FleetRouter([make(f"r{i}") for i in range(3)],
                           chaos=ServeChaosEngine(schedule), deadline_s=3.0,
                           replica_factory=make,
                           burst_image_fn=(lambda i: images[14 + i])
                           if real else None)
    real = router(True)
    k1.launches = k3.launches = 0
    rep = real.run([(t, images[i]) for i, (t, _) in enumerate(arrivals)])
    torch.cuda.synchronize()
    done = [r for r in real.requests.values() if r.status == "done"]
    degraded = [r for r in done if r.degraded]
    assert rep["slo_handled_rate"] == 1.0 and degraded
    assert k1.launches == per_fwd * (len(done) - len(degraded))
    assert k3.launches == per_fwd * len(degraded)
    assert rep == router(False).run(arrivals)
    for r in done:
        engine = q8 if r.degraded else f32
        want = engine.infer(r.image[None]).cpu().numpy()[0]
        np.testing.assert_array_equal(r.result, want)
