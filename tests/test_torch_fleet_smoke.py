"""``chip_smoke.py`` phase 33, rehearsed on the CPU: ``chip_smoke.
fleet_phase`` over the port's CPU engine pair of reduced ResNet-50 (one
block a stage, 10 classes, 32 x 32; f32 and the calibrated int8 twin)
with the phase's schedule and checks (the SLO held, every policy
exercised, results bit for bit the engines', the padded lane, the
modelled replay), and the serving CLI in fleet mode with ``--smoke
--device cpu``; the card runs it on full ResNet-50 (K1 and K3)."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def engines():
    from repro_torch.graph import GxM, resnet50
    from repro_torch.graph.serving import CnnInferenceEngine

    def gxm():
        return GxM(resnet50(10, stages=(1, 1, 1, 1)), device="cpu",
                   num_classes=10)
    f32_gxm = gxm()
    params = f32_gxm.init(torch.Generator().manual_seed(0))
    f32 = CnnInferenceEngine(f32_gxm, params, image_hw=(32, 32),
                             max_batch=16)
    f32.warmup(autotune="off")
    q8 = CnnInferenceEngine(gxm(), params, image_hw=(32, 32), max_batch=16,
                            quantized=True)
    q8.warmup(autotune="off")
    return f32, q8


def test_phase_33_on_the_cpu(engines):
    f32, q8 = engines
    out = chip_smoke.fleet_phase("cpu", f32, q8,
                                 cli_args=("--smoke", "--device", "cpu"))
    rep = out["report"]
    assert rep["slo_handled_rate"] == 1.0
    assert min(rep["evictions"], rep["respawns"], rep["hedges"],
               rep["retries"], rep["degraded_completed"]) >= 1
    assert out["lane_bits"]
    assert out["cli"]["fleet"] == chip_smoke.FLEET_REPLICAS
