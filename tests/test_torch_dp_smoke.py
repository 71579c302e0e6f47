"""``chip_smoke.py`` phase 32's rank body, rehearsed on the CPU: two gloo
ranks (one process each, a ``file://`` store under ``tmp_path``, one
deadline of 300 s) run ``chip_smoke.dp_rank`` on the reference tests'
tiny ResNet at 32 x 32 with the phase's checks (identical shards bit for
bit, distinct shards, the int8 formula and its mass, the checkpoint, the
chaos replay, the 2 -> 1 fold, the LM step), so the phase's logic is
exercised without the card; the card runs it on full ResNet-50."""
import os

from repro_torch.launch.ranks import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase_32_rank_body_on_the_cpu(tmp_path):
    workdir = str(tmp_path / "ranks")
    results, logs = run_ranks(
        "chip_smoke:dp_rank", 2, workdir=workdir,
        args=dict(workdir=workdir, device="cpu", full=False, image=32,
                  classes=10),
        timeout_s=300.0,
        env={"PYTHONPATH": os.pathsep.join([os.path.join(ROOT, "src"),
                                             ROOT])})
    for rank, res in enumerate(results):
        assert res["backend"] == "gloo"
        assert res["distinct"]["bits_equal"]
        assert res["int8"]["mass_rel"] <= 1e-6
        assert res["resilience"]["skipped"] == [4]
        assert res["resilience"]["restarts"] == 1
        assert res["lm"]["loss_rel"] <= 1e-4
        assert res["wire_bytes"]["int8"] > res["wire_bytes"]["f32"]
        assert ("elastic" in res) == (rank == 0)
        assert "params equal bit for bit True" in logs[rank]
