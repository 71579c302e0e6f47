"""``chip_smoke.py`` phase 34's rank body, rehearsed on the CPU: two gloo
ranks (one process each, a ``file://`` store under ``tmp_path``, one
deadline of 300 s) run ``chip_smoke.zero3_rank`` with the smoke widths of
``qwen3-8b`` in bf16 for part (a) and the phase's checks: ZeRO-3 against
the whole-parameter data-parallel step (the first loss the same bits, the
update within 1e-2 of max |update|, at most 0.55 of the held bytes), the
reduced f32 step against one device within 1e-6 with the checkpoint
round trip bit for bit, and reduced Phi-3.5-MoE against one device with
the routing pinned.  The card runs it at the published widths."""
import os

from repro_torch.launch.ranks import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase_34_rank_body_on_the_cpu(tmp_path):
    workdir = str(tmp_path / "ranks")
    results, logs = run_ranks(
        "chip_smoke:zero3_rank", 2, workdir=workdir,
        args=dict(workdir=workdir, device="cpu", full=False),
        timeout_s=300.0,
        env={"PYTHONPATH": os.pathsep.join([os.path.join(ROOT, "src"),
                                             ROOT])})
    for rank, res in enumerate(results):
        assert res["backend"] == "gloo"
        assert res["mesh"] == {"data": 2, "model": 1}
        a = res["a"]
        assert a["losses"][0] == a["dp_loss"]
        assert a["held_share"] <= 0.55 and a["update_rel"] <= 1e-2
        assert len(a["step_ms"]) == 2
        assert a["gather_ms"] > 0 and a["gather_bytes"] > 0
        assert a["reduce_ms"] > 0 and a["reduce_bytes"] > 0
        assert res["b"]["update_rel"] <= 1e-6 and res["b"]["ckpt_bits"]
        assert res["c"]["loss_rel"] <= 1e-5
        assert res["c"]["routing"][0] <= 2
        assert "(c) " in logs[rank]
