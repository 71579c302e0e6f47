"""The port's checkpointing and resilient loop (``train/checkpoint.py``,
``train/fault_tolerance.py``): the cases of the reference's
``tests/test_checkpoint.py`` on torch trees (round trip, GC, corruption,
async, walk-back, shape matching, the loop's recovery edge cases, the
heartbeat), and checkpoints crossing between the packages: one the
reference writes restores in the port and one the port writes restores in
the reference, with the same keys, files, shapes, dtypes, CRCs and values
(bf16 leaves through their uint16 bits)."""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as JC
from repro_torch.data import SyntheticLMData
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import checkpoint as C
from repro_torch.train.chaos import corrupt_latest, torn_checkpoint
from repro_torch.train.fault_tolerance import (Heartbeat, RebalancePlan,
                                               ResilientLoop)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g),
                       "b": torch.zeros((4,))},
            "opt": {"mu": {"w": torch.ones((8, 4)), "b": torch.ones((4,))},
                    "count": torch.tensor(7, dtype=torch.int32)},
            "step": torch.tensor(3, dtype=torch.int32)}


def _equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    C.save(tmp_path, 10, tree)
    out = C.restore(tmp_path, 10, tree)
    _equal(tree, out)
    assert out["step"].dtype == torch.int32


def test_latest_and_gc(tmp_path):
    tree = _tree()
    for s in (1, 2, 3, 4, 5):
        C.save(tmp_path, s, tree, keep=2)
    assert C.latest_step(tmp_path) == 5
    kept = sorted(p.name for p in pathlib.Path(tmp_path).iterdir())
    assert kept == ["step_4", "step_5"]


def test_corruption_detected(tmp_path):
    tree = _tree()
    path = C.save(tmp_path, 1, tree)
    manifest = json.loads((pathlib.Path(path) / "manifest.json").read_text())
    fname = next(iter(manifest["leaves"].values()))["file"]
    f = pathlib.Path(path) / fname
    raw = bytearray(f.read_bytes())
    raw[-1] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corruption"):
        C.restore(tmp_path, 1, tree)


def test_async_checkpointer(tmp_path):
    ac = C.AsyncCheckpointer(tmp_path)
    tree = _tree()
    ac.save(5, tree)
    tree["params"]["w"].add_(1.0)           # the snapshot was taken at save
    ac.wait()
    assert C.latest_step(tmp_path) == 5
    out = C.restore(tmp_path, 5, tree)
    assert torch.equal(out["params"]["w"], _tree()["params"]["w"])


def test_resilient_loop_recovers(tmp_path):
    """A failure mid-run restores the last checkpoint and ends in the same
    state as a run without it, bit for bit: the data is step-indexed."""
    data = SyntheticLMData(vocab=16, seq_len=4, global_batch=2)

    def step_fn(state, batch):
        s = state["x"] + torch.tensor(float(batch["tokens"].sum()))
        return {"x": s}, {"loss": s}

    fail_at = {17}

    def hook(step):
        if step in fail_at:
            fail_at.clear()
            raise RuntimeError("injected node failure")

    loop = ResilientLoop(step_fn=step_fn, state={"x": torch.tensor(0.0)},
                         data=data, ckpt_dir=tmp_path, ckpt_every=5,
                         failure_hook=hook)
    final = loop.run(25)
    assert loop.restarts == 1
    loop2 = ResilientLoop(step_fn=step_fn, state={"x": torch.tensor(0.0)},
                          data=data, ckpt_dir=str(tmp_path) + "_b",
                          ckpt_every=5)
    assert torch.equal(final["x"], loop2.run(25)["x"])


def test_all_steps_ignores_tmp_and_valid_steps_ignores_corrupt(tmp_path):
    tree = _tree()
    for s in (1, 2, 3):
        C.save(tmp_path, s, tree)
    (pathlib.Path(tmp_path) / ".tmp-step_4").mkdir()
    assert C.all_steps(tmp_path) == [1, 2, 3]
    assert C.latest_step(tmp_path) == 3
    assert corrupt_latest(tmp_path) == 3
    assert C.all_steps(tmp_path) == [1, 2, 3]
    assert C.valid_steps(tmp_path) == [1, 2]
    assert C.verify_checkpoint(tmp_path, 2)
    assert not C.verify_checkpoint(tmp_path, 3)
    assert not C.verify_checkpoint(tmp_path, 99)


def test_restore_latest_walks_back_past_corrupt_and_torn(tmp_path):
    t1, t2 = _tree(1), _tree(2)
    C.save(tmp_path, 1, t1)
    C.save(tmp_path, 2, t2)
    assert torn_checkpoint(tmp_path) == 3
    corrupt_latest(tmp_path)
    skipped = []
    out, step = C.restore_latest(tmp_path, t1,
                                 on_skip=lambda s, e: skipped.append(s))
    assert step == 2 and skipped == [3]
    _equal(t2, out)


def test_restore_latest_empty_dir_resumes_step0(tmp_path):
    template = _tree()
    out, step = C.restore_latest(tmp_path / "never_written", template)
    assert step == 0 and out is template


def test_restore_match_shapes_skips_pre_rescale_checkpoints(tmp_path):
    wide = {"residual": torch.ones((4, 3)), "step": torch.tensor(1)}
    narrow = {"residual": torch.full((2, 3), 2.0), "step": torch.tensor(2)}
    C.save(tmp_path, 1, wide)
    C.save(tmp_path, 2, narrow)
    with pytest.raises(ValueError, match="residual"):
        C.restore(tmp_path, 1, narrow, match_shapes=True)
    out, step = C.restore_latest(tmp_path, narrow)
    assert step == 2
    corrupt_latest(tmp_path)
    out, step = C.restore_latest(tmp_path, narrow)
    assert step == 0 and out is narrow


def test_async_checkpointer_stale_error_cleared(tmp_path):
    target = tmp_path / "ckpt"
    target.write_text("a file where the checkpoint dir should be")
    ac = C.AsyncCheckpointer(target)
    ac.save(1, _tree())
    with pytest.raises(Exception):
        ac.wait()
    ac.wait()
    target.unlink()
    ac.save(2, _tree())
    ac.wait()
    assert C.latest_step(target) == 2


def test_loop_survives_failure_during_inflight_async_save(tmp_path,
                                                          monkeypatch):
    real_save = C.save
    broken = {"on": True}

    def flaky_save(*a, **k):
        if broken["on"]:
            raise IOError("storage outage")
        return real_save(*a, **k)
    monkeypatch.setattr(C, "save", flaky_save)
    data = SyntheticLMData(vocab=16, seq_len=4, global_batch=2)
    fail_at = {7}

    def hook(step):
        if step in fail_at:
            fail_at.clear()
            raise RuntimeError("node failure mid-outage")

    loop = ResilientLoop(step_fn=lambda s, b: (s, {"loss": 0.0}), state={},
                         data=data, ckpt_dir=tmp_path, ckpt_every=5,
                         failure_hook=hook, io_backoff_s=0.0)
    loop.run(10)
    kinds = [e["kind"] for e in loop.events]
    assert "async_save_error" in kinds or "io_retry" in kinds
    restart = next(e for e in loop.events if e["kind"] == "restart")
    assert restart["restored_step"] == 0
    assert loop.io_retries_used > 0


def test_loop_max_retries_exhaustion_reraises(tmp_path):
    def hook(step):
        raise RuntimeError("persistent failure")

    loop = ResilientLoop(step_fn=lambda s, b: (s, {"loss": 0.0}), state={},
                         data=SyntheticLMData(vocab=16, seq_len=4,
                                              global_batch=2),
                         ckpt_dir=tmp_path, ckpt_every=5, max_retries=2,
                         failure_hook=hook)
    with pytest.raises(RuntimeError, match="persistent"):
        loop.run(10)
    assert loop.restarts == 3


def test_loop_restart_without_checkpoint_resumes_step0(tmp_path):
    seen = []
    fail_at = {3}

    def hook(step):
        if step in fail_at:
            fail_at.clear()
            raise RuntimeError("early failure, nothing saved yet")

    def step_fn(state, batch):
        seen.append(int(batch["tokens"][0, 0]))
        return state, {"loss": 0.0}

    data = SyntheticLMData(vocab=64, seq_len=4, global_batch=2)
    loop = ResilientLoop(step_fn=step_fn, state={}, data=data,
                         ckpt_dir=tmp_path, ckpt_every=100, failure_hook=hook)
    loop.run(5)
    assert loop.lost_steps == 3
    want = [int(data.batch_at(s)["tokens"][0, 0]) for s in
            [0, 1, 2] + [0, 1, 2, 3, 4]]
    assert seen == want


def test_loop_restore_step_and_data_cursor_agree(tmp_path):
    steps_seen = []
    fail_at = {7}

    def hook(step):
        if step in fail_at:
            fail_at.clear()
            raise RuntimeError("fail between checkpoints")

    class CursorData:
        def batch_at(self, step):
            return {"step": step}

    def step_fn(state, batch):
        steps_seen.append(batch["step"])
        return {"x": torch.tensor(float(batch["step"]))}, {"loss": 0.0}

    loop = ResilientLoop(step_fn=step_fn, state={"x": torch.tensor(0.0)},
                         data=CursorData(), ckpt_dir=tmp_path, ckpt_every=5,
                         failure_hook=hook)
    loop.run(10)
    assert steps_seen == [0, 1, 2, 3, 4, 5, 6, 5, 6, 7, 8, 9]
    assert loop.lost_steps == 2


def test_loop_non_writer_saves_nothing_but_snapshots(tmp_path):
    """A rank that takes part in the snapshot (a collective, under data
    parallelism) but is not the writer leaves the directory empty."""
    snaps = []
    loop = ResilientLoop(step_fn=lambda s, b: (s, {"loss": 0.0}),
                         state={"x": torch.tensor(1.0)},
                         data=SyntheticLMData(vocab=16, seq_len=4,
                                              global_batch=2),
                         ckpt_dir=tmp_path, ckpt_every=2, writer=False,
                         snapshot_fn=lambda s: snaps.append(1) or s)
    loop.run(6)
    assert len(snaps) == 3 and C.all_steps(tmp_path) == []


def test_heartbeat_straggler_detection():
    hb = Heartbeat(window=10, threshold=1.5)
    for _ in range(10):
        for h in ("h0", "h1", "h2", "h3"):
            hb.record(h, 1.0 if h != "h2" else 3.0)
    assert hb.stragglers() == ["h2"]
    plan = RebalancePlan.from_heartbeat(hb, ["h0", "h1", "h2", "h3"])
    assert plan.shares["h2"] < plan.shares["h0"]
    assert abs(sum(plan.shares.values()) - 1.0) < 1e-9


def test_heartbeat_medians_clock_and_ping():
    t = {"now": 100.0}
    hb = Heartbeat(window=4, timeout_s=10.0, clock=lambda: t["now"])
    hb.record("h0", 1.0)
    hb.record("h1", 2.0, now=100.0)
    assert hb.medians() == {"h0": 1.0, "h1": 2.0}
    t["now"] = 109.0
    assert hb.dead() == []
    t["now"] = 111.0
    assert sorted(hb.dead()) == ["h0", "h1"]
    hb.ping("h0")
    assert hb.dead() == ["h1"] and hb.medians()["h0"] == 1.0
    hb.forget("h1")
    assert hb.dead() == [] and "h1" not in hb.medians()
    plan = RebalancePlan.from_heartbeat(hb, ["h0", "h9"])
    assert plan.shares["h9"] > 0
    assert abs(sum(plan.shares.values()) - 1.0) < 1e-9


# -- between the packages -----------------------------------------------------

def _mixed_numpy(seed=0):
    import ml_dtypes
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((8, 4)).astype(np.float32),
                       "emb": rng.standard_normal((6, 3)).astype(
                           ml_dtypes.bfloat16)},
            "residual": {"w": rng.standard_normal((2, 8, 4)).astype(
                np.float32)},
            "step": np.int32(5)}


def _manifest(path):
    return json.loads((pathlib.Path(path) / "manifest.json").read_text())


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref_tree = _mixed_numpy()
    path = JC.save(tmp_path, 3, jax.tree.map(jnp.asarray, ref_tree))
    m = _manifest(path)
    assert set(m["leaves"]) == {"params/w", "params/emb", "residual/w",
                                "step"}
    template = {"params": {"w": torch.zeros(8, 4),
                           "emb": torch.zeros(6, 3, dtype=torch.bfloat16)},
                "residual": {"w": torch.zeros(2, 8, 4)},
                "step": torch.tensor(0, dtype=torch.int32)}
    assert C.verify_checkpoint(tmp_path, 3)
    out, step = C.restore_latest(tmp_path, template)
    assert step == 3
    assert out["params"]["emb"].dtype == torch.bfloat16
    assert np.array_equal(out["params"]["emb"].view(torch.uint16).numpy(),
                          ref_tree["params"]["emb"].view(np.uint16))
    assert np.array_equal(out["params"]["w"].numpy(), ref_tree["params"]["w"])
    assert np.array_equal(out["residual"]["w"].numpy(),
                          ref_tree["residual"]["w"])
    assert int(out["step"]) == 5 and out["step"].dtype == torch.int32


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    ref_tree = _mixed_numpy(1)
    ours = {"params": {"w": torch.from_numpy(ref_tree["params"]["w"]),
                       "emb": torch.from_numpy(ref_tree["params"]["emb"].view(
                           np.uint16)).view(torch.bfloat16)},
            "residual": {"w": torch.from_numpy(ref_tree["residual"]["w"])},
            "step": torch.tensor(5, dtype=torch.int32)}
    ours_path = C.save(tmp_path / "port", 7, ours)
    ref_path = JC.save(tmp_path / "ref", 7, jax.tree.map(jnp.asarray,
                                                         ref_tree))
    mo, mr = _manifest(ours_path), _manifest(ref_path)
    # keys, files, shapes, dtype names and CRCs are the reference's
    assert mo == mr
    out = JC.restore(tmp_path / "port", 7,
                     jax.tree.map(jnp.asarray, ref_tree))
    assert np.array_equal(np.asarray(out["params"]["w"]),
                          ref_tree["params"]["w"])
    assert np.array_equal(np.asarray(out["residual"]["w"]),
                          ref_tree["residual"]["w"])
    assert np.asarray(out["params"]["emb"]).view(np.uint16).tobytes() == \
        ref_tree["params"]["emb"].view(np.uint16).tobytes()
    assert int(out["step"]) == 5
    # and the reference walks back over a corrupted port checkpoint
    corrupt_latest(tmp_path / "port")
    with pytest.raises(IOError, match="corruption"):
        JC.restore(tmp_path / "port", 7, jax.tree.map(jnp.asarray, ref_tree))
