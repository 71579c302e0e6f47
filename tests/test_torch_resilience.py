"""The port's resilience: ``core/simtime``, ``train/chaos``,
``train/fault_tolerance`` and ``core/wu_strategy`` against the JAX
package's, and the data-parallel path under them.

``SimClock``, ``seeded_rng`` and ``ChaosSchedule.generate`` draw the
reference's numbers for several seeds (numpy ``Generator``s on both
sides); the resilient loop survives the whole fault vocabulary (the
reference's synthetic run); the ChaosEngine's per-fault mechanics; the
reference's chaos tests drive its ``make_cnn_train_step_dp``, which the
installed jax refuses (``shard_map(check_rep=)``), so the restart replay
is held inside the port: two CPU ranks (gloo) run the data-parallel int8
CNN step through ``ResilientLoop`` uninterrupted and under a corrupted
newest checkpoint plus a step fault, and end bit for bit equal; an elastic
4 -> 2 re-scale of a checkpointed residual keeps its mass; the §II-J dW
policy equals the reference's over a sweep."""
import itertools

import numpy as np
import pytest
import torch

from _dp_ranks import spawn
from repro.core import simtime as jax_simtime
from repro.core import wu_strategy as jax_wu
from repro.train import chaos as jax_chaos
from repro_torch.core import simtime, wu_strategy
from repro_torch.optim.compress import fold_residual
from repro_torch.train import chaos as cz
from repro_torch.train import checkpoint as C
from repro_torch.train.fault_tolerance import ResilientLoop
from test_torch_train_dp import _tree


def _as_tuple(ev):
    return (type(ev).__name__, *vars(ev).values())


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_schedule_and_rng_equal_the_reference(seed):
    for hosts, n_steps, intensity in ((["host0"], 50, 1.0),
                                      ([f"host{i}" for i in range(6)], 500,
                                       1.0),
                                      (["host0", "host1", "host2"], 2000,
                                       5.0)):
        got = cz.ChaosSchedule.generate(seed, n_steps=n_steps, hosts=hosts,
                                        intensity=intensity)
        exp = jax_chaos.ChaosSchedule.generate(seed, n_steps=n_steps,
                                               hosts=hosts,
                                               intensity=intensity)
        assert [_as_tuple(e) for e in got.events] == \
            [_as_tuple(e) for e in exp.events]
        assert got.seed == exp.seed == seed
    a = simtime.seeded_rng(seed, 3, 9)
    b = jax_simtime.seeded_rng(seed, 3, 9)
    assert np.array_equal(a.integers(0, 1 << 30, 64),
                          b.integers(0, 1 << 30, 64))
    assert np.array_equal(a.random(16), b.random(16))


def test_simclock_equals_the_reference():
    ours, ref = simtime.SimClock(), jax_simtime.SimClock()
    for op, v in (("sleep", 3.5), ("advance", 1.25), ("advance_to", 2.0),
                  ("advance_to", 10.0), ("sleep", 0.1)):
        getattr(ours, op)(v)
        getattr(ref, op)(v)
        assert ours.time() == ref.time()
    assert cz.SimClock is simtime.SimClock


def test_schedule_never_kills_host0_or_empties_fleet():
    for seed in range(20):
        sched = cz.ChaosSchedule.generate(seed, n_steps=2000,
                                          hosts=["host0", "host1", "host2"],
                                          intensity=5.0)
        deaths = [e for e in sched.events if isinstance(e, cz.HostDeath)]
        assert all(d.host != "host0" for d in deaths)
        assert len(deaths) <= 2
        assert len({d.host for d in deaths}) == len(deaths)


def test_step_fault_fires_exactly_once(tmp_path):
    eng = cz.ChaosEngine(cz.ChaosSchedule((cz.StepFault(2, cost_s=0.5),)),
                         hosts=["host0"], ckpt_dir=tmp_path)
    eng.failure_hook(0)
    with pytest.raises(cz.ChaosError, match="injected step fault"):
        eng.failure_hook(2)
    eng.failure_hook(3)
    assert eng.clock.time() == 0.5


def test_checkpoint_attacks_only_on_the_writer(tmp_path):
    C.save(tmp_path, 2, {"x": torch.ones(3)})
    for writer in (False, True):
        eng = cz.ChaosEngine(cz.ChaosSchedule((cz.CorruptCheckpoint(1),
                                               cz.FlakySaves(1))),
                             hosts=["host0"], ckpt_dir=tmp_path,
                             writer=writer)
        eng.failure_hook(1)
        assert C.valid_steps(tmp_path) == ([2] if not writer else [])
        assert eng.take_save_fault() == writer


def test_synthetic_loop_survives_full_fault_vocabulary(tmp_path):
    """Every fault kind in one run over a trivial state: the loop finishes
    every step, evicts the dead host and the straggler, retries the flaky
    saves, and never needs an operator."""
    hosts = [f"host{i}" for i in range(4)]
    sched = cz.ChaosSchedule((
        cz.StepFault(5),
        cz.SlowHost(10, "host2", factor=4.0),
        cz.HostDeath(20, "host3"),
        cz.CorruptCheckpoint(28),
        cz.FlakySaves(33, times=2),
        cz.TornCheckpoint(36),
    ))
    eng = cz.ChaosEngine(sched, hosts=hosts, ckpt_dir=tmp_path)

    def step_fn(state, batch):
        return state + batch, {"loss": 0.0}

    class Data:
        def batch_at(self, step):
            return float(step)

    loop = ResilientLoop(step_fn=step_fn, state=0.0, data=Data(),
                         ckpt_dir=tmp_path, ckpt_every=10, policy_every=5,
                         min_hosts=2, chaos=eng,
                         heartbeat=eng.make_heartbeat())
    loop.run(50)
    s = loop.resilience_summary()
    assert s["evictions"] == 2 and sorted(loop.alive) == ["host0", "host1"]
    assert s["restarts"] >= 2
    assert s["io_retries"] == 2
    kinds = {e["kind"] for e in loop.events}
    assert {"step_failure", "eviction", "io_retry"} <= kinds
    assert 50.0 / eng.clock.time() > 0.5


def test_chaos_restart_replay_is_bit_identical(tmp_path):
    """Two ranks, the int8 data-parallel step, checkpoints every 2 steps:
    at step 5 the newest checkpoint (step 4) is corrupted and the step
    faults; both ranks walk back to step 2, replay, and end with the state
    of the uninterrupted run, bit for bit."""
    _, tree = _tree()
    results = spawn("chaos_replay_rank", 2, tmp_path, tree=tree,
                    ckpt_root=str(tmp_path / "ckpt"), steps=6)
    for res in results:
        clean, hit = res["clean"], res["chaos"]
        assert hit["summary"]["restarts"] == 1
        assert hit["summary"]["lost_steps"] == 3
        assert hit["skipped"] == [4]
        assert clean["step"] == hit["step"] == 6
        for name, p in clean["params"].items():
            for leaf, v in p.items():
                assert np.array_equal(hit["params"][name][leaf], v)
        for name, p in clean["residual"].items():
            for leaf, v in p.items():
                assert np.array_equal(hit["residual"][name][leaf], v)
    # the checkpoints hold the reference's layout: one residual row a rank
    last = C.latest_step(tmp_path / "ckpt" / "clean")
    full = C.restore(tmp_path / "ckpt" / "clean", last, {
        "params": results[0]["clean"]["params"],
        "residual": {n: {k: np.zeros((2, *v.shape[1:]), v.dtype)
                         for k, v in p.items()}
                     for n, p in results[0]["clean"]["residual"].items()},
        "step": np.int32(0)})
    for rank, res in enumerate(results):
        for name, p in res["clean"]["residual"].items():
            for leaf, v in p.items():
                assert np.array_equal(full["residual"][name][leaf][rank],
                                      v[0])


def test_elastic_rescale_4_to_2_keeps_the_residual_mass(tmp_path):
    """A checkpoint of a 4-rank int8 state restores onto 2 ranks: each
    rank's row is the sum of two old rows (``fold_residual``), so the sum
    over rows is kept, and the params are the checkpoint's."""
    rng = np.random.default_rng(4)
    state = {"params": {"conv": {"w": rng.standard_normal((3, 3, 4, 8))
                                 .astype(np.float32)}},
             "residual": {"conv": {"w": rng.standard_normal((4, 3, 3, 4, 8))
                                   .astype(np.float32)}},
             "step": np.int32(9)}
    C.save(tmp_path / "ckpt", 9, state)
    results = spawn("elastic_rank", 2, tmp_path, ckpt_dir=str(
        tmp_path / "ckpt"), step=9, template=state)
    r = state["residual"]["conv"]["w"]
    folded = fold_residual({"w": torch.from_numpy(r)}, 2)["w"].numpy()
    rows = np.concatenate([res["residual"]["conv"]["w"] for res in results])
    assert np.array_equal(rows, folded)
    assert np.array_equal(rows[0], r[0] + r[1])
    np.testing.assert_allclose(rows.sum(axis=0), r.sum(axis=0), rtol=1e-6,
                               atol=1e-6)
    for res in results:
        assert np.array_equal(res["params"]["conv"]["w"],
                              state["params"]["conv"]["w"])


def test_wu_strategy_equals_the_reference():
    for n, c, k, hw, r, workers, db in itertools.product(
            (1, 8, 32), (3, 64, 512), (64, 256, 2048), (7, 28, 56, 224),
            (1, 3), (1, 2, 4, 8, 64), (2, 4)):
        kw = dict(n=n, c=c, k=k, h=hw, w=hw, p=hw, q=hw, r=r, s=r,
                  n_workers=workers, dtype_bytes=db)
        assert wu_strategy.choose_wu_strategy(**kw) == \
            wu_strategy.WuCost(*vars(jax_wu.choose_wu_strategy(**kw))
                               .values())
        got = wu_strategy.choose_wu_strategy(**kw, feature_par=(2, 2))
        exp = jax_wu.choose_wu_strategy(**kw, feature_par=(2, 2))
        assert vars(got) == vars(exp)
        h = dict(n=n, dw_bytes=r * r * c * k * db,
                 act_bytes=n * c * hw * hw * db, n_workers=workers)
        assert wu_strategy.hybrid_copies(**h) == jax_wu.hybrid_copies(**h)


@pytest.mark.parametrize("seed,fault", [(15, "StepFault"),
                                        (2, "HostDeath")])
def test_trainer_under_chaos_on_two_ranks(tmp_path, seed, fault):
    """``launch.train.main`` on two CPU ranks, without ``--ckpt-dir`` (rank
    0 makes the directory and the other rank takes its path): under a
    seeded fault both ranks recover alike and end with the same params,
    equal bit for bit to the uninterrupted run's."""
    from repro_torch.train.chaos import ChaosSchedule
    steps = 8
    sched = ChaosSchedule.generate(seed, n_steps=steps,
                                   hosts=[f"host{i}" for i in range(4)])
    assert [type(e).__name__ for e in sched.events] == [fault]
    argv = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
            "--steps", str(steps), "--seq-len", "16", "--global-batch", "4",
            "--lr", "1e-3", "--ckpt-every", "2", "--chaos-seed", str(seed)]
    results = spawn("trainer_rank", 2, tmp_path, argv=argv)
    crcs = {res[run]["params_crc32"] for res in results
            for run in ("clean", "chaos")}
    assert len(crcs) == 1
    for res in results:
        assert res["clean"]["ranks_agree"] and res["chaos"]["ranks_agree"]
        assert res["clean"]["resilience"]["restarts"] == 0
        assert res["chaos"]["resilience"]["restarts"] >= 1
        assert res["chaos"]["last"] == res["clean"]["last"]


def test_a_failure_on_one_rank_ends_the_run(tmp_path):
    """With a group the loop recovers only from the failure hook's faults:
    an error inside one rank's step ends the run there, its peer's
    collective then fails, and no rank retries or restores."""
    results = spawn("one_rank_fails_rank", 2, tmp_path,
                    ckpt_dir=str(tmp_path / "ckpt"), fail_step=2)
    r0, r1 = results
    assert "rank 1 alone fails" in r1["error"]
    assert r0["error"] is not None
    assert r0["restarts"] == r1["restarts"] == 0
    assert r1["began"] == [0, 1, 2] and r0["began"] == [0, 1, 2]
