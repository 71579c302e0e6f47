"""The port's data-parallel CNN step (``repro_torch.train.distributed``)
over two CPU ranks (gloo, one process a rank, meeting through a
``file://`` store under ``tmp_path``; each rank's deadline 120 s), on the
reference tests' tiny ResNet (``resnet50(num_classes=10, stages=(1, 1,
1, 1))`` at 32 x 32) from the reference's params layout.

The reference's own data-parallel step runs through ``shard_map`` with
``check_rep``, which the installed jax refuses, so the oracle is the
semantics its test defines (``tests/test_train_dp.py:90-122``): each
shard's ``jax.value_and_grad(m.loss, has_aux=True)``, gradients and BN
statistics averaged, one SGD step, ``apply_bn_updates``.  Limits, the
reference tests' own: rtol 1e-5 and atol 1e-5 on the params (the
``accum_steps`` identity 1e-4, as there), the loss within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _dp_ranks import spawn
from repro.graph import GxM as JaxGxM
from repro.graph import resnet50 as jax_resnet50
from repro.graph.executor import apply_bn_updates as jax_apply_bn_updates
from test_torch_executor import _reference_params

LR = 0.1


def _images(rng, n, hw=32):
    return {"image": rng.standard_normal((n, hw, hw, 3)).astype(np.float32),
            "label": rng.integers(0, 10, size=(n,)).astype(np.int32)}


def _tree():
    ref = JaxGxM(jax_resnet50(10, stages=(1, 1, 1, 1)), impl="xla",
                 num_classes=10)
    return ref, _reference_params(ref)


def _assert_tree_close(got, exp, rtol, atol):
    assert got.keys() == exp.keys()
    for name, p in exp.items():
        for leaf, v in p.items():
            np.testing.assert_allclose(got[name][leaf], np.asarray(v),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{name}/{leaf}")


def test_identical_shards_equal_the_single_device_step(tmp_path):
    """Both ranks on the same local batch: the f32 reduction halves a sum
    of two equal values, which is exact, so each rank's step equals the
    port's single-device step bit for bit."""
    _, tree = _tree()
    mb = _images(np.random.default_rng(0), 2)
    batch = {k: np.concatenate([v, v]) for k, v in mb.items()}
    for res in spawn("cnn_step_rank", 2, tmp_path, tree=tree, batch=batch,
                     lr=LR, steps=1, single=True):
        got, single = res[1], res["single"]
        assert got["losses"][0] == single["loss"]
        for name, p in single["params"].items():
            for leaf, v in p.items():
                assert np.array_equal(got["params"][name][leaf], v), \
                    (name, leaf)


def test_distinct_shards_match_the_reference_semantics(tmp_path):
    """Four images a rank: the reference test's two leave the last stage's
    BN a 2 x 1 x 1 batch a shard, whose statistics are too ill-conditioned
    for two frameworks' f32 sums to agree within the limit (they differ
    by up to 4e-4; within one framework, as in the reference's test, they
    agree)."""
    ref, tree = _tree()
    batch = _images(np.random.default_rng(0), 8)
    results = spawn("cnn_step_rank", 2, tmp_path, tree=tree, batch=batch,
                    lr=LR, steps=1)
    params = jax.tree.map(jnp.asarray, tree)
    lf = lambda p, b: ref.loss(p, b, collect_stats=True)  # noqa: E731
    halves = [{k: jnp.asarray(v[:4]) for k, v in batch.items()},
              {k: jnp.asarray(v[4:]) for k, v in batch.items()}]
    outs = [jax.jit(jax.value_and_grad(lf, has_aux=True))(params, h)
            for h in halves]
    gavg = jax.tree.map(lambda a, b: (a + b) / 2, outs[0][1], outs[1][1])
    savg = jax.tree.map(lambda a, b: (a + b) / 2, outs[0][0][1],
                        outs[1][0][1])
    exp = jax.tree.map(lambda p, g: p - LR * g, params, gavg)
    jax_apply_bn_updates(exp, savg, 0.9)
    loss_exp = (float(outs[0][0][0]) + float(outs[1][0][0])) / 2
    for res in results:
        _assert_tree_close(res[1]["params"], jax.device_get(exp), 1e-5, 1e-5)
        assert abs(res[1]["losses"][0] - loss_exp) < 1e-5
    for name, p in results[0][1]["params"].items():
        for leaf, v in p.items():
            assert np.array_equal(results[1][1]["params"][name][leaf], v)


def test_accum_steps_equal_one_step_on_duplicate_microbatches(tmp_path):
    """Each rank's local batch is two copies of one microbatch, so
    accum_steps=2 must give accum_steps=1's step (64 x 64 images keep the
    last stage's BN statistics well conditioned, as in the reference's
    test)."""
    _, tree = _tree()
    rng = np.random.default_rng(0)
    ab, cd = _images(rng, 2, hw=64), _images(rng, 2, hw=64)
    batch = {k: np.concatenate([ab[k], ab[k], cd[k], cd[k]]) for k in ab}
    for res in spawn("cnn_step_rank", 2, tmp_path, tree=tree, batch=batch,
                     lr=LR, accum_steps=(1, 2)):
        assert abs(res[1]["losses"][0] - res[2]["losses"][0]) < 1e-5
        _assert_tree_close(res[2]["params"], res[1]["params"], 1e-4, 1e-4)


def test_int8_reduction_loss_falls(tmp_path):
    """REPRO_GRAD_COMPRESS=int8 (the reference test's lr 0.02 and 8
    steps): the loss falls, and a live residual carries the quantization
    error between steps, one row a rank."""
    _, tree = _tree()
    batch = _images(np.random.default_rng(0), 4)
    results = spawn("cnn_step_rank", 2, tmp_path, tree=tree, batch=batch,
                    lr=0.02, grad_compress="int8", steps=8)
    for res in results:
        losses = res[1]["losses"]
        assert np.isfinite(losses).all(), losses
        assert losses[-1] < losses[0], losses
        rows = [r for p in res[1]["residual"].values() for r in p.values()]
        assert all(r.shape[0] == 1 for r in rows)
        assert max(float(np.abs(r).max()) for r in rows) > 0
    # the ranks' own residuals differ; their params do not
    assert any(not np.array_equal(a, b) for a, b in zip(
        [r for p in results[0][1]["residual"].values() for r in p.values()],
        [r for p in results[1][1]["residual"].values() for r in p.values()]))
    for name, p in results[0][1]["params"].items():
        for leaf, v in p.items():
            assert np.array_equal(results[1][1]["params"][name][leaf], v)


def test_warmup_payload_installs_on_the_other_rank(tmp_path):
    """Rank 0 tunes the "fwd", "bwd" and "wu" plans at the per-rank batch
    and broadcasts them; rank 1 installs the payload and finds every key
    cached without tuning."""
    r0, r1 = spawn("warmup_rank", 2, tmp_path, cache_dir=str(tmp_path),
                   global_batch=4)
    keys = {e["key"] for e in r0["report"]}
    assert r0["payload"] == r1["payload"]
    assert set(r0["payload"]) == {e["key"] for e in r0["report"]
                                  if e["cached"]}
    assert {e["kind"] for e in r0["report"]} == {"fwd", "bwd", "wu"}
    assert all("|n2h" in k for k in keys)            # per-rank batch 2
    assert [e["key"] for e in r1["report"]] == [e["key"] for e in r0["report"]]
    assert [e["cached"] for e in r1["report"]] == \
        [e["cached"] for e in r0["report"]]
    assert r1["persisted"] == len(r0["payload"]) > 0
    for e in r1["report"]:
        if e["cached"]:
            assert e["source"] == "model"
