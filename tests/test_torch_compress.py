"""The port's error-feedback int8 gradient compression
(``repro_torch.optim.compress``) against the JAX package's
(``repro.optim.compress``): the pure ``compress_int8`` and
``decompress_int8`` bit for bit on seeded numpy inputs, ``fold_residual``
bit for bit where each new row sums at most two old ones (a sum of more
takes its terms in torch's order, not XLA's: within 1e-6 relative), and
``compressed_psum`` over 2 and 4 CPU ranks (gloo, one
process a rank, ``launch.ranks.run_ranks``) against
``jax.vmap(compressed_psum, axis_name=)`` over the stacked shards, which
runs on the installed jax where the reference's ``shard_map`` paths do
not.  Also: ``compressed_psum_tree`` equals leaf-wise ``compressed_psum``
bit for bit, the wire carries int32 codes, ``fold_residual`` keeps the
residual's mass (hypothesis), the ``REPRO_GRAD_COMPRESS`` knob, and every
data-parallel entry point raises without a process group."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from _dp_ranks import spawn
from repro.optim import compress as jax_compress
from repro_torch import backend as be
from repro_torch.optim import compress

SHAPES = {"w": (3, 3, 8, 16), "b": (16,), "fc": (64, 10)}


def _stacked(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal((n, *s)) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_and_decompress_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((33, 17)) * 10 ** rng.uniform(-4, 2)).astype(
        np.float32)
    r = (rng.standard_normal((33, 17)) * 1e-3).astype(np.float32)
    for res in (None, r):
        r_t = None if res is None else torch.from_numpy(res)
        q, s, nr = compress.compress_int8(torch.from_numpy(g), r_t)
        qj, sj, nrj = jax_compress.compress_int8(
            jnp.asarray(g), None if res is None else jnp.asarray(res))
        assert np.array_equal(q.numpy(), np.asarray(qj))
        assert np.array_equal(s.numpy(), np.asarray(sj))
        assert np.array_equal(nr.numpy(), np.asarray(nrj))
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            d = compress.decompress_int8(q, s, dt)
            dj = np.asarray(jax_compress.decompress_int8(qj, sj, jdt))
            if dt == torch.bfloat16:
                assert np.array_equal(d.view(torch.uint16).numpy(),
                                      dj.view(np.uint16))
            else:
                assert np.array_equal(d.numpy(), dj)


@pytest.mark.parametrize("old,new", [(4, 2), (4, 1), (4, 4), (3, 2), (6, 4)])
def test_fold_residual_equals_the_reference(old, new):
    tree = _stacked(old, seed=old * 10 + new)
    got = compress.fold_residual({k: torch.from_numpy(v)
                                  for k, v in tree.items()}, new)
    exp = jax_compress.fold_residual({k: jnp.asarray(v)
                                      for k, v in tree.items()}, new)
    terms = old // new if old % new == 0 else old
    for k in tree:
        assert got[k].shape == (new, *SHAPES[k])
        if terms <= 2:
            assert np.array_equal(got[k].numpy(), np.asarray(exp[k])), k
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(exp[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


@settings(max_examples=40, deadline=None)
@given(old=st.integers(1, 8), new=st.integers(1, 8),
       size=st.integers(1, 40), seed=st.integers(0, 2 ** 31 - 1))
def test_fold_residual_keeps_the_mass(old, new, size, seed):
    """float64 rows, so the sums in either order agree to rounding:
    the total over rows is kept, and rows past the fold are zero where
    the old width does not divide by the new."""
    r = np.random.default_rng(seed).standard_normal((old, size))
    out = compress.fold_residual({"r": torch.from_numpy(r)}, new)["r"]
    assert out.shape == (new, size) or old == new
    np.testing.assert_allclose(out.numpy().sum(axis=0), r.sum(axis=0),
                               rtol=1e-12, atol=1e-12)
    if old != new and old % new:
        assert not out[1:].any()


def _vmap_reference(grads, residuals):
    def one(g, r):
        return jax_compress.compressed_psum(g, "d", r)
    return {k: jax.vmap(one, axis_name="d")(jnp.asarray(g),
                                            jnp.asarray(residuals[k]))
            for k, g in grads.items()}


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_matches_vmap_reference(world, tmp_path):
    grads = _stacked(world, seed=world)
    residuals = _stacked(world, seed=world + 100, scale=1e-3)
    results = spawn("compressed_psum_rank", world, tmp_path, grads=grads,
                    residuals=residuals)
    exp = _vmap_reference(grads, residuals)
    for rank, res in enumerate(results):
        tree_mean, tree_res = res["tree"]
        for k in SHAPES:
            mean, new_res = res["leaf"][k]
            mean_j, res_j = (np.asarray(x[rank]) for x in exp[k])
            np.testing.assert_array_equal(mean, mean_j, err_msg=k)
            np.testing.assert_array_equal(new_res, res_j, err_msg=k)
            # the bucketed tree reduction gives each leaf's bits
            np.testing.assert_array_equal(tree_mean[k], mean)
            np.testing.assert_array_equal(tree_res[k], new_res)
        # every rank holds the same mean
        for k in SHAPES:
            np.testing.assert_array_equal(res["leaf"][k][0],
                                          results[0]["leaf"][k][0])
        # the wire carries int32 codes: 4 bytes an element, as f32 would
        n = sum(int(np.prod(s)) for s in SHAPES.values())
        assert res["wire_bytes"] == 4 * n + 4 * len(SHAPES)
        assert compress.wire_bytes({k: torch.zeros(s) for k, s in
                                    SHAPES.items()}) == res["wire_bytes"]


def test_grad_compress_knob(monkeypatch):
    monkeypatch.delenv("REPRO_GRAD_COMPRESS", raising=False)
    assert be.get_grad_compress() == "off"
    monkeypatch.setenv("REPRO_GRAD_COMPRESS", "int8")
    assert be.resolve_grad_compress(None) == "int8"
    assert be.resolve_grad_compress("off") == "off"
    with be.use_grad_compress("off"):
        assert be.get_grad_compress() == "off"
    assert be.get_grad_compress() == "int8"
    monkeypatch.setenv("REPRO_GRAD_COMPRESS", "int4")
    with pytest.raises(ValueError, match="REPRO_GRAD_COMPRESS"):
        be.get_grad_compress()
    with pytest.raises(ValueError):
        be.resolve_grad_compress("fp8")


def test_data_parallel_entry_points_raise_without_a_group():
    from repro_torch.graph import GxM, resnet50
    from repro_torch.launch import mesh
    from repro_torch.train import distributed as D
    from repro_torch.train import step as step_lib
    assert not torch.distributed.is_initialized()
    m = GxM(resnet50(num_classes=10, stages=(1, 1, 1, 1)), device="cpu",
            num_classes=10)
    params = {"x": {"w": torch.zeros(2, 2)}}
    g = torch.ones(3)
    for call in (lambda: mesh.data_axis_size(),
                 lambda: D.init_cnn_train_state_dp(params),
                 lambda: D.make_cnn_train_step_dp(m),
                 lambda: D.shard_cnn_batch({"image": np.zeros((4, 1))}),
                 lambda: D.gather_cnn_state({"params": params, "step": 0,
                                             "residual": {}}),
                 lambda: D.cnn_dp_resilience("unused"),
                 lambda: D.warmup_cnn_train_dp(m, global_batch=2),
                 lambda: compress.compressed_psum(g),
                 lambda: compress.compressed_psum_tree({"g": g}, None,
                                                       {"g": g}),
                 lambda: step_lib.warmup_cnn_train(m, minibatch=2,
                                                   group=object()),
                 lambda: mesh.init_data_group()):
        with pytest.raises(RuntimeError):
            call()
