"""The tuner's matmul kind and the LM weight quantizers, against the JAX
package: ``matmul_key``, ``matmul_candidates`` and
``matmul_blocking_analytic`` equal the reference's; K6's plans
(``plan_candidates("matmul")``, ``MatmulPlan``) with the default first;
``lookup_matmul`` / ``autotune_matmul`` persist a plan that a fresh cache
reads back; ``check_matmul_plan`` refuses a plan the route cannot run, on
the CPU as on the card; ``ops.matmul`` takes the plan
``core.blocking.matmul_blocking`` gives under the autotune knob; and
``quantize_int8``, ``dequantize`` and ``quantization_error`` equal the
reference's bits."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocking as jax_blocking
from repro.core import quantize as jax_quantize
from repro.tune import cache as jax_cache
from repro.tune import space as jax_space
from repro_torch import tune
from repro_torch.core import blocking, quantize
from repro_torch.kernels import matmul_fused as k6
from repro_torch.kernels import ops
from repro_torch.tune import cache, space

SHAPES = list(itertools.product((1, 100, 128, 4096), (256, 1000, 1536, 8960),
                                (8, 96, 1536, 8960)))


@pytest.mark.parametrize("db", [2, 4])
def test_matmul_key_candidates_and_analytic_equal_the_reference(db):
    for m, n, k in SHAPES:
        assert cache.matmul_key(m=m, n=n, k=k, dtype_bytes=db,
                                backend="cuda", device="H100") == \
            jax_cache.matmul_key(m=m, n=n, k=k, dtype_bytes=db,
                                 backend="cuda", device="H100")
        got = blocking.matmul_blocking_analytic(m, n, k, dtype_bytes=db)
        exp = jax_blocking.matmul_blocking_analytic(m, n, k, dtype_bytes=db)
        assert vars(got) == vars(exp)
        assert [vars(b) for b in space.matmul_candidates(
            m, n, k, dtype_bytes=db)] == \
            [vars(b) for b in jax_space.matmul_candidates(
                m, n, k, dtype_bytes=db)]
    small = dict(dtype_bytes=db, vmem_budget=1 << 18)
    assert vars(blocking.matmul_blocking_analytic(4096, 8960, 8960,
                                                  **small)) == \
        vars(jax_blocking.matmul_blocking_analytic(4096, 8960, 8960, **small))


def test_plan_candidates_by_route():
    wg = space.plan_candidates("matmul", m=4096, n=1536, k=1536,
                               dtype_bytes=2)
    assert wg[0] == k6.default_matmul_plan("wgmma", 4096, 1536) \
        == k6.MatmulPlan("wgmma", 128, 128, 3)
    assert len(wg) == len(set(wg)) == 6
    assert {(p.bn, p.stages) for p in wg} == {(bn, s) for bn in (128, 256)
                                              for s in (2, 3, 4)}
    # f32, and bf16 with K off the multiples of 8, take the SIMT route
    for db, k in ((4, 1536), (2, 1530)):
        simt = space.plan_candidates("matmul", m=1000, n=1000, k=k,
                                     dtype_bytes=db)
        assert {p.route for p in simt} == {"simt"} and len(simt) == 4
        assert simt[0] == k6.MatmulPlan("simt", 64, 64, 2)   # 64 tiles < SMs
    big = space.plan_candidates("matmul", m=4096, n=4096, k=64,
                                dtype_bytes=4)
    assert big[0] == k6.MatmulPlan("simt", 128, 128, 2)
    for p in wg + simt:
        k6.check_matmul_plan(p, route_=p.route, m=4096, n=1536, k=1536)


def test_check_matmul_plan_refuses_what_the_route_cannot_run():
    a, b = torch.randn(64, 32), torch.randn(32, 48)
    bad = [k6.MatmulPlan("wgmma", 128, 128, 3),      # f32 takes SIMT
           k6.MatmulPlan("simt", 32, 64, 2),
           k6.MatmulPlan("simt", 64, 256, 2),
           k6.MatmulPlan("simt", 64, 64, 3),
           (64, 64)]
    for plan in bad:
        with pytest.raises(ValueError):
            k6.matmul_fused(a, b, plan=plan)
    for plan in (k6.MatmulPlan("wgmma", 64, 128, 3),
                 k6.MatmulPlan("wgmma", 128, 192, 3),
                 k6.MatmulPlan("wgmma", 128, 128, 5)):
        with pytest.raises(ValueError):
            k6.check_matmul_plan(plan, route_="wgmma", m=64, n=48, k=32)
    # a plan the route takes: the plain version on the CPU, as plan=None
    out = k6.matmul_fused(a, b, plan=k6.MatmulPlan("simt", 128, 64, 2))
    assert torch.equal(out, k6.matmul_fused(a, b))


def test_lookup_and_autotune_round_trip_persists(tmp_path):
    path = str(tmp_path / "tune.json")
    c = tune.TuneCache(path)
    assert tune.lookup_matmul(4096, 8960, 1536, backend="cpu", cache=c) \
        is None
    plan = tune.autotune_matmul(4096, 8960, 1536, backend="cpu", cache=c)
    assert plan in space.plan_candidates("matmul", m=4096, n=8960, k=1536,
                                         dtype_bytes=2)
    fresh = tune.TuneCache(path)                    # read from the file
    assert tune.lookup_matmul(4096, 8960, 1536, backend="cpu",
                              cache=fresh) == plan
    entry = fresh.lookup(tune.matmul_key(m=4096, n=8960, k=1536,
                                         dtype_bytes=2, backend="cpu"))
    assert entry["source"] == "model" and entry["candidates"] == 6
    # an entry the shape's route cannot run misses
    key = tune.matmul_key(m=64, n=64, k=64, dtype_bytes=4, backend="cpu")
    fresh.store(key, {"route": "wgmma", "bm": 128, "bn": 128, "stages": 3},
                source="model", score_us=1.0, persist=False)
    assert tune.lookup_matmul(64, 64, 64, dtype_bytes=4, backend="cpu",
                              cache=fresh) is None
    # on the CPU the winner is the model's cheapest plan
    assert tune.matmul_plan_cost_us(4096, 8960, 1536, plan) == min(
        tune.matmul_plan_cost_us(4096, 8960, 1536, p) for p in
        space.plan_candidates("matmul", m=4096, n=8960, k=1536,
                              dtype_bytes=2))


def test_ops_matmul_consults_the_blocking_under_the_knob(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "t.json"))
    a, b = torch.randn(128, 64), torch.randn(64, 32)
    bias = torch.randn(32)
    assert blocking.matmul_blocking(128, 32, 64, dtype_bytes=4,
                                    backend="cpu", autotune="off") is None
    assert blocking.matmul_blocking(128, 32, 64, dtype_bytes=4,
                                    backend="cpu", autotune="cache") is None
    tuned = blocking.matmul_blocking(128, 32, 64, dtype_bytes=4,
                                     backend="cpu", autotune="tune")
    assert tuned.route == "simt"
    assert blocking.matmul_blocking(128, 32, 64, dtype_bytes=4,
                                    backend="cpu", autotune="cache") == tuned
    for mode in ("off", "cache", "tune"):
        out = ops.matmul(a, b, bias=bias, act="relu", autotune=mode)
        assert torch.equal(out, k6.matmul_fused_plain(a, b, bias=bias,
                                                      act="relu"))


def _quant_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((64, 48)) * 0.05).astype(np.float32),
            "layers": {"wq": rng.standard_normal((2, 32, 64)).astype(
                np.float32),
                "norm": rng.standard_normal((64,)).astype(np.float32)},
            "small": rng.standard_normal((4, 4)).astype(np.float32),
            "zero": np.zeros((32, 40), np.float32)}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_dequantize_and_error_equal_the_reference(seed):
    tree = _quant_tree(seed)
    got = quantize.quantize_int8(_to_torch(tree))
    exp = jax_quantize.quantize_int8(jax.tree.map(jnp.asarray, tree))
    assert torch.is_tensor(got["small"]) and torch.is_tensor(
        got["layers"]["norm"])
    for path in (("w",), ("layers", "wq"), ("zero",)):
        g, e = got, exp
        for p in path:
            g, e = g[p], e[p]
        assert g["q"].dtype == torch.int8
        assert np.array_equal(g["q"].numpy(), np.asarray(e["q"]))
        assert np.array_equal(g["s"].numpy(), np.asarray(e["s"]))
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        d = quantize.dequantize(got, dt)
        de = jax_quantize.dequantize(exp, jdt)
        assert np.array_equal(_bits(d["w"]), np.asarray(de["w"]).view(
            np.uint16 if dt == torch.bfloat16 else np.float32))
        assert torch.equal(d["small"], got["small"])
        err = quantize.quantization_error(_to_torch(tree), dt)
        err_e = jax_quantize.quantization_error(
            jax.tree.map(jnp.asarray, tree), jdt)
        assert err == jax.tree.map(float, err_e)
