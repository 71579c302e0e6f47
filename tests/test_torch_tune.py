"""The port's blocking autotuner (``repro_torch.tune``, ``core.blocking``,
``launch.roofline``, the ``REPRO_AUTOTUNE`` knob) on the CPU: the analytic
blockings, candidate lists and traffic model against the JAX package at its
budget, the H100 cost model, and the persistent cache.  Every cache lives
under ``tmp_path``."""
import ast
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro import tune as jax_tune
from repro.core import blocking as jax_blocking
from repro.core import duality as jax_duality
from repro.tune import measure as jax_measure
from repro_torch import backend as be
from repro_torch import tune
from repro_torch.core import blocking
from repro_torch.graph import build_etg, inception_v3, resnet50
from repro_torch.graph.serving import conv_shapes
from repro_torch.kernels import conv2d_streams as k4
from repro_torch.kernels import ref
from repro_torch.launch import roofline
from repro_torch.tune import measure

FIELDS = ("h", "w", "c", "k", "r", "s", "stride", "padding")
JAX_BUDGET = jax_blocking.VMEM_BUDGET          # the TPU's 16 MiB
KINDS = ("fwd", "bwd", "wu", "streams", "q8")
PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _signatures():
    sigs = set()
    for net, hw in ((resnet50(), 224), (inception_v3(), 299)):
        for sh in conv_shapes(build_etg(net), (hw, hw)):
            sigs.add(tuple(sh[f] for f in FIELDS))
    return sorted(sigs)


SIGNATURES = _signatures()
L4 = dict(h=56, w=56, c=64, k=64, r=3, s=3, stride=1, padding=1)


def _asdicts(blks):
    return [dataclasses.asdict(b) for b in blks]


def _cache(tmp_path):
    return tune.TuneCache(str(tmp_path / "blockings.json"))


# -- parity with the reference at its budget ------------------------------------

def test_signatures_cover_both_networks():
    assert len(SIGNATURES) > 30
    assert {s[0] for s in SIGNATURES} >= {224, 56, 7, 299, 150, 75}


@pytest.mark.parametrize("kind", KINDS)
def test_analytic_blocking_equals_reference(kind):
    for sig in SIGNATURES:
        kw = dict(zip(FIELDS, sig))
        whole = True if kind == "streams" else None
        for db in ((1, 4) if kind == "q8" else (4,)):
            ours = blocking.conv_blocking_analytic(
                **kw, dtype_bytes=db, vmem_budget=JAX_BUDGET, kind=kind,
                whole_plane=whole)
            theirs = jax_blocking.conv_blocking_analytic(
                **kw, dtype_bytes=db, vmem_budget=JAX_BUDGET, kind=kind,
                whole_plane=whole)
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), sig
    legacy = [blocking.conv_blocking_analytic(
        **dict(zip(FIELDS, s)), vmem_budget=JAX_BUDGET, require_divisor=True)
        for s in SIGNATURES]
    assert _asdicts(legacy) == _asdicts(
        jax_blocking.conv_blocking_analytic(
            **dict(zip(FIELDS, s)), vmem_budget=JAX_BUDGET,
            require_divisor=True) for s in SIGNATURES)


@pytest.mark.parametrize("kind", KINDS)
def test_candidates_equal_reference(kind):
    for sig in SIGNATURES:
        kw = dict(zip(FIELDS, sig))
        ours = tune.conv_candidates(**kw, kind=kind, vmem_budget=JAX_BUDGET)
        theirs = jax_tune.conv_candidates(**kw, kind=kind,
                                          vmem_budget=JAX_BUDGET)
        assert _asdicts(ours) == _asdicts(theirs), sig


def test_helpers_equal_reference():
    for dim in (3, 8, 64, 96, 160, 192, 320, 448, 2048):
        assert blocking.aligned_block(dim) == jax_blocking.aligned_block(dim)
        assert blocking.divisors(dim) == jax_blocking.divisors(dim)
    kw = dict(h=28, w=28, c=128, k_blk=64, r=3, s=3, q=28, rb_p=4,
              padding=1, stride=1, c_blk=32, rb_q=14)
    for kind in KINDS:
        for whole in (False, True):
            assert blocking.conv_working_set(**kw, kind=kind,
                                             whole_plane=whole) == \
                jax_blocking.conv_working_set(**kw, kind=kind,
                                              whole_plane=whole)


@pytest.mark.parametrize("kind", KINDS)
def test_traffic_equals_reference(kind):
    """The same FLOPs and bytes as the reference for the same blocking."""
    keys = ("flops", "x_bytes", "w_bytes", "o_bytes", "hbm_bytes", "n_steps",
            "extents")
    for sig in SIGNATURES[::3]:
        shape = dict(zip(FIELDS, sig))
        cands = tune.conv_candidates(**shape, kind=kind,
                                     vmem_budget=JAX_BUDGET)[:24]
        for blk in cands:
            jblk = jax_blocking.ConvBlocking(**dataclasses.asdict(blk))
            for mb in (1, 16):
                for whole in ((False, True) if kind in ("fwd", "wu")
                              else (False,)):
                    ours = measure.conv_traffic(shape, blk, minibatch=mb,
                                                kind=kind, whole_plane=whole)
                    theirs = jax_measure.conv_traffic(
                        shape, jblk, minibatch=mb, kind=kind,
                        whole_plane=whole)
                    assert {k: ours[k] for k in keys} == \
                        {k: theirs[k] for k in keys}, (sig, blk)


def test_hopper_budget_is_one_ctas_shared_memory():
    assert blocking.VMEM_BUDGET == 232448 != JAX_BUDGET
    for cand in tune.conv_candidates(**L4, kind="streams")[1:]:
        assert cand.vmem_bytes <= blocking.VMEM_BUDGET


# -- the H100 cost model ------------------------------------------------------------

def test_cost_model_uses_no_tpu_constant():
    tpu = {"PEAK_FLOPS", "HBM_BW", "ICI_BW", "STEP_OVERHEAD_S",
           "STEP_OVERHEAD_US", "_tile_util", "MXU"}
    for path in sorted(PORT.rglob("*.py")):
        names = {n.id for n in ast.walk(ast.parse(path.read_text()))
                 if isinstance(n, ast.Name)}
        names |= {n.attr for n in ast.walk(ast.parse(path.read_text()))
                  if isinstance(n, ast.Attribute)}
        assert not names & tpu, (path.name, names & tpu)
    assert roofline.F32_PEAK_FLOPS == 67e12
    assert roofline.INT8_PEAK_OPS == 1979e12
    assert roofline.HBM_BYTES_PER_S == 3.35e12


def test_cost_is_the_h100_roofline_with_k4_occupancy():
    """K4's occupancy and peak are those of the route it takes: every L4
    candidate takes the mma route (3xTF32, a third of the TF32 rate)."""
    shape = dict(L4)
    for blk in tune.conv_candidates(**shape, kind="streams")[:10]:
        t = measure.conv_traffic(shape, blk, minibatch=16, kind="streams")
        p = q = 56
        rb_p = min(blk.rb_p, p)
        runs = 16 * (64 // blk.k_blk) * -(-p // rb_p)
        assert k4.route_of(c=64, k=64, c_blk=blk.c_blk,
                           k_blk=blk.k_blk) == "mma"
        _, util = k4.mma_tile_config(tile_m=rb_p * q, k_blk=blk.k_blk,
                                     runs=runs)
        depth = k4.mma_stage_c(blk.c_blk)
        util *= blk.c_blk / (-(-blk.c_blk // depth) * depth)
        want = max(t["flops"] / (494.7e12 / 3 * util),
                   t["hbm_bytes"] / 3.35e12)
        got = measure.conv_cost_us(shape, blk, minibatch=16, kind="streams")
        assert got == pytest.approx(want * 1e6, rel=1e-12)
    fwd = blocking.conv_blocking_analytic(**shape)
    t = measure.conv_traffic(shape, fwd, minibatch=4)
    assert measure.conv_cost_us(shape, fwd, minibatch=4) == pytest.approx(
        max(t["flops"] / 67e12, t["hbm_bytes"] / 3.35e12) * 1e6, rel=1e-12)


def test_roofline_bound():
    ms, by = roofline.bound_ms(67e9, 1.0)
    assert ms == pytest.approx(1.0) and by == "operations"
    ms, by = roofline.bound_ms(1.0, 3.35e9)
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = roofline.bound_ms(1979e9, 0.0, roofline.INT8_PEAK_OPS)
    assert ms == pytest.approx(1.0) and by == "operations"
    r = roofline.kernel_roofline(flops=67e12, hbm_bytes=0.0, util=0.5)
    assert r["cost_s"] == pytest.approx(2.0) and r["dominant"] == "compute"
    assert r["efficiency"] == pytest.approx(0.5)


def test_measurement_needs_the_card_and_a_k4_kind():
    assert tune.can_measure("cuda") and not tune.can_measure("cpu")
    blk = blocking.conv_blocking_analytic(**L4)
    with pytest.raises(NotImplementedError, match="tile-tuning slice"):
        measure.measure_conv_us(dict(L4), blk, kind="fwd")


# -- cache --------------------------------------------------------------------------

def test_key_format_equals_reference():
    kw = dict(kind="streams", h=14, w=14, c=256, k=256, r=3, s=3, stride=1,
              padding=1, dtype_bytes=4, backend="cuda", minibatch=16,
              device="NVIDIA H100 80GB HBM3")
    assert tune.conv_key(**kw) == jax_tune.conv_key(**kw)
    assert tune.CACHE_VERSION == jax_tune.CACHE_VERSION
    assert tune.device_kind() == ("cpu" if not torch.cuda.is_available()
                                  else torch.cuda.get_device_name(0))


def test_cache_roundtrip(tmp_path):
    c = _cache(tmp_path)
    key = tune.conv_key(kind="streams", h=14, w=14, c=256, k=256, r=3, s=3,
                        stride=1, padding=1, dtype_bytes=4, backend="cpu")
    c.store(key, dict(rb_p=4, k_blk=128, c_blk=128, order="nkpc",
                      vmem_bytes=123), source="model", score_us=7.5)
    entry = tune.TuneCache(c.path).lookup(key)   # a fresh instance, same file
    assert entry is not None
    assert entry["blocking"]["rb_p"] == 4
    assert entry["source"] == "model"
    assert entry["version"] == tune.CACHE_VERSION
    assert len(tune.TuneCache(c.path)) == 1


def test_cache_version_mismatch_discarded(tmp_path):
    c = _cache(tmp_path)
    c.store("some|key", dict(rb_p=1), source="model", score_us=1.0)
    blob = json.loads(open(c.path).read())
    blob["version"] = tune.CACHE_VERSION + 1
    open(c.path, "w").write(json.dumps(blob))
    assert tune.TuneCache(c.path).lookup("some|key") is None


@pytest.mark.parametrize("text", ["{not json", "[1, 2]", ""])
def test_cache_torn_file_is_cold(tmp_path, text):
    path = tmp_path / "blockings.json"
    path.write_text(text)
    assert tune.TuneCache(str(path)).lookup("k") is None


def test_cache_save_merges_and_leaves_no_temporary(tmp_path):
    a, b = _cache(tmp_path), _cache(tmp_path)
    a.store("a|key", dict(rb_p=1), source="model", score_us=1.0)
    b.store("b|key", dict(rb_p=2), source="model", score_us=2.0)
    fresh = tune.TuneCache(a.path)
    assert fresh.lookup("a|key") and fresh.lookup("b|key")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["blockings.json"]


def test_one_file_holds_both_packages_entries(tmp_path):
    path = str(tmp_path / "shared.json")
    jax_tune.TuneCache(path).store("jax|key", dict(rb_p=1), source="model",
                                   score_us=1.0)
    tune.TuneCache(path).store("torch|key", dict(rb_p=2), source="model",
                               score_us=2.0)
    assert jax_tune.TuneCache(path).lookup("torch|key") is not None
    assert tune.TuneCache(path).lookup("jax|key") is not None


def test_default_path_is_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TUNE_CACHE", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    path = tune.cache.default_cache_path()
    assert path == str(tmp_path / "repro_torch_tune" / "blockings-v4.json")
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "x.json"))
    assert tune.default_cache().path == str(tmp_path / "x.json")


def test_autotune_conv_persists_and_hits(tmp_path):
    c = _cache(tmp_path)
    kw = dict(L4, kind="streams", backend="cpu", minibatch=2)
    assert tune.lookup_conv(**kw, cache=c) is None                 # cold
    blk = tune.autotune_conv(**kw, cache=c)
    assert tune.lookup_conv(**kw, cache=c) == blk                  # warm
    entry = tune.TuneCache(c.path).lookup(                         # new proc
        tune.conv_key(dtype_bytes=4, **kw))
    assert entry is not None and entry["source"] == "model"
    assert entry["budget"] == blocking.VMEM_BUDGET
    cands = tune.conv_candidates(**L4, kind="streams")
    best = min(cands, key=lambda b: measure.conv_cost_us(
        L4, b, minibatch=2, kind="streams"))
    assert measure.conv_cost_us(L4, blk, minibatch=2, kind="streams") == \
        measure.conv_cost_us(L4, best, minibatch=2, kind="streams")


def test_cached_entry_rejected_under_forced_budget(tmp_path, monkeypatch):
    """The key has no budget coordinate: an entry above a forced smaller
    budget falls back to analytic, unless it was chosen under this very
    budget (then it is the heuristic's own over-budget answer)."""
    c = _cache(tmp_path)
    kw = dict(h=14, w=14, c=256, k=256, r=3, s=3, stride=1, padding=1,
              kind="streams", backend="cpu")
    key = tune.conv_key(dtype_bytes=4, **kw)
    c.store(key, dict(rb_p=4, k_blk=128, c_blk=256, order="nkpc",
                      vmem_bytes=200_000, rb_q=14), source="model",
            score_us=1.0)
    assert tune.lookup_conv(**kw, cache=c) is not None
    monkeypatch.setattr(blocking, "VMEM_BUDGET", 100_000)
    assert tune.lookup_conv(**kw, cache=c) is None
    c.store(key, dict(rb_p=1, k_blk=128, c_blk=256, order="nkpc",
                      vmem_bytes=200_000, rb_q=14), source="model",
            score_us=1.0, budget=100_000)
    assert tune.lookup_conv(**kw, cache=c).rb_p == 1
    monkeypatch.setattr(blocking, "VMEM_BUDGET", 50_000)
    assert tune.lookup_conv(**kw, cache=c) is None


def test_over_budget_seed_persists_and_hits(tmp_path, monkeypatch):
    """Where no tile fits the budget the analytic seed is over it (rb_p = 1
    all the same); when it wins, it is stored and served again without a
    second search."""
    c = _cache(tmp_path)
    kw = dict(L4, kind="streams", backend="cpu", minibatch=16)
    seed = tune.conv_candidates(**L4, kind="streams")[0]
    assert seed.rb_p == 1 and seed.vmem_bytes > blocking.VMEM_BUDGET
    monkeypatch.setattr(tune, "rank_conv", lambda *a, **k: [(1.0, seed)])
    assert tune.autotune_conv(**kw, cache=c) == seed
    monkeypatch.setattr(tune, "rank_conv", None)    # no second search
    assert tune.autotune_conv(**kw, cache=c) == seed
    assert tune.lookup_conv(**kw, cache=tune.TuneCache(c.path)) == seed


def test_cold_cache_falls_back_to_heuristic(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "cold.json"))
    kw = dict(h=28, w=28, c=128, k=128, r=3, s=3, stride=1, padding=1)
    with be.use_autotune("cache"):
        got = blocking.conv_blocking(**kw, kind="streams", backend="cpu")
    assert got == blocking.conv_blocking_analytic(**kw, kind="streams",
                                                  whole_plane=True)
    assert not (tmp_path / "cold.json").exists()


def test_autotune_off_is_analytic():
    kw = dict(h=56, w=56, c=64, k=256, r=1, s=1, stride=1, padding=0)
    assert blocking.conv_blocking(**kw) == \
        blocking.conv_blocking_analytic(**kw)
    assert blocking.conv_blocking(**kw, kind="streams") == \
        blocking.conv_blocking_analytic(**kw, whole_plane=True,
                                        kind="streams")


def test_tune_mode_used_by_conv_blocking(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "t.json"))
    kw = dict(h=14, w=14, c=256, k=256, r=3, s=3, stride=1, padding=1,
              kind="streams", backend="cpu")
    with be.use_autotune("tune"):
        tuned = blocking.conv_blocking(**kw)
    with be.use_autotune("cache"):
        assert blocking.conv_blocking(**kw) == tuned
    assert blocking.conv_blocking(**kw) == blocking.conv_blocking_analytic(
        **{f: kw[f] for f in FIELDS}, whole_plane=True, kind="streams")


def test_autotune_on_without_a_device_raises(monkeypatch):
    """With the tuner on and no backend named, the default device is the
    card: without one it raises, never tunes for the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        blocking.conv_blocking(**L4, kind="streams", autotune="cache")
    with pytest.raises(RuntimeError, match="no GPU"):
        tune.warmup_convs([L4], kinds=("streams",))


def test_streams_auto_consumes_tuned_blocking(tmp_path, monkeypatch):
    """conv2d_streams_auto under "tune" stores the blocking it replays with;
    under "cache" it reads it back; both match the oracle."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "s.json"))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 16)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, 16, 16)) * 0.1)
                         .astype(np.float32))
    expect = ref.conv2d(x, w, stride=1, padding=1)
    out = k4.conv2d_streams_auto(x, w, stride=1, padding=1, autotune="tune")
    assert float((out - expect).abs().max()) <= 1e-5 * float(
        expect.abs().max())
    assert len(tune.TuneCache(str(tmp_path / "s.json"))) == 1
    seen = []
    real = k4.conv2d_streams

    def spy(*args, **kw):
        seen.append((kw["rb_p"], kw["k_blk"], kw["c_blk"]))
        return real(*args, **kw)
    monkeypatch.setattr(k4, "conv2d_streams", spy)
    monkeypatch.setattr(tune, "rank_conv", None)      # "cache" never ranks
    out2 = k4.conv2d_streams_auto(x, w, stride=1, padding=1,
                                  autotune="cache")
    blk = tune.lookup_conv(h=8, w=8, c=16, k=16, r=3, s=3, stride=1,
                           padding=1, kind="streams", backend="cpu")
    assert seen == [(blk.rb_p, blk.k_blk, blk.c_blk)]
    assert torch.equal(out2, out)


def test_warmup_convs_reports_every_key(tmp_path):
    c = _cache(tmp_path)
    shapes = [dict(h=14, w=14, c=64, k=64, r=3, s=3, stride=2, padding=1),
              dict(h=7, w=7, c=128, k=64, r=1, s=1, stride=1, padding=0)]
    report = tune.warmup_convs(shapes, minibatches=(1, 4),
                               kinds=("streams", "bwd"), backend="cpu",
                               cache=c)
    duals = sum(len(jax_duality.dual_conv_signatures(
        r=s["r"], s=s["s"], c=s["c"], k=s["k"], stride=s["stride"],
        padding=s["padding"], input_hw=(s["h"], s["w"]))) for s in shapes)
    assert len(report) == 2 * (len(shapes) + duals)
    assert all(e["cached"] and e["source"] == "model" for e in report)
    assert len({e["key"] for e in report}) == len(report)
    again = tune.warmup_convs(shapes, minibatches=(1, 4),
                              kinds=("streams", "bwd"), backend="cpu",
                              cache=tune.TuneCache(c.path), mode="cache")
    assert [e["key"] for e in again] == [e["key"] for e in report]
    assert all(e["cached"] for e in again)


# -- the knob -----------------------------------------------------------------------

def test_invalid_autotune_env_raises(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "sometimes")
    with pytest.raises(ValueError, match="REPRO_AUTOTUNE='sometimes'"):
        be.get_autotune()
    with pytest.raises(ValueError, match="REPRO_AUTOTUNE"):
        blocking.conv_blocking(**L4)
    with pytest.raises(ValueError):
        be.set_autotune("always")
    with pytest.raises(ValueError):
        be.resolve_autotune("always")


def test_autotune_knob_precedence(monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    assert be.get_autotune() == "off"
    monkeypatch.setenv("REPRO_AUTOTUNE", "cache")
    assert be.get_autotune() == "cache"
    with be.use_autotune("tune"):
        assert be.get_autotune() == "tune"
        assert be.resolve_autotune(None) == "tune"
        assert be.resolve_autotune("off") == "off"
    assert be.get_autotune() == "cache"
