"""The §II-D tuner over the whole-plane kernels' blockings: the kinds
"fwd_whole", "bwd_whole" (K10a), "q8_whole" (K10c) and "wu_whole" (K10b),
each a ``ConvBlocking`` (rb_p, k_blk).

* Candidates: from ``conv_candidates`` at the reference's budget, one per
  (rb_p, k_blk), k_blk dividing K, rb_p dividing P for "wu_whole", each
  one the kernel runs, the analytic blocking first.
* "off" returns today's blocking: the reference's ``conv_blocking`` at its
  16 MiB budget, whatever the cache holds.
* Cache keys: the serving and training warmups under ``whole`` write the
  whole kinds' keys and the reference's signatures.
* Ranking: the model alone on the CPU; on the card the analytic blocking
  and the model's 7 best, timed, the analytic kept unless another is
  ``MIN_GAIN`` faster.
* A chain under ``whole`` takes its layers' tuned full-shape blockings in
  every band.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import blocking as jax_blocking
from repro_torch import backend as be
from repro_torch import tune
from repro_torch.core import conv
from repro_torch.core.blocking import ConvBlocking
from repro_torch.graph import GxM, resnet50
from repro_torch.graph.serving import CnnInferenceEngine
from repro_torch.kernels import conv2d_direct as k1
from repro_torch.train.step import warmup_cnn_train
from repro_torch.tune import measure, space

FIELDS = ("h", "w", "c", "k", "r", "s", "stride", "padding")
# ResNet-50 signatures: stem-stage 1x1 and 3x3, a strided 3x3, the
# projection, the 7x7 3x3 and 1x1
SIGS = [(56, 56, 64, 64, 1, 1, 1, 0), (56, 56, 64, 64, 3, 3, 1, 1),
        (56, 56, 128, 128, 3, 3, 2, 1), (56, 56, 256, 512, 1, 1, 2, 0),
        (7, 7, 512, 512, 3, 3, 1, 1), (7, 7, 512, 2048, 1, 1, 1, 0)]
SMALL = dict(h=8, w=8, c=16, k=32, r=3, s=3, stride=1, padding=1)


def _cache(tmp_path):
    return tune.TuneCache(str(tmp_path / "whole.json"))


@pytest.mark.parametrize("kind", space.WHOLE_KINDS)
def test_candidates(kind):
    base = space.whole_base(kind)
    for sig in SIGS:
        sh = dict(zip(FIELDS, sig))
        p = space.out_dim(sh["h"], sh["r"], sh["stride"], sh["padding"])
        cands = space.plan_candidates(kind, **sh, minibatch=16)
        assert cands[0] == space.default_plan(kind, n=16, **sh)
        assert dataclasses.asdict(cands[0]) == dataclasses.asdict(
            jax_blocking.conv_blocking(
                **sh, dtype_bytes=1 if base == "q8" else 4,
                require_divisor=base == "wu", backend="xla",
                autotune="off", kind=base))
        pairs = [(b.rb_p, b.k_blk) for b in cands]
        assert len(pairs) == len(set(pairs)) <= space.MAX_CANDIDATES
        assert len(cands) > 1, sig
        for blk in cands:
            assert isinstance(blk, ConvBlocking)
            assert sh["k"] % blk.k_blk == 0 and blk.k_blk % 8 == 0
            if base == "wu":
                assert p % blk.rb_p == 0
            space.check_plan(kind, blk, n=16, **sh)


@pytest.mark.parametrize("kind", space.WHOLE_KINDS)
def test_off_is_todays_blocking_and_cache_takes_the_entry(kind, tmp_path,
                                                          monkeypatch):
    """Under "off" ``whole_blocking`` is the reference's analytic blocking
    whatever the cache holds; under "cache" it takes a stored entry; an
    entry the kernel cannot run misses and falls back to the analytic."""
    base = space.whole_base(kind)
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "whole.json"))
    c = tune.default_cache()
    sh = dict(zip(FIELDS, SIGS[1]))
    x_shape, w_shape = (4, sh["h"], sh["w"], sh["c"]), (3, 3, sh["c"],
                                                        sh["k"])
    analytic = space.default_plan(kind, n=4, **sh)
    other = next(b for b in space.plan_candidates(kind, **sh, minibatch=4)
                 if b != analytic)
    key = tune.conv_key(kind=kind, **sh, minibatch=4, backend="cpu",
                        dtype_bytes=tune.plan_dtype_bytes(kind))
    c.store(key, dataclasses.asdict(other), source="model", score_us=1.0)

    def got(mode):
        return conv.whole_blocking(x_shape, w_shape, stride=1, padding=1,
                                   kind=base, backend="cpu", autotune=mode)
    assert got("off") == analytic
    with be.use_autotune("off"):
        assert conv.whole_blocking(x_shape, w_shape, stride=1, padding=1,
                                   kind=base) == analytic
    assert got("cache") == other
    good = dataclasses.asdict(other)
    for bad in (dict(good, k_blk=24), dict(good, k_blk=256),
                {f: v for f, v in good.items() if f != "rb_p"},
                dict(good, rb_p=float(good["rb_p"])),
                dataclasses.asdict(k1.mma_plan(n=4, p=56, q=56, c=64, k=64,
                                               r=3, s=3))):
        c.store(key, bad, source="model", score_us=1.0)
        assert got("cache") == analytic, bad
    if base == "wu":
        c.store(key, dict(good, rb_p=5), source="model", score_us=1.0)
        assert got("cache") == analytic


@pytest.mark.parametrize("kind", space.WHOLE_KINDS)
def test_entry_roundtrips_and_cpu_ranks_by_the_model(kind, tmp_path):
    c = _cache(tmp_path)
    kw = dict(SMALL, kind=kind, backend="cpu", minibatch=2)
    assert tune.lookup_plan(**kw, cache=c) is None
    best = tune.autotune_plan(**kw, cache=c)
    fresh = tune.TuneCache(c.path)
    assert tune.lookup_plan(**kw, cache=fresh) == best
    entry = fresh.lookup(tune.conv_key(
        dtype_bytes=tune.plan_dtype_bytes(kind), **kw))
    assert entry["source"] == "model" and entry["timed"] == 0
    cands = space.plan_candidates(kind, **SMALL, minibatch=2)
    ranked = measure.rank_plans(kind, SMALL, cands, backend="cpu",
                                minibatch=2)
    assert len(ranked) == len(cands) and ranked[0][1] == best
    scores = [s for s, _ in ranked]
    assert scores == sorted(scores)
    with pytest.raises(ValueError, match="kernel plan"):
        tune.autotune_conv(**kw, cache=c)


@pytest.mark.parametrize("kind", space.WHOLE_KINDS)
def test_shortlist_times_the_analytic_and_seven(kind, monkeypatch):
    sh = dict(zip(FIELDS, SIGS[1]))
    cands = space.plan_candidates(kind, **sh, minibatch=16)
    default = cands[0]
    timed = []
    for win, want in ((0.985, default), (0.97, None)):
        timed.clear()

        def fake(shape, blk, *, kind, minibatch):
            timed.append(blk)
            return 100.0 if blk == default else 100.0 * win
        monkeypatch.setattr(measure, "measure_conv_us", fake)
        ranked = measure.rank_plans(kind, sh, cands, backend="cuda",
                                    minibatch=16)
        short = min(8, len(cands))
        assert timed[0] == default
        assert timed[short:] == ([] if want else
                                 [default, timed[1], timed[1], default])
        assert ranked[0][1] == (want or timed[1])


def test_warmups_under_whole_write_the_whole_keys(tmp_path):
    """Serving (f32, buckets 1 and 2) and training warmups under ``whole``
    tune the whole kinds on the lane-aligned signatures; under ``tiled``
    the same warmups write none of them."""
    c = _cache(tmp_path)
    nl = resnet50(10, stages=(1, 1, 1, 1))
    gxm = GxM(nl, device="cpu", num_classes=10)
    params = gxm.init()
    eng = CnnInferenceEngine(gxm, params, image_hw=(32, 32), max_batch=2)
    with be.use_conv_tiling("whole"):
        rep = eng.warmup(autotune="tune", cache=c)
        train = warmup_cnn_train(gxm, image_hw=(32, 32), minibatch=2,
                                 mode="tune", cache=c)
    kinds = {key.split("|")[1] for key in c._entries}
    assert kinds == {"fwd_whole", "bwd_whole", "wu_whole"}
    assert rep["tune_entries"] == 2 * rep["kernel_path_signatures"]
    assert {e["kind"] for e in train} == {"fwd_whole", "bwd_whole",
                                          "wu_whole"}
    assert all(e["cached"] == (e["plan"] is not None) for e in train)
    n_whole = len(c)
    with be.use_conv_tiling("tiled"):
        warmup_cnn_train(gxm, image_hw=(32, 32), minibatch=2, mode="tune",
                         cache=c)
    assert {key.split("|")[1] for key in c._entries} - kinds == {
        "fwd", "bwd", "wu"} and len(c) > n_whole


def test_chain_bands_take_the_tuned_blocking(tmp_path, monkeypatch):
    """Under ``whole`` and "cache" every band launch of a chain layer takes
    the layer's tuned full-shape blocking, and fused equals unfused."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "whole.json"))
    c = tune.default_cache()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 32))
                         .astype(np.float32))
    ws = [torch.from_numpy((rng.standard_normal((r, r, 32, 32)) * 0.1)
                           .astype(np.float32)) for r in (1, 3)]
    layers = [dict(w=w, stride=1, padding=w.shape[0] // 2, relu=True)
              for w in ws]
    tuned = []
    for w in ws:
        r = w.shape[0]
        sh = dict(h=16, w=16, c=32, k=32, r=r, s=r, stride=1, padding=r // 2)
        blk = ConvBlocking(rb_p=3, k_blk=16, c_blk=32, order="nkpc",
                           vmem_bytes=1, rb_q=0)
        c.store(tune.conv_key(kind="fwd_whole", **sh, dtype_bytes=4,
                              backend="cpu", minibatch=2),
                dataclasses.asdict(blk), source="model", score_us=1.0)
        tuned.append(blk)
    seen, orig = [], k1.conv2d_direct_whole

    def spy(xb, w, *, rb_p, k_blk, **kw):
        seen.append((rb_p, k_blk))
        return orig(xb, w, rb_p=rb_p, k_blk=k_blk, **kw)
    monkeypatch.setattr(k1, "conv2d_direct_whole", spy)
    with be.use_conv_tiling("whole"), be.use_autotune("cache"):
        want = x
        for L in layers:
            want = conv.conv2d_fwd(want, L["w"], stride=1,
                                   padding=L["padding"], relu=True)
        seen.clear()
        got = conv.conv2d_chain_fwd(x, layers, rb=4)
    assert torch.equal(got, want)
    assert seen == [(3, 16), (3, 16)] * 4
