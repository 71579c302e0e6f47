"""The tuner's kernel-plan kinds on the CPU: K1's ``MmaPlan`` ("fwd",
"bwd"), K2's ``WuPlan`` ("wu") and K3's ``RingPlan`` ("q8").

* the warmups (``tune.warmup_convs``, ``train.step.warmup_cnn_train``,
  ``CnnInferenceEngine.warmup``) ask for the reference's keys on the same
  GxM (reduced ResNet-50 at 32x32, Inception-v3 at 48x48);
* the default plan is every candidate list's first and in every timed
  shortlist; a tuned plan replaces it only by ``MIN_GAIN``;
* plan entries round-trip through the cache; an entry the kernel cannot
  run misses; ``plan=`` validation raises on each bad field;
* ``core.conv`` passes the kernels exactly their default plans under
  "off" (and with a cold cache under "cache"), and the warmed plans under
  "cache", memoised;
* a "cache" training step after ``warmup_cnn_train`` tunes nothing and
  equals the "off" step (the port's counterpart of the reference's
  ``tests/test_train_cnn.py::test_train_step_consults_warmed_cache``).

Every cache lives under ``tmp_path``."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tune as jax_tune
from repro.graph import GxM as JaxGxM
from repro.graph import inception_v3 as jax_inception_v3
from repro.graph import resnet50 as jax_resnet50
from repro.graph import serving as jax_serving
from repro.train import step as jax_step
from repro_torch import backend as be
from repro_torch import tune
from repro_torch.convert import params_from_jax
from repro_torch.core import conv as core_conv
from repro_torch.core import duality
from repro_torch.graph import GxM, build_etg, inception_v3, resnet50
from repro_torch.graph import serving
from repro_torch.graph.serving import CnnInferenceEngine, conv_shapes
from repro_torch.kernels import conv2d_direct as k1
from repro_torch.kernels import conv2d_q8 as k3
from repro_torch.kernels import conv2d_wu as k2
from repro_torch.train.step import make_cnn_train_step, warmup_cnn_train
from repro_torch.tune import measure, space

from test_torch_executor import _reference_params

FIELDS = ("h", "w", "c", "k", "r", "s", "stride", "padding")
NETS = {
    # name: (port topology, reference topology, image size)
    "resnet50": (lambda: resnet50(10, stages=(1, 1, 1, 1)),
                 lambda: jax_resnet50(10, stages=(1, 1, 1, 1)), 32),
    "inception_v3": (lambda: inception_v3(10),
                     lambda: jax_inception_v3(10), 48),
}


def _full_signatures():
    """Every distinct conv of full ResNet-50 (224x224) and Inception-v3
    (299x299), and the dual convs of their backward-data passes."""
    fwd, dual = set(), set()
    for net, hw in ((resnet50(), 224), (inception_v3(), 299)):
        for sh in conv_shapes(build_etg(net), (hw, hw)):
            fwd.add(tuple(sh[f] for f in FIELDS))
            for d in duality.dual_conv_signatures(
                    r=sh["r"], s=sh["s"], c=sh["c"], k=sh["k"],
                    stride=sh["stride"], padding=sh["padding"],
                    input_hw=(sh["h"], sh["w"])):
                dual.add(tuple(d[f] for f in FIELDS))
    return sorted(fwd), sorted(dual)


FWD_SIGS, DUAL_SIGS = _full_signatures()
L4 = dict(h=56, w=56, c=64, k=64, r=3, s=3, stride=1, padding=1)


def _key_coords(report):
    """(kind, shape, dtype bytes, batch) of each key: the key less its
    backend and card, which differ between the packages by design."""
    return [e["key"].rsplit("|", 2)[0] for e in report]


def _key_channels(key):
    """C and K of a cache key's shape coordinate."""
    c, k = re.search(r"c(\d+)k(\d+)r", key).groups()
    return dict(c=int(c), k=int(k))


def _cache(tmp_path, name="plans.json"):
    return tune.TuneCache(str(tmp_path / name))


# -- the warmups ask for the reference's keys -----------------------------------

@pytest.mark.parametrize("net", list(NETS))
def test_warmup_convs_keys_equal_reference(net, tmp_path):
    ours_nl, ref_nl, image = NETS[net]
    sigs = serving.distinct_conv_signatures(
        conv_shapes(build_etg(ours_nl()), (image, image)))
    ref_sigs = jax_serving.distinct_conv_signatures(
        jax_serving.conv_shapes(JaxGxM(ref_nl(), impl="xla").etg,
                                (image, image)))
    assert sigs == ref_sigs
    for kinds, db in ((("fwd", "bwd", "wu"), 4), (("q8",), 1)):
        ours = tune.warmup_convs(sigs, minibatches=(1, 4), kinds=kinds,
                                 backend="cpu", cache=_cache(tmp_path),
                                 dtype_bytes=db)
        theirs = jax_tune.warmup_convs(
            ref_sigs, minibatches=(1, 4), kinds=kinds, backend="xla",
            cache=jax_tune.TuneCache(str(tmp_path / "ref.json")),
            dtype_bytes=db)
        assert _key_coords(ours) == _key_coords(theirs)
        for e in ours:
            sig = _key_channels(e["key"])
            assert e["cached"] == (e["plan"] is not None)
            # every lane-aligned launch of the kind is tuned, the rest not
            assert e["cached"] == space.plan_applies(
                e["kind"], c=sig["c"], k=sig["k"]), e["key"]


@pytest.mark.parametrize("net", list(NETS))
def test_warmup_cnn_train_keys_equal_reference(net, tmp_path):
    ours_nl, ref_nl, image = NETS[net]
    ours = warmup_cnn_train(GxM(ours_nl(), device="cpu", num_classes=10),
                            image_hw=(image, image), minibatch=2,
                            cache=_cache(tmp_path))
    theirs = jax_step.warmup_cnn_train(
        JaxGxM(ref_nl(), impl="xla", num_classes=10),
        image_hw=(image, image), minibatch=2, backend="xla",
        cache=jax_tune.TuneCache(str(tmp_path / "ref.json")))
    assert _key_coords(ours) == _key_coords(theirs)
    assert {e["kind"] for e in ours} == {"fwd", "bwd", "wu"}
    assert all(e["source"] == "model" for e in ours if e["cached"])
    assert sum(e["cached"] for e in ours) > len(ours) // 2


@pytest.mark.parametrize("net", list(NETS))
@pytest.mark.parametrize("quantized", [False, True])
def test_engine_warmup_keys_equal_reference(net, quantized, tmp_path,
                                            monkeypatch):
    """The engine tunes every signature x bucket batch under "fwd" (or
    "q8" at 1 byte); the reference's ``warmup(compile_buckets=False)``
    under the xla backend asks for the same keys and runs no Pallas.  The
    reference's quantized engine is not calibrated here (its keys do not
    depend on the scales), so its f32 engine's warmup is read with kind
    "q8" by the same ``warmup_convs`` arguments."""
    ours_nl, ref_nl, image = NETS[net]
    seen = {}

    def spy(package, real):
        def wrapped(*args, **kw):
            seen[package] = (kw["kinds"], kw["dtype_bytes"],
                             real(*args, **kw))
            return seen[package][2]
        return wrapped
    monkeypatch.setattr(tune, "warmup_convs", spy("ours", tune.warmup_convs))
    monkeypatch.setattr(jax_tune, "warmup_convs",
                        spy("theirs", jax_tune.warmup_convs))
    ref = JaxGxM(ref_nl(), impl="xla", num_classes=10)
    tree = _reference_params(ref)
    m = GxM(ours_nl(), device="cpu", num_classes=10)
    eng = CnnInferenceEngine(m, params_from_jax(tree, device="cpu"),
                             image_hw=(image, image), max_batch=4,
                             quantized=quantized)
    report = eng.warmup(autotune="tune", cache=_cache(tmp_path))
    jeng = jax_serving.CnnInferenceEngine(
        ref, jax.tree.map(jnp.asarray, tree), image_hw=(image, image),
        max_batch=4, autotune="off")
    jreport = jeng.warmup(autotune="tune", compile_buckets=False,
                          cache=jax_tune.TuneCache(str(tmp_path / "r.json")))
    kinds, db, ours = seen["ours"]
    assert (kinds, db) == ((("q8",), 1) if quantized else (("fwd",), 4))
    if quantized:
        theirs = jax_tune.warmup_convs(
            jax_serving.distinct_conv_signatures(jeng.conv_shapes()),
            minibatches=(1, 2, 4), kinds=("q8",), mode="tune",
            backend="xla", dtype_bytes=1,
            cache=jax_tune.TuneCache(str(tmp_path / "q.json")))
    else:
        assert seen["theirs"][:2] == (("fwd",), 4)
        theirs = seen["theirs"][2]
    assert _key_coords(ours) == _key_coords(theirs)
    assert report["tune_entries"] == sum(e["cached"] for e in ours) > 0
    assert report["buckets"] == jreport["buckets"] == [1, 2, 4]
    assert jreport["compile_s"] == {}


def test_engine_warmup_off_tunes_nothing(tmp_path):
    m = GxM(resnet50(10, stages=(1, 1, 1, 1)), device="cpu", num_classes=10)
    eng = CnnInferenceEngine(m, m.init(torch.Generator().manual_seed(0)),
                             image_hw=(32, 32), max_batch=2)
    c = _cache(tmp_path)
    report = eng.warmup(autotune="off", cache=c)
    assert report["tune_entries"] == 0 and len(c) == 0
    with pytest.raises(ValueError, match="autotune"):
        CnnInferenceEngine(m, {}, autotune="always")


# -- candidates and shortlists --------------------------------------------------

@pytest.mark.parametrize("kind", space.PLAN_KINDS)
def test_default_plan_is_first_of_every_candidate_list(kind):
    sigs = DUAL_SIGS if kind == "bwd" else FWD_SIGS
    for sig in sigs:
        sh = dict(zip(FIELDS, sig))
        if not space.plan_applies(kind, c=sh["c"], k=sh["k"]):
            continue
        for n in (1, 16, 32):
            cands = space.plan_candidates(kind, **sh, minibatch=n)
            assert cands[0] == space.default_plan(kind, n=n, **sh), sig
            assert cands[0] not in cands[1:]
            assert len(cands) == len(set(cands)) <= space.MAX_CANDIDATES
            for plan in cands:
                space.check_plan(kind, plan, n=n, **sh)


def test_default_plans_are_the_kernels_own():
    sh = dict(h=14, w=14, c=256, k=256, r=3, s=3, stride=1, padding=1)
    assert space.default_plan("fwd", n=16, **sh) == k1.mma_plan(
        n=16, p=14, q=14, c=256, k=256, r=3, s=3)
    assert space.default_plan("wu", n=32, **sh) == k2.plan(
        n=32, p=14, q=14, c=256, k=256, r=3, s=3, route="mma")
    assert space.default_plan("q8", n=16, **sh) == k3.ring_plan(
        16, 14, 14, 256, 256, 3, 3, 1)


@pytest.mark.parametrize("kind", space.PLAN_KINDS)
def test_shortlist_always_times_the_default(kind, monkeypatch):
    """On the card the shortlist is the default and the model's best seven
    of the rest, even where the model ranks the default last; the default
    stays the winner unless another plan measured MIN_GAIN faster, there
    and again in turns with the default (default, plan, plan, default)."""
    sh = dict(h=14, w=14, c=256, k=256, r=3, s=3, stride=1, padding=1)
    cands = space.plan_candidates(kind, **sh, minibatch=16)
    default = cands[0]
    timed = []
    monkeypatch.setattr(measure, "plan_cost_us",
                        lambda k, s, pl, minibatch: 0.0 if pl != default
                        else 1e9)
    for win, want in ((0.985, default), (0.97, None)):
        timed.clear()

        def fake(shape, plan, *, kind, minibatch):
            timed.append(plan)
            return 100.0 if plan == default else 100.0 * win
        monkeypatch.setattr(measure, "measure_conv_us", fake)
        ranked = measure.rank_plans(kind, sh, cands, backend="cuda",
                                    minibatch=16)
        short = min(8, len(cands))
        assert timed[0] == default
        assert timed[short:] == ([] if want else
                                 [default, timed[1], timed[1], default])
        assert default in [pl for _, pl in ranked]
        assert ranked[0][1] == (want or timed[1])
    cpu = measure.rank_plans(kind, sh, cands, backend="cpu", minibatch=16)
    assert len(cpu) == len(cands) and cpu[-1][1] == default


@pytest.mark.parametrize("kind", space.PLAN_KINDS)
def test_a_plan_not_faster_in_turns_keeps_the_default(kind, monkeypatch):
    """A plan that read 3 % faster on the shortlist but not when timed
    again in turns with the default does not replace it."""
    sh = dict(h=14, w=14, c=256, k=256, r=3, s=3, stride=1, padding=1)
    cands = space.plan_candidates(kind, **sh, minibatch=16)
    default = cands[0]
    short = min(8, len(cands))
    timed = []

    def fake(shape, plan, *, kind, minibatch):
        timed.append(plan)
        return 97.0 if plan != default and len(timed) <= short else 100.0
    monkeypatch.setattr(measure, "measure_conv_us", fake)
    ranked = measure.rank_plans(kind, sh, cands, backend="cuda",
                                minibatch=16)
    assert len(timed) == short + 4
    assert ranked[0][1] == default


def test_k1_model_ranks_its_default_first():
    """K1's default is the least of its own cost: the model's first."""
    for sig in FWD_SIGS[::4]:
        sh = dict(zip(FIELDS, sig))
        cands = space.plan_candidates("fwd", **sh, minibatch=16)
        ranked = measure.rank_plans("fwd", sh, cands, backend="cpu",
                                    minibatch=16)
        assert ranked[0][1] == cands[0], sig


# -- the cache ------------------------------------------------------------------

@pytest.mark.parametrize("kind", space.PLAN_KINDS)
def test_plan_entry_roundtrips(kind, tmp_path):
    c = _cache(tmp_path)
    kw = dict(L4, kind=kind, backend="cpu", minibatch=4)
    assert tune.lookup_plan(**kw, cache=c) is None                 # cold
    plan = tune.autotune_plan(**kw, cache=c)
    fresh = tune.TuneCache(c.path)                                 # new proc
    assert tune.lookup_plan(**kw, cache=fresh) == plan
    entry = fresh.lookup(tune.conv_key(
        dtype_bytes=tune.plan_dtype_bytes(kind), **kw))
    assert entry["source"] == "model"
    assert entry["blocking"] == dataclasses.asdict(plan)
    assert entry["candidates"] == len(space.plan_candidates(
        kind, **L4, minibatch=4)) and entry["timed"] == 0
    # a ConvBlocking under the same key is no plan, and a plan no blocking
    assert tune.lookup_conv(**kw, cache=fresh) is None


@pytest.mark.parametrize("kind", space.PLAN_KINDS)
def test_invalid_plan_entry_misses(kind, tmp_path):
    c = _cache(tmp_path)
    kw = dict(L4, kind=kind, backend="cpu", minibatch=4)
    key = tune.conv_key(dtype_bytes=tune.plan_dtype_bytes(kind), **kw)
    good = dataclasses.asdict(space.default_plan(kind, n=4, **L4))
    bad = [dict(good, splits=0), dict(good, splits=10 ** 6),
           {f: v for f, v in good.items() if f != "splits"},
           dict(good, splits=float(good["splits"])),
           dict(good, tile=99) if "tile" in good else dict(good, bm=96),
           dict(rb_p=1, k_blk=64, c_blk=64, order="nkpc", vmem_bytes=1,
                rb_q=56)]
    for blob in bad:
        c.store(key, blob, source="model", score_us=1.0, persist=False)
        assert tune.lookup_plan(**kw, cache=c) is None, blob
        # a miss takes the kernel's default plan
        with be.use_autotune("cache"):
            got = tune.resolve_plan(kind, n=4, **L4, backend="cpu")
        assert got == space.default_plan(kind, n=4, **L4)
    c.store(key, good, source="model", score_us=1.0, persist=False)
    assert tune.lookup_plan(**kw, cache=c) is not None
    # the same entry for another batch: its blocks and tiles disagree
    other = dict(kw, minibatch=8)
    c.store(tune.conv_key(dtype_bytes=tune.plan_dtype_bytes(kind), **other),
            good, source="model", score_us=1.0, persist=False)
    if kind != "wu":                 # a WuPlan holds no batch-bound field
        assert tune.lookup_plan(**other, cache=c) is None


def test_conv_blocking_leaves_plan_kinds_to_their_plans(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "b.json"))
    from repro_torch.core import blocking
    with be.use_autotune("tune"):
        got = blocking.conv_blocking(**L4, kind="fwd", backend="cpu")
    assert got == blocking.conv_blocking_analytic(**L4, kind="fwd")
    assert not (tmp_path / "b.json").exists()
    with pytest.raises(ValueError, match="kernel plan"):
        tune.autotune_conv(**L4, kind="wu", backend="cpu")


def test_k3_split_scratch_grows_to_any_plan():
    k3._ring_scratch.clear()
    part, count = k3._scratch(torch.device("cpu"), 0, 100, 10)
    assert part.numel() == 100 and count.numel() == 10
    assert not count.any()
    part2, count2 = k3._scratch(torch.device("cpu"), 0, 50, 40)
    assert part2.numel() == 100 and count2.numel() == 40
    part3, _ = k3._scratch(torch.device("cpu"), 0, 1000, 1)
    assert part3.numel() == 1000
    k3._ring_scratch.clear()


# -- validation of plan= --------------------------------------------------------

def _k1_args(c=64, k=64, n=2, h=9):
    g = torch.Generator().manual_seed(0)
    return dict(x=torch.randn((n, h, h, c), generator=g),
                w=torch.randn((3, 3, c, k), generator=g), padding=1)


def test_k1_plan_validation_raises_on_each_field():
    a = _k1_args()
    good = k1.mma_plan(n=2, p=9, q=9, c=64, k=64, r=3, s=3)
    steps = k1.mma_steps(c=64, r=3, s=3)
    ok = k1.conv2d_direct(**a, plan=good)
    assert torch.equal(ok, k1.conv2d_direct(**a))
    bad = {
        "not one of MMA_TILES": dataclasses.replace(good, tile=7),
        "splits": dataclasses.replace(good, splits=0),
        "1 to 65535": k1.MmaPlan(0, 70000, 1, 1),
        "do not cover": k1.make_mma_plan(n=2, p=9, q=9, k=64, tile=0,
                                         splits=1, chunk=steps - 1),
        "empty": k1.make_mma_plan(n=2, p=9, q=9, k=64, tile=0, splits=2,
                                  chunk=steps),
        "blocks": dataclasses.replace(good, blocks=good.blocks + 1),
        "MmaPlan": k2.WuPlan(0, 1, 32, "mma"),
    }
    for what, plan in bad.items():
        with pytest.raises(ValueError, match=what):
            k1.conv2d_direct(**a, plan=plan)
    with pytest.raises(ValueError, match="simt"):
        k1.conv2d_direct(**_k1_args(c=6), plan=good)


def test_k2_plan_validation_raises_on_each_field():
    g = torch.Generator().manual_seed(1)
    a = dict(x=torch.randn((2, 9, 9, 64), generator=g),
             do=torch.randn((2, 9, 9, 32), generator=g), padding=1,
             filter_rs=(3, 3))
    good = k2.plan(n=2, p=9, q=9, c=64, k=32, r=3, s=3, route="mma")
    assert torch.equal(k2.conv2d_wu(**a, plan=good), k2.conv2d_wu(**a))
    bad = {
        "mma route only": dataclasses.replace(good, route="simt"),
        "not one of MMA_TILES": dataclasses.replace(good, tile=5),
        "whole stages": dataclasses.replace(good, chunk=good.chunk + 1),
        "z dimension": dataclasses.replace(good, splits=10 ** 4),
        "do not cover": k2.WuPlan(0, 1, 32, "mma"),
        "empty": k2.WuPlan(0, 2, 192, "mma"),
        "WuPlan": k1.MmaPlan(0, 1, 1, 1),
    }
    for what, plan in bad.items():
        with pytest.raises(ValueError, match=what):
            k2.conv2d_wu(**a, plan=plan)
    with pytest.raises(ValueError, match="simt"):
        k2.conv2d_wu(**{**a, "x": torch.randn((2, 9, 9, 6))}, plan=good)


def test_k3_plan_validation_raises_on_each_field():
    g = torch.Generator().manual_seed(2)
    x_q, w_q, xs, ws = k3.quantize_conv_inputs(
        torch.randn((2, 9, 9, 64), generator=g),
        torch.randn((3, 3, 64, 48), generator=g))
    a = dict(x_q=x_q, w_q=w_q, x_scale=xs, w_scale=ws, padding=1)
    good = k3.ring_plan(2, 9, 9, 64, 48, 3, 3, 1)
    assert torch.equal(k3.conv2d_q8(**a, plan=good), k3.conv2d_q8(**a))
    split = k3.make_ring_plan(n=2, p=9, q=9, c=64, k=48, r=3, s=3, bm=64,
                              bn=64, bk=64, splits=3)
    assert torch.equal(k3.conv2d_q8(**a, plan=split), k3.conv2d_q8(**a))
    bad = {
        "RING_TILES": dataclasses.replace(good, bm=96),
        "the ring stages": dataclasses.replace(good, bk=32),
        "over C": k3.make_ring_plan(n=2, p=9, q=9, c=64, k=48, r=3, s=3,
                                    bm=64, bn=64, bk=128, splits=1),
        "splits of 9 steps": dataclasses.replace(good, splits=10),
        "stages=": dataclasses.replace(good, stages=good.stages + 1),
        "smem=": dataclasses.replace(good, smem=good.smem + 16),
        "tiles=": dataclasses.replace(good, tiles=good.tiles + 1),
        "ctas=": dataclasses.replace(split, ctas=split.ctas - 1),
        "RingPlan": k1.MmaPlan(0, 1, 1, 1),
    }
    for what, plan in bad.items():
        with pytest.raises(ValueError, match=what):
            k3.conv2d_q8(**a, plan=plan)
    x8, w8, xs8, ws8 = k3.quantize_conv_inputs(torch.randn((2, 9, 9, 8)),
                                               torch.randn((3, 3, 8, 8)))
    with pytest.raises(ValueError, match="sync"):
        k3.conv2d_q8(x_q=x8, w_q=w8, x_scale=xs8, w_scale=ws8, padding=1,
                     plan=good)


# -- what core.conv passes the kernels ------------------------------------------

@pytest.fixture
def spies(monkeypatch):
    """Every plan core.conv hands K1, K2 and K3, with the shapes."""
    got = []

    def spy(name, real, shape_of):
        def wrapped(*args, plan=None, **kw):
            got.append((name, shape_of(*args, **kw), plan))
            return real(*args, plan=plan, **kw)
        monkeypatch.setattr(core_conv, real.__name__, wrapped)

    def k1_shape(x, w, stride=1, padding=0, **_):
        return dict(n=x.shape[0], h=x.shape[1], w=x.shape[2], c=x.shape[3],
                    k=w.shape[3], r=w.shape[0], s=w.shape[1], stride=stride,
                    padding=padding)

    def k2_shape(x, do, stride=1, padding=0, filter_rs=None, **_):
        return dict(n=x.shape[0], h=x.shape[1], w=x.shape[2], c=x.shape[3],
                    k=do.shape[3], r=filter_rs[0], s=filter_rs[1],
                    stride=stride, padding=padding)

    def k3_shape(x_q, w_q, stride=1, padding=0, **_):
        return k1_shape(x_q, w_q, stride, padding)
    spy("fwd", k1.conv2d_direct, k1_shape)
    spy("wu", k2.conv2d_wu, k2_shape)
    spy("q8", k3.conv2d_q8, k3_shape)
    return got


def _tiny_run(image=32, n=2):
    """One reduced ResNet-50 training step, f32 forward and int8 forward
    on the CPU; returns what they computed."""
    m = GxM(resnet50(10, stages=(1, 1, 1, 1)), device="cpu", num_classes=10)
    params = m.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"image": rng.standard_normal((n, image, image, 3)).astype(
        np.float32), "label": rng.integers(0, 10, n)}
    new, loss = make_cnn_train_step(m, lr=0.1)(params, batch)
    logits = m.infer(params, torch.from_numpy(batch["image"]))
    eng = CnnInferenceEngine(
        GxM(resnet50(10, stages=(1, 1, 1, 1)), device="cpu",
            num_classes=10), params, image_hw=(image, image),
        buckets=(n,), quantized=True, autotune=None)
    eng.calibrate()
    q8 = eng.infer(batch["image"])
    return new, loss, logits, q8


def _defaults_only(got):
    assert {name for name, _, _ in got} == {"fwd", "wu", "q8"}
    for name, sh, plan in got:
        n, rest = sh["n"], {f: sh[f] for f in FIELDS}
        kind = "fwd" if name == "fwd" else name
        assert plan == space.default_plan(kind, n=n, **rest), (name, sh)


@pytest.mark.parametrize("mode", ["off", "cache"])
def test_default_plans_reach_the_kernels(mode, spies, tmp_path, monkeypatch):
    """Under "off", and under "cache" with a cold cache, every launch takes
    exactly the kernel's default plan (``mma_plan``, ``plan(route="mma")``,
    ``ring_plan``); a lane-aligned conv never goes without one."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "cold.json"))
    with be.use_autotune(mode):
        _tiny_run()
    assert spies and all(plan is not None for _, _, plan in spies)
    _defaults_only(spies)
    assert not (tmp_path / "cold.json").exists()


def test_unset_knob_is_off(spies, monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    _tiny_run()
    _defaults_only(spies)


def test_cache_mode_passes_the_warmed_plan(spies, tmp_path, monkeypatch):
    """A plan stored for one signature (its forward and its dual conv,
    which share the shape here) reaches that signature's launches and no
    other."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "w.json"))
    sh = dict(h=8, w=8, c=64, k=64, r=3, s=3, stride=1, padding=1)
    cands = space.plan_candidates("fwd", **sh, minibatch=2)
    pick = cands[-1]
    for kind in ("fwd", "bwd"):
        tune.default_cache().store(
            tune.conv_key(dtype_bytes=4, **sh, kind=kind, backend="cpu",
                          minibatch=2),
            dataclasses.asdict(pick), source="model", score_us=1.0)
    with be.use_autotune("cache"):
        _tiny_run()
    hits = [(sh_, plan) for name, sh_, plan in spies if name == "fwd"
            and {f: sh_[f] for f in FIELDS} == sh and sh_["n"] == 2]
    assert hits and all(plan == pick for _, plan in hits)
    others = [(name, s_, plan) for name, s_, plan in spies
              if (name, s_) not in [("fwd", s2) for s2, _ in hits]]
    _defaults_only(others + [("fwd", hits[0][0],
                              space.default_plan("fwd", n=2, **sh))])


def test_resolve_plan_memo(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "m.json"))
    sh = dict(L4, backend="cpu")
    tune.memo_hits = tune.memo_misses = 0
    with be.use_autotune("cache"):
        first = tune.resolve_plan("wu", n=4, **sh)
        again = tune.resolve_plan("wu", n=4, **sh)
        assert first == again == space.default_plan("wu", n=4, **L4)
        assert (tune.memo_hits, tune.memo_misses) == (1, 1)
        # a store moves TuneCache.changes: the next call asks again
        pick = space.plan_candidates("wu", **L4, minibatch=4)[-1]
        tune.default_cache().store(
            tune.conv_key(kind="wu", **L4, dtype_bytes=4, backend="cpu",
                          minibatch=4), dataclasses.asdict(pick),
            source="model", score_us=1.0, persist=False)
        assert tune.resolve_plan("wu", n=4, **sh) == pick
        assert tune.resolve_plan("wu", n=4, **sh) == pick
        assert (tune.memo_hits, tune.memo_misses) == (2, 2)
    assert tune.resolve_plan("wu", n=4, **sh, autotune="off") == first


# -- a "cache" step after warmup_cnn_train --------------------------------------

def test_cache_step_after_warmup_tunes_nothing(tmp_path, monkeypatch):
    """The port's counterpart of the reference's
    ``test_train_step_consults_warmed_cache``: after ``warmup_cnn_train``
    a "cache" step takes a warmed plan for every launch (no lookup
    misses), times nothing, and its repeats are memo hits.  Its loss and
    update equal the "off" step's bit for bit: on the CPU every plan runs
    the same plain version (tolerance 0)."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "t.json"))
    m = GxM(resnet50(10, stages=(1, 1, 1, 1)), device="cpu", num_classes=10)
    params = m.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    batch = {"image": rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32), "label": rng.integers(0, 10, 2)}
    base, loss_base = make_cnn_train_step(m, lr=0.1, autotune="off")(
        params, batch)
    report = warmup_cnn_train(m, image_hw=(32, 32), minibatch=2)
    assert sum(e["cached"] for e in report) > 0
    misses = []
    real_lookup = tune.lookup_plan

    def lookup(**kw):
        got = real_lookup(**kw)
        if got is None:
            misses.append(kw)
        return got
    monkeypatch.setattr(tune, "lookup_plan", lookup)
    monkeypatch.setattr(tune, "autotune_plan", None)      # never tunes
    before = measure.measurements
    step = make_cnn_train_step(m, lr=0.1, autotune="cache")
    tune.memo_hits = tune.memo_misses = 0
    got, loss_got = step(params, batch)
    first_misses = tune.memo_misses
    assert misses == [] and first_misses > 0
    step(params, batch)
    assert tune.memo_misses == first_misses          # all memo hits now
    assert tune.memo_hits >= first_misses
    assert measure.measurements == before
    assert torch.equal(loss_got, loss_base)
    for name, p in base.items():
        for leaf, v in p.items():
            assert torch.equal(got[name][leaf], v), (name, leaf)


def test_plan_ab_smoke_on_the_cpu(tmp_path, monkeypatch):
    """``launch.plan_ab`` end to end at its smoke size: it tunes a step's
    plans into its own temporary cache, rewrites every entry to the
    default plan, and times the three modes in turns."""
    from repro_torch.launch import plan_ab
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "untouched.json"))
    out = plan_ab.main(["--smoke", "--device", "cpu"])
    assert out["plans"] == out["default_entries"] > 0
    for mode in plan_ab.MODES:
        assert out[mode]["q1_ms"] <= out[mode]["median_ms"] \
            <= out[mode]["q3_ms"]
    assert 0 <= out["tuned_wins_of_rounds"] <= out["rounds"] == 2
    assert out["resolve_plan_us_off"] > 0 and out["resolve_plan_us_cache"] > 0
    assert not (tmp_path / "untouched.json").exists()


def test_plan_ab_serve_smoke_on_the_cpu(tmp_path, monkeypatch):
    """``launch.plan_ab --serve`` at its smoke size: both precisions, both
    modes, a window each in turns, no write to the process's cache."""
    from repro_torch.launch import plan_ab
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "untouched.json"))
    out = plan_ab.main(["--serve", "--smoke", "--device", "cpu"])["serve"]
    for name in ("f32", "int8"):
        for mode in ("off", "cache"):
            assert len(out[name][mode]["images_per_s"]) == 2
            assert out[name][mode]["median_images_per_s"] > 0
        assert 0 <= out[name]["tuned_wins_of_rounds"] <= 2
    assert not (tmp_path / "untouched.json").exists()
