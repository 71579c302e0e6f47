"""Depth-first chain fusion in the port against the JAX package.

* The dryrun, the band blocking and the traffic model equal the
  reference's (``build_chain_schedule``, ``chain_blocking``,
  ``chain_traffic`` on every key of ``CHAIN_TRAFFIC_KEYS``) on the sweep of
  ``tests/test_chain_fusion.py`` and on every chain of ResNet-50 (224x224)
  and Inception-v3 (299x299) at batch 16, at the reference's 16 MiB budget
  and at 1 MiB.
* Fused equals unfused inside the port bit for bit (``torch.equal``) under
  both conv tilings, at rb 1, 3 and 100, over the reference's
  stride x filter sweep, the non-divisor tails, a layer on the ref path
  and the bottleneck with its residual.
* Against the JAX package's unfused ``xla`` path: within 1e-5 of max
  |out| for a chain, 1e-4 of max |logit| for reduced ResNet-50's GxM
  forward with the knob on, with the same top-1.
* Training, tapped and int8 forwards never fuse; an invalid knob raises.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocking as jax_blocking
from repro.core import streams as jax_streams
from repro.core.conv import conv2d_fwd as jax_conv2d_fwd
from repro.graph import GxM as JaxGxM
from repro.graph import resnet50 as jax_resnet50
from repro.tune import measure as jax_measure
from repro_torch import backend as be
from repro_torch.convert import params_from_jax
from repro_torch.core import blocking, streams
from repro_torch.core.conv import conv2d_chain_fwd, conv2d_fwd
from repro_torch.core.quantize import calibrate_network, quantize_gxm_params
from repro_torch.graph import GxM, build_etg, executor, inception_v3, resnet50
from repro_torch.graph.serving import conv_shapes
from repro_torch.kernels import conv2d_direct as k1
from repro_torch.launch import roofline
from repro_torch.tune import measure

MIB = 1 << 20
GEO = ("h", "w", "c", "k", "r", "s", "stride", "padding")
TILINGS = ("tiled", "whole")


def _model_chains():
    """Every chain of full ResNet-50 at 224x224 and Inception-v3 at
    299x299: (name of its first conv, per-layer shape dicts)."""
    out = []
    for nl, hw in ((resnet50(), (224, 224)), (inception_v3(), (299, 299))):
        etg = build_etg(nl)
        by = {sh["name"]: sh for sh in conv_shapes(etg, hw)}
        for ch in etg.chains:
            out.append((ch.names[0], [{f: by[n][f] for f in GEO}
                                      for n in ch.names]))
    return out


MODEL_CHAINS = _model_chains()


def _sweep_chains():
    """The chain shapes of ``tests/test_chain_fusion.py``."""
    def lay(h, w, c, k, r, st):
        return dict(h=h, w=w, c=c, k=k, r=r, s=r, stride=st, padding=r // 2)

    def out(h, r, st):
        return (h + 2 * (r // 2) - r) // st + 1
    chains = []
    for r1, s1, r2, s2 in SWEEP:
        chains.append([lay(17, 13, 8, 16, r1, s1),
                       lay(out(17, r1, s1), out(13, r1, s1), 16, 8, r2, s2)])
    chains.append([lay(19, 11, 24, 40, 3, 1), lay(19, 11, 40, 24, 3, 2)])
    chains.append([lay(14, 10, 12, 16, 3, 1), lay(14, 10, 16, 8, 3, 1)])
    for st in (1, 2):
        p = out(20, 3, st)
        chains.append([lay(20, 20, 16, 8, 1, 1), lay(20, 20, 8, 8, 3, st),
                       lay(p, p, 8, 16, 1, 1)])
    chains.append([lay(224, 224, 8, 16, 3, 2), lay(112, 112, 16, 16, 3, 1)])
    return chains


SWEEP = [(1, 1, 3, 1), (3, 1, 1, 2), (3, 2, 3, 1), (1, 2, 1, 1), (3, 2, 3, 2)]


# -- dryrun, blocking and traffic against the reference ------------------------

@pytest.mark.parametrize("rs,h_in,rb", [
    ([(1, 1, 0), (3, 1, 1), (1, 1, 0)], 56, 14),
    ([(1, 1, 0), (3, 2, 1), (1, 1, 0)], 56, 3),
    ([(3, 2, 1), (3, 1, 1)], 224, 9),
    ([(3, 2, 0), (3, 1, 0), (3, 1, 1)], 299, 9),
    ([(3, 1, 1), (3, 2, 1)], 19, 4),
    ([(1, 1, 0), (5, 1, 2)], 35, 100),
])
def test_chain_schedule_equals_the_references(rs, h_in, rb):
    ours = streams.build_chain_schedule(rs=rs, h_in=h_in, rb=rb)
    ref = jax_streams.build_chain_schedule(rs=rs, h_in=h_in, rb=rb)
    for f in ("layer_ids", "band_ids", "o0", "o1", "flags"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
    assert ours.segments == ref.segments and ours.grid == ref.grid
    assert len(ours) == len(ref)
    assert all(bool(f & streams.FLAG_HANDOFF) == (i < len(rs) - 1)
               for i, f in zip(ours.layer_ids, ours.flags))


@pytest.mark.parametrize("budget", [None, MIB])
@pytest.mark.parametrize("where", ["sweep", "models"])
def test_chain_blocking_and_traffic_equal_the_references(where, budget):
    """At the reference's budget (None: its 16 MiB; the port's
    ``CHAIN_BUDGET``) and at 1 MiB, on every chain shape, batch 16."""
    chains = _sweep_chains() if where == "sweep" else \
        [shapes for _, shapes in MODEL_CHAINS]
    assert blocking.CHAIN_BUDGET == jax_blocking.VMEM_BUDGET == 16 * MIB
    for shapes in chains:
        ours = blocking.chain_blocking(shapes, vmem_budget=budget)
        ref = jax_blocking.chain_blocking(shapes, vmem_budget=budget)
        assert ours.__dict__ == ref.__dict__, shapes
        assert blocking.chain_working_set(shapes, rows_out=ours.rb) == \
            jax_blocking.chain_working_set(shapes, rows_out=ours.rb)
        t = measure.chain_traffic(shapes, minibatch=16, vmem_budget=budget)
        r = jax_measure.chain_traffic(shapes, minibatch=16,
                                      vmem_budget=budget)
        for key in measure.CHAIN_TRAFFIC_KEYS:
            assert t[key] == r[key], (shapes[0], key, t[key], r[key])
        assert len(t["parts"]) == len(r["parts"])
        roof = roofline.chain_roofline(t)
        assert roof["fused"] == t["fused"]
        assert roof["launches"] == len(t["parts"])
        assert roof["speedup"] == pytest.approx(1.0) or t["fused"]


def test_model_chains_fuse_as_the_reference_plans():
    """ResNet-50's 16 and Inception-v3's 7 chains: all one band at 16 MiB;
    at 1 MiB, 7 and 5 fuse, in the bands the reference plans."""
    full = [measure.chain_traffic(s, minibatch=16) for _, s in MODEL_CHAINS]
    assert len(full) == 23 and all(t["fused"] and t["n_bands"] == 1
                                   for t in full)
    tight = {name: measure.chain_traffic(s, minibatch=16, vmem_budget=MIB)
             for name, s in MODEL_CHAINS}
    fused = {name: (t["rb"], t["n_bands"]) for name, t in tight.items()
             if t["fused"]}
    assert fused == {"s0b0_c1": (14, 4), "s0b1_c1": (9, 7),
                     "s0b2_c1": (9, 7), "s1b0_c1": (3, 10),
                     "s1b1_c1": (7, 4), "s1b2_c1": (7, 4),
                     "s1b3_c1": (7, 4), "stem1": (9, 17),
                     "mix0_b5x50": (12, 7), "mix0_b3x30": (7, 11),
                     "mix1_b3x30": (4, 19), "mix2_b3x30": (4, 19)}


def test_chain_budget_is_read_at_call_time(monkeypatch):
    shapes = dict(MODEL_CHAINS)["s0b1_c1"]
    monkeypatch.setattr(blocking, "CHAIN_BUDGET", MIB)
    assert blocking.chain_blocking(shapes) == blocking.chain_blocking(
        shapes, vmem_budget=MIB)
    assert measure.chain_traffic(shapes, minibatch=16)["n_bands"] == 7


# -- fused against unfused ------------------------------------------------------

def _layer(rng, c, k, r, stride, *, bn=True, bias=False, relu=True):
    L = dict(w=torch.from_numpy((rng.standard_normal((r, r, c, k)) * 0.1)
                                .astype(np.float32)),
             stride=stride, padding=r // 2, relu=relu)
    if bn:
        L["scale"] = torch.from_numpy(
            (1.0 + 0.2 * rng.standard_normal(k)).astype(np.float32))
        L["shift"] = torch.from_numpy(
            (0.1 * rng.standard_normal(k)).astype(np.float32))
    if bias:
        L["bias"] = torch.from_numpy(
            (0.1 * rng.standard_normal(k)).astype(np.float32))
    return L


def _unfused(x, layers):
    out = x
    for L in layers:
        out = conv2d_fwd(out, L["w"], stride=L["stride"],
                         padding=L["padding"], bias=L.get("bias"),
                         scale=L.get("scale"), shift=L.get("shift"),
                         residual=L.get("residual"),
                         relu=L.get("relu", False), autotune="off")
    return out


def _jax_unfused(x, layers):
    out = jnp.asarray(x.numpy())
    for L in layers:
        kw = {key: jnp.asarray(L[key].numpy()) for key in
              ("bias", "scale", "shift", "residual") if key in L}
        out = jax_conv2d_fwd(out, jnp.asarray(L["w"].numpy()),
                             stride=L["stride"], padding=L["padding"],
                             relu=L.get("relu", False), impl="xla", **kw)
    return np.asarray(out)


def _assert_chain_exact(x, layers, tiling, rbs=(1, 3, 100)):
    with be.use_conv_tiling(tiling):
        want = _unfused(x, layers)
        for rb in rbs:
            got = conv2d_chain_fwd(x, layers, rb=rb, autotune="off")
            assert torch.equal(got, want), f"rb={rb}"
    ref = _jax_unfused(x, layers)
    err = np.abs(got.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err


def _x(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("r1,s1,r2,s2", SWEEP)
def test_two_layer_stride_filter_sweep(tiling, r1, s1, r2, s2):
    rng = np.random.default_rng(7)
    x = _x(rng, 2, 17, 13, 8)
    _assert_chain_exact(x, [_layer(rng, 8, 16, r1, s1),
                            _layer(rng, 16, 8, r2, s2)], tiling)


@pytest.mark.parametrize("tiling", TILINGS)
def test_non_divisor_tails(tiling):
    rng = np.random.default_rng(11)
    x = _x(rng, 1, 19, 11, 24)
    _assert_chain_exact(x, [_layer(rng, 24, 40, 3, 1),
                            _layer(rng, 40, 24, 3, 2, bias=True)], tiling,
                        rbs=(1, 3, 4, 7, 100))


@pytest.mark.parametrize("tiling", TILINGS)
def test_ref_path_layer_in_chain(tiling):
    """C=12 fails the lane rule: that layer's bands take
    ``ref.conv2d_fused``, as its unfused launch does (the C=3 stem's
    case)."""
    rng = np.random.default_rng(13)
    x = _x(rng, 1, 14, 10, 12)
    _assert_chain_exact(x, [_layer(rng, 12, 16, 3, 1),
                            _layer(rng, 16, 8, 3, 1)], tiling,
                        rbs=(1, 2, 3, 5, 100))


@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("stride", (1, 2))
def test_bottleneck_with_residual(tiling, stride):
    rng = np.random.default_rng(17)
    x = _x(rng, 2, 20, 20, 16)
    layers = [_layer(rng, 16, 8, 1, 1), _layer(rng, 8, 8, 3, stride),
              _layer(rng, 8, 16, 1, 1)]
    p_out = (20 + 2 - 3) // stride + 1
    layers[-1]["residual"] = _x(rng, 2, p_out, p_out, 16)
    _assert_chain_exact(x, layers, tiling)


def test_bands_take_the_full_layers_plan(monkeypatch):
    """Every K1 band launch carries the full layer's tile, splits and
    chunk, re-made for the band's pixels; no band shape reaches the plan
    memo."""
    rng = np.random.default_rng(19)
    x = _x(rng, 2, 20, 20, 64)
    layers = [_layer(rng, 64, 64, 1, 1), _layer(rng, 64, 64, 3, 1)]
    seen, orig = [], k1.conv2d_direct

    def spy(xb, w, *, plan=None, **kw):
        seen.append((xb.shape, plan))
        assert xb.is_contiguous()
        return orig(xb, w, plan=plan, **kw)
    monkeypatch.setattr(k1, "conv2d_direct", spy)
    from repro_torch import tune
    tune._memo.clear()
    conv2d_chain_fwd(x, layers, rb=3, autotune="off")
    assert len(seen) == 2 * 7
    full = [k1.mma_plan(n=2, p=20, q=20, c=64, k=64, r=r, s=r)
            for r in (1, 3)]
    for i, (shape, plan) in enumerate(seen):
        want = full[i % 2]
        assert (plan.tile, plan.splits, plan.chunk) == (
            want.tile, want.splits, want.chunk)
    assert {key[2] for key in tune._memo} == {20}


# -- the executor ------------------------------------------------------------------

def _gxm_pair():
    ref = JaxGxM(jax_resnet50(10, stages=(1, 1, 1, 1)), impl="xla",
                 num_classes=10)
    ours = GxM(resnet50(10, stages=(1, 1, 1, 1)), device="cpu",
               num_classes=10)
    import jax
    tree = jax.tree.map(np.array, ref.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for p in tree.values():
        if "var" in p:
            k = p["var"].shape[0]
            p["mean"] = (rng.standard_normal(k) * 0.1).astype(np.float32)
            p["var"] = rng.uniform(0.5, 1.5, k).astype(np.float32)
            p["scale"] = rng.uniform(0.5, 1.5, k).astype(np.float32)
            p["shift"] = (rng.standard_normal(k) * 0.1).astype(np.float32)
    return ours, ref, tree


@pytest.fixture(scope="module")
def gxm_pair():
    return _gxm_pair()


def _counts():
    return executor.chains_fused, executor.chains_unfused


def _reset():
    executor.chains_fused = executor.chains_unfused = 0


@pytest.mark.parametrize("tiling", TILINGS)
def test_gxm_knob_on_fuses_every_chain(gxm_pair, tiling):
    """Reduced ResNet-50 at 32x32 has 4 chains; with the knob on each runs
    fused, the logits equal the knob-off ones bit for bit and the JAX
    package's within 1e-4 of max |logit|, with the same top-1."""
    ours, ref, tree = gxm_pair
    assert len(ours.etg.chains) == 4
    params = params_from_jax(tree, device="cpu")
    x = np.random.default_rng(29).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    with be.use_conv_tiling(tiling):
        with be.use_chain_fusion("off"):
            _reset()
            want = ours.infer(params, torch.from_numpy(x))
            assert _counts() == (0, 0)
        with be.use_chain_fusion("on"):
            got = ours.infer(params, torch.from_numpy(x))
            assert _counts() == (4, 0)
    assert torch.equal(got, want)
    exp = np.asarray(ref.forward(tree, jnp.asarray(x), train=False))
    err = np.abs(got.numpy() - exp).max()
    assert err <= 1e-4 * np.abs(exp).max(), err
    assert (got.numpy().argmax(-1) == exp.argmax(-1)).all()


def test_train_tap_and_int8_never_fuse(gxm_pair, monkeypatch):
    ours, _, tree = gxm_pair
    params = params_from_jax(tree, device="cpu")
    x = torch.from_numpy(np.random.default_rng(31).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    monkeypatch.setattr(executor, "conv2d_chain_fwd",
                        lambda *a, **k: pytest.fail("a chain ran fused"))
    _reset()
    with be.use_chain_fusion("on"):
        ours.forward(params, x, train=True)
        seen = []
        ours.forward(params, x, train=False,
                     tap=lambda name, inp: seen.append(name))
        assert len(seen) == sum(t.op == "conv" for t in ours.etg.tasks)
        assert _counts() == (0, 0)
        q8 = GxM(resnet50(10, stages=(1, 1, 1, 1)), device="cpu",
                 num_classes=10, quantized=True)
        scales = calibrate_network(q8, params, [x.numpy()])
        qparams = quantize_gxm_params(q8.etg, params, scales)
        got = q8.infer(qparams, x)
        assert _counts() == (0, 4)
    with be.use_chain_fusion("off"):
        assert torch.equal(q8.infer(qparams, x), got)


def test_gxm_reads_the_chain_budget_at_each_forward(gxm_pair, monkeypatch):
    """The executor's fuse decision follows ``CHAIN_BUDGET`` as it is at
    each forward: at 4 KiB no chain of reduced ResNet-50 fits."""
    ours, _, tree = gxm_pair
    params = params_from_jax(tree, device="cpu")
    x = torch.from_numpy(np.random.default_rng(37).standard_normal(
        (1, 32, 32, 3)).astype(np.float32))
    with be.use_chain_fusion("on"):
        _reset()
        want = ours.infer(params, x)
        assert _counts() == (4, 0)
        monkeypatch.setattr(blocking, "CHAIN_BUDGET", 4096)
        _reset()
        assert torch.equal(ours.infer(params, x), want)
        assert _counts() == (0, 4)


def test_invalid_chain_fusion_raises(monkeypatch):
    monkeypatch.setenv("REPRO_CHAIN_FUSION", "yes")
    with pytest.raises(ValueError, match="REPRO_CHAIN_FUSION"):
        be.get_chain_fusion()
    with pytest.raises(ValueError, match="chain_fusion"):
        be.set_chain_fusion("auto")
    monkeypatch.setenv("REPRO_CHAIN_FUSION", "on")
    assert be.get_chain_fusion() == "on"
    with be.use_chain_fusion("off"):
        assert be.get_chain_fusion() == "off"
    assert be.get_chain_fusion() == "on"
