"""The port's training conv on the CPU against the JAX package: dI by
duality (plain path through ``conv2d_train``), dW, K2's plain version, and
the phase/dilate plans, on the scenarios of ``tests/test_duality.py`` with
the same numpy inputs on both sides.

Limit: max |diff| <= 1e-4 * max |ref|.  Both sides sum in f32, in other
orders, through a sin() loss."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jax_pallas

from repro.core import conv as jax_conv
from repro.core import duality as jax_duality
from repro.graph import inception_v3 as jax_inception_v3
from repro.graph import resnet50 as jax_resnet50
from repro.graph.etg import build_etg as jax_build_etg
from repro.graph.serving import conv_shapes as jax_conv_shapes
from repro.kernels import ref as jax_ref
from repro.kernels.conv2d_wu import conv2d_wu as jax_conv2d_wu
from repro_torch.core import duality
from repro_torch.core.conv import (conv2d_bwd_data_via_fwd,
                                   conv2d_bwd_weights, conv2d_train)
from repro_torch.graph import build_etg, inception_v3, resnet50
from repro_torch.graph.serving import conv_shapes
from repro_torch.kernels import conv2d_wu as k2
from repro_torch.kernels import ref

SCENARIOS = [
    # (h, c, k, r, stride, pad, label) as in tests/test_duality.py
    (8, 8, 16, 3, 1, 1, "stride1"),
    (8, 8, 8, 1, 2, 0, "1x1_strided"),
    (16, 8, 8, 3, 2, 1, "generic"),
    (9, 8, 8, 3, 2, 1, "generic_odd"),
    (11, 8, 8, 5, 3, 2, "generic_aggressive"),
    (24, 8, 16, 7, 2, 3, "stem_7x7_s2"),
    (13, 24, 40, 3, 2, 1, "nondivisor_pck_tails"),
]
IDS = [c[-1] for c in SCENARIOS]
REL = 1e-4


def _close(got, exp):
    got = np.asarray(got)
    exp = np.asarray(exp)
    assert got.shape == exp.shape, (got.shape, exp.shape)
    err = float(np.abs(got - exp).max())
    assert err <= REL * float(np.abs(exp).max()), err


def _data(case, seed=0):
    h, c, k, r, stride, pad, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, h, c)).astype(np.float32)
    w = (rng.standard_normal((r, r, c, k)) * 0.1).astype(np.float32)
    return x, w


def _jax_grads(case, x, w):
    """JAX's conv2d_train VJP (impl="xla") of sum(sin(conv))."""
    stride, pad = case[4], case[5]

    def loss(x, w):
        return jnp.sum(jnp.sin(jax_conv.conv2d_train(x, w, stride, pad,
                                                     "xla")))
    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))


def _port_grads(case, x, w):
    stride, pad = case[4], case[5]
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    torch.sin(conv2d_train(xt, wt, stride, pad)).sum().backward()
    return xt.grad, wt.grad


@pytest.mark.parametrize("case", SCENARIOS, ids=IDS)
def test_train_conv_grads_match_jax_vjp(case):
    x, w = _data(case)
    gx, gw = _port_grads(case, x, w)
    ex, ew = _jax_grads(case, x, w)
    _close(gx.numpy(), ex)
    _close(gw.numpy(), ew)


@pytest.mark.parametrize("case", SCENARIOS, ids=IDS)
def test_bwd_oracles_match_jax_ref(case):
    """The port's ``ref.conv2d_bwd_*`` and the dispatching
    ``conv2d_bwd_data_via_fwd`` / ``conv2d_bwd_weights`` against JAX's
    ``ref.conv2d_bwd_*`` on one dO."""
    h, c, k, r, stride, pad, _ = case
    x, w = _data(case)
    p = (h + 2 * pad - r) // stride + 1
    do = np.random.default_rng(1).standard_normal((2, p, p, k)).astype(
        np.float32)
    exp_di = jax_ref.conv2d_bwd_data(jnp.asarray(do), jnp.asarray(w),
                                     stride=stride, padding=pad,
                                     input_hw=(h, h))
    exp_dw = jax_ref.conv2d_bwd_weights(jnp.asarray(x), jnp.asarray(do),
                                        stride=stride, padding=pad,
                                        filter_rs=(r, r))
    tdo, tw, tx = map(torch.from_numpy, (do, w, x))
    _close(ref.conv2d_bwd_data(tdo, tw, stride=stride, padding=pad,
                               input_hw=(h, h)).numpy(), exp_di)
    _close(ref.conv2d_bwd_weights(tx, tdo, stride=stride, padding=pad,
                                  filter_rs=(r, r)).numpy(), exp_dw)
    _close(conv2d_bwd_data_via_fwd(tdo, tw, stride=stride, padding=pad,
                                   input_hw=(h, h)).numpy(), exp_di)
    _close(conv2d_bwd_weights(tx, tdo, stride=stride, padding=pad,
                              filter_rs=(r, r)).numpy(), exp_dw)


@pytest.mark.parametrize("case", SCENARIOS, ids=IDS)
def test_wu_plain_matches_jax_ref(case):
    h, c, k, r, stride, pad, _ = case
    x, _ = _data(case)
    p = (h + 2 * pad - r) // stride + 1
    do = np.random.default_rng(2).standard_normal((2, p, p, k)).astype(
        np.float32)
    got = k2.conv2d_wu_plain(torch.from_numpy(x), torch.from_numpy(do),
                             stride=stride, padding=pad, filter_rs=(r, r))
    exp = jax_ref.conv2d_bwd_weights(jnp.asarray(x), jnp.asarray(do),
                                     stride=stride, padding=pad,
                                     filter_rs=(r, r))
    _close(got.numpy(), exp)


@pytest.mark.parametrize("case", SCENARIOS[:3], ids=IDS[:3])
def test_wu_plain_matches_jax_interpret_kernel(case):
    if not hasattr(jax_pallas, "unblocked"):
        pytest.skip("this jax's Pallas has no `unblocked`: the JAX kernel "
                    "cannot run in interpret mode here")
    h, c, k, r, stride, pad, _ = case
    x, _ = _data(case)
    p = (h + 2 * pad - r) // stride + 1
    do = np.random.default_rng(2).standard_normal((2, p, p, k)).astype(
        np.float32)
    got = k2.conv2d_wu_plain(torch.from_numpy(x), torch.from_numpy(do),
                             stride=stride, padding=pad, filter_rs=(r, r))
    exp = jax_conv2d_wu(jnp.asarray(x), jnp.asarray(do), stride=stride,
                        padding=pad, filter_rs=(r, r), interpret=True)
    _close(got.numpy(), exp)


@pytest.mark.parametrize("case", SCENARIOS, ids=IDS)
def test_phase_plan_equals_dilate_plan(case):
    h, c, k, r, stride, pad, _ = case
    _, w = _data(case)
    p = (h + 2 * pad - r) // stride + 1
    do = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, p, p, k)).astype(np.float32))
    tw = torch.from_numpy(w)
    phase = conv2d_bwd_data_via_fwd(do, tw, stride=stride, padding=pad,
                                    input_hw=(h, h), mode="phase")
    dilate = conv2d_bwd_data_via_fwd(do, tw, stride=stride, padding=pad,
                                     input_hw=(h, h), mode="dilate")
    np.testing.assert_allclose(phase.numpy(), dilate.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_phase_plan_matches_reference_plan():
    for r, stride, pad, h in [(3, 2, 1, 16), (3, 2, 1, 9), (5, 3, 2, 11),
                              (7, 2, 3, 24), (2, 3, 0, 10)]:
        p = (h + 2 * pad - r) // stride + 1
        kw = dict(r=r, s=r, stride=stride, padding=pad, input_hw=(h, h),
                  out_hw=(p, p))
        ours = duality.phase_plan(**kw)
        theirs = jax_duality.phase_plan(**kw)
        assert [tuple(map(dataclasses.astuple, pair)) for pair in ours] \
            == [tuple(map(dataclasses.astuple, pair)) for pair in theirs]


NETS = {"resnet50": (resnet50, jax_resnet50, 224),
        "inception_v3": (inception_v3, jax_inception_v3, 299)}


@pytest.mark.parametrize("mode", ["phase", "dilate"])
@pytest.mark.parametrize("net", NETS)
def test_dual_signatures_match_reference(net, mode):
    ours_nl, ref_nl, image = NETS[net]
    ours = conv_shapes(build_etg(ours_nl()), (image, image))
    theirs = jax_conv_shapes(jax_build_etg(ref_nl()), (image, image))
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        kw = dict(r=a["r"], s=a["s"], c=a["c"], k=a["k"], stride=a["stride"],
                  padding=a["padding"], input_hw=(a["h"], a["w"]), mode=mode)
        for unique in (True, False):
            assert duality.dual_conv_signatures(**kw, unique=unique) \
                == jax_duality.dual_conv_signatures(**kw, unique=unique)


def test_bwd_plan_and_mode():
    assert duality.bwd_data_plan(r=3, s=3, stride=1, padding=1,
                                 input_hw=(8, 8))[0] == "stride1"
    assert duality.bwd_data_plan(r=1, s=1, stride=2, padding=0,
                                 input_hw=(8, 8))[0] == "1x1"
    assert duality.bwd_data_plan(r=3, s=3, stride=2, padding=1,
                                 input_hw=(8, 8))[0] == "phase"
    assert duality.resolve_mode("dilate") == "dilate"
    with pytest.raises(ValueError, match="plan"):
        duality.resolve_mode("scatter")


def test_mode_follows_the_environment(monkeypatch):
    monkeypatch.delenv("REPRO_BWD_DUALITY", raising=False)
    assert duality.resolve_mode(None) == "phase"
    monkeypatch.setenv("REPRO_BWD_DUALITY", "dilate")
    assert duality.bwd_data_plan(r=3, s=3, stride=2, padding=1,
                                 input_hw=(8, 8))[0] == "dilate"


def test_weight_transform_is_an_involution_and_contiguous():
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 3, 8, 16)).astype(np.float32))
    wt = duality.transform_weights(w)
    assert wt.shape == (3, 3, 16, 8) and wt.is_contiguous()
    assert torch.equal(duality.transform_weights(wt), w)
    np.testing.assert_array_equal(
        wt.numpy(), np.asarray(jax_duality.transform_weights(
            jnp.asarray(w.numpy()))))


def test_dilate_matches_reference():
    x = np.random.default_rng(5).standard_normal((2, 4, 5, 3)).astype(
        np.float32)
    for stride in (1, 2, 3):
        np.testing.assert_array_equal(
            duality.dilate(torch.from_numpy(x), stride).numpy(),
            np.asarray(jax_duality.dilate(jnp.asarray(x), stride)))


def test_image_input_gets_no_data_gradient(monkeypatch):
    """dI is skipped when the input needs no gradient (the image): the
    duality path never runs, and dW is the same as with dI."""
    from repro_torch.core import conv as port_conv
    case = SCENARIOS[2]
    x, w = _data(case)
    _, gw = _port_grads(case, x, w)

    def no_di(*args, **kwargs):
        raise AssertionError("dI computed for an input without grad")
    monkeypatch.setattr(port_conv, "conv2d_bwd_data_via_fwd", no_di)
    wt = torch.from_numpy(w).requires_grad_()
    out = conv2d_train(torch.from_numpy(x), wt, case[4], case[5])
    torch.sin(out).sum().backward()
    assert torch.equal(wt.grad, gw)


# -- K2's wrapper and plan ----------------------------------------------------

def test_wu_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    case = SCENARIOS[6]
    h, c, k, r, stride, pad, _ = case
    x, _ = _data(case)
    p = (h + 2 * pad - r) // stride + 1
    do = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, p, p, k)).astype(np.float32))
    before = k2.launches
    got = k2.conv2d_wu(torch.from_numpy(x), do, stride=stride, padding=pad,
                       filter_rs=(r, r))
    assert k2.launches == before
    assert torch.equal(got, k2.conv2d_wu_plain(
        torch.from_numpy(x), do, stride=stride, padding=pad,
        filter_rs=(r, r)))


@pytest.mark.parametrize("bad,match", [
    (dict(do=np.zeros((2, 7, 8, 16), np.float32)), "dO must be"),
    (dict(do=np.zeros((1, 8, 8, 16), np.float32)), "dO must be"),
    (dict(x=np.zeros((8, 8, 8), np.float32)), "x must be"),
    (dict(stride=0), "stride"),
    (dict(filter_rs=(0, 3)), "filter"),
    (dict(filter_rs=(11, 11)), "empty"),
])
def test_wu_wrapper_rejects_bad_shapes(bad, match):
    kw = dict(x=np.zeros((2, 8, 8, 8), np.float32),
              do=np.zeros((2, 8, 8, 16), np.float32), stride=1, padding=1,
              filter_rs=(3, 3))
    kw.update(bad)
    kw = {key: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for key, v in kw.items()}
    with pytest.raises(ValueError, match=match):
        k2.conv2d_wu(**kw)


def _resnet50_wu_shapes(batch):
    shapes = conv_shapes(build_etg(resnet50()), (224, 224))
    out = []
    for sh in shapes:
        if sh["c"] % 8 or sh["k"] % 8:
            continue
        p = (sh["h"] + 2 * sh["padding"] - sh["r"]) // sh["stride"] + 1
        q = (sh["w"] + 2 * sh["padding"] - sh["s"]) // sh["stride"] + 1
        out.append(dict(n=batch, p=p, q=q, c=sh["c"], k=sh["k"], r=sh["r"],
                        s=sh["s"]))
    return out


@pytest.mark.parametrize("shape", [
    dict(n=1, p=2, q=2, c=8, k=8, r=1, s=1),              # one split
    dict(n=32, p=56, q=56, c=64, k=64, r=1, s=1),         # 100k pixels
    dict(n=32, p=7, q=7, c=512, k=512, r=3, s=3),
    dict(n=3, p=5, q=7, c=5, k=7, r=3, s=3),              # ragged
    *_resnet50_wu_shapes(32),
])
def test_wu_plan_covers_the_pixels(shape):
    m = shape["n"] * shape["p"] * shape["q"]
    pl = k2.plan(**shape)
    assert pl.tile in k2.TILES
    assert pl.chunk % k2.PIX_STEP == 0 and pl.chunk <= max(k2.MAX_CHUNK, 8)
    assert pl.splits * pl.chunk >= m > (pl.splits - 1) * pl.chunk
    bm, bn = k2.TILES[pl.tile]
    tiles = -(-shape["c"] // bm) * -(-shape["k"] // bn) * shape["r"] \
        * shape["s"]
    if m >= k2.MIN_CHUNK * k2.TARGET_BLOCKS:   # enough pixels to fill the card
        assert tiles * pl.splits >= k2.TARGET_BLOCKS * 0.9
    assert k2.plan(**shape) == pl                 # a pure function


def test_wu_plan_extremes():
    assert k2.plan(n=1, p=2, q=2, c=8, k=8, r=1, s=1).splits == 1
    big = k2.plan(n=32, p=56, q=56, c=64, k=64, r=1, s=1)
    assert big.splits > 200 and big.tile == 2
    assert k2.plan(n=32, p=7, q=7, c=2048, k=512, r=1, s=1).tile == 0
    assert k2.plan(n=32, p=56, q=56, c=256, k=64, r=1, s=1).tile == 1
