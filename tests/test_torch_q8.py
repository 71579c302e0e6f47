"""The port's int8 conv path (§II-K) on the CPU against the JAX package, on
the same numpy inputs: ``quantize_act``, K3's plain version and wrapper,
the quantized conv dispatch, the weight quantizer.

Tolerances: ``quantize_act``, ``quantize_conv_inputs`` and
``quantize_gxm_params`` are equal bit for bit (the same f32 operations,
rounding half to even).  K3's plain version is exact on integer-valued
inputs with unit scales.  Against the reference's ``conv2d_q8_fwd(impl=
"xla")``, max |diff| / max |ref| <= 1e-5: the reference folds the dequant
scale into the BN scale, ``acc*(deq*bn)`` where K3 computes
``(acc*deq)*bn``, and sums the int8 products in f32.  Where the installed
Pallas has ``unblocked``, the JAX kernel in interpret mode is a second
reference, equal bit for bit.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jax_pallas

from repro.core import conv as jax_conv
from repro.core import quantize as jax_quantize
from repro.graph import GxM as JaxGxM
from repro.graph import resnet50 as jax_resnet50
from repro.kernels import conv2d_q8 as jax_k3
from repro.kernels import ref as jax_ref
from repro_torch.convert import params_from_jax
from repro_torch.core.conv import conv2d_q8_fwd, lane_ok
from repro_torch.core.quantize import quantize_act, quantize_gxm_params
from repro_torch.graph import GxM, resnet50
from repro_torch.kernels import conv2d_q8 as k3

REL_TOL = 1e-5

CASES = [
    # n, h, w, c, k, r, stride, pad
    (2, 8, 8, 8, 16, 3, 1, 1),
    (1, 14, 14, 16, 32, 1, 1, 0),
    (2, 16, 16, 8, 8, 3, 2, 1),
    (1, 9, 9, 8, 8, 3, 1, 1),         # P/Q that no 4-row block divides
    (1, 8, 8, 8, 8, 1, 2, 0),         # 1x1 stride 2
    (1, 12, 12, 8, 8, 5, 1, 2),       # 5x5 halo
    (1, 24, 24, 8, 16, 7, 2, 3),      # 7x7 stride-2 halo
    (1, 13, 11, 16, 24, 3, 2, 1),     # P/Q tails, H != W
    (3, 11, 13, 5, 7, 3, 2, 1),       # ragged C and K: the fallback
    (1, 32, 32, 3, 16, 7, 2, 3),      # the C=3 stem: the fallback
]
EPILOGUES = {
    "none": dict(),
    "bias": dict(bias=True),
    "bn": dict(bn=True),
    "bn_residual_relu": dict(bn=True, residual=True, relu=True),
}


def _out_hw(case):
    n, h, w, c, k, r, stride, pad = case
    return (h + 2 * pad - r) // stride + 1, (w + 2 * pad - r) // stride + 1


def _data(case, *, bias=False, bn=False, residual=False, relu=False,
          seed=0):
    """f32 activation and weights, the weights quantized by the
    reference, and f32 epilogue operands, all numpy."""
    n, h, w, c, k, r, stride, pad = case
    p, q = _out_hw(case)
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = f(n, h, w, c)
    wt = (f(r, r, c, k) * 0.1).astype(np.float32)
    _, w_q, x_scale, w_scale = jax_k3.quantize_conv_inputs(jnp.asarray(x),
                                                           jnp.asarray(wt))
    return dict(x=x, w_q=np.array(w_q), x_scale=np.array(x_scale),
                w_scale=np.array(w_scale), stride=stride, padding=pad,
                bias=f(k) if bias else None,
                scale=(rng.uniform(0.5, 1.5, k).astype(np.float32)
                       if bn else None),
                shift=f(k) if bn else None,
                residual=f(n, p, q, k) if residual else None, relu=relu)


def _as(fn, kw):
    return {key: fn(v) if isinstance(v, np.ndarray) else v
            for key, v in kw.items()}


def _rel(out, exp):
    return float(np.max(np.abs(out - exp))) / max(float(np.max(np.abs(exp))),
                                                  1e-30)


@pytest.mark.parametrize("scale", [1.0, 0.037, 3.3])
def test_quantize_act_matches_reference_bit_for_bit(scale):
    """Exact .5 ties (half to even, both signs), values beyond
    ±127*scale (saturate), and random values."""
    ties = (np.arange(-130, 130) + 0.5).astype(np.float32)
    rng = np.random.default_rng(1)
    x = np.concatenate([ties * np.float32(scale),
                        np.float32(scale) * np.array([127.4, 127.5, 128, 1e6,
                                                      -127.5, -1e6, 0, -0.0],
                                                     np.float32),
                        rng.standard_normal(4096).astype(np.float32) * 60
                        * np.float32(scale)]).astype(np.float32)
    s32 = np.float32(scale)
    exp = np.asarray(jax_quantize.quantize_act(jnp.asarray(x),
                                               jnp.asarray(s32)))
    got = quantize_act(torch.from_numpy(x), torch.tensor(s32)).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, exp)
    if scale == 1.0:    # ties go to the even neighbour, not away from zero
        assert got[130] == 0 and got[131] == 2 and got[129] == 0


@pytest.mark.parametrize("stride,pad", [(1, 1), (2, 1), (1, 0)])
def test_plain_integer_inputs_exact(stride, pad):
    """With integer-valued inputs, unit scales and no epilogue, K3's plain
    version equals the reference's f32 conv of the same integers."""
    rng = np.random.default_rng(2)
    x = rng.integers(-3, 4, (2, 7, 7, 8))
    w = rng.integers(-3, 4, (3, 3, 8, 16))
    out = k3.conv2d_q8_plain(torch.from_numpy(x).to(torch.int8),
                             torch.from_numpy(w).to(torch.int8),
                             x_scale=torch.tensor(1.0),
                             w_scale=torch.ones(16), stride=stride,
                             padding=pad)
    exp = jax_ref.conv2d(jnp.asarray(x, jnp.float32),
                         jnp.asarray(w, jnp.float32), stride=stride,
                         padding=pad)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(exp))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("epi", EPILOGUES)
def test_conv2d_q8_fwd_matches_reference(case, epi):
    """The port's quantized conv dispatch (K3's plain version for
    lane-aligned (C, K), the reference's fallback otherwise) against the
    reference's ``conv2d_q8_fwd(impl="xla")``."""
    kw = _data(case, **EPILOGUES[epi])
    x, w_q = kw.pop("x"), kw.pop("w_q")
    exp = np.asarray(jax_conv.conv2d_q8_fwd(
        jnp.asarray(x), jnp.asarray(w_q), impl="xla", **_as(jnp.asarray, kw)))
    before = k3.launches
    out = conv2d_q8_fwd(torch.from_numpy(x), torch.from_numpy(w_q),
                        **_as(torch.from_numpy, kw))
    assert k3.launches == before
    assert out.shape == exp.shape and out.dtype == torch.float32
    assert _rel(out.numpy(), exp) <= REL_TOL


def test_plain_is_the_kernels_arithmetic():
    """K3's plain version is (f32(acc) * deq) then K1's epilogue chain:
    with integer inputs and exact scales, equal bit for bit to that chain
    written out in float64 (every value here is exact in f32)."""
    rng = np.random.default_rng(3)
    x = rng.integers(-5, 6, (1, 6, 6, 16))
    w = rng.integers(-5, 6, (3, 3, 16, 8))
    x_scale, w_scale = np.float32(0.5), np.full(8, 0.25, np.float32)
    scale = np.full(8, 2.0, np.float32)
    shift = rng.integers(-8, 8, 8).astype(np.float32)
    out = k3.conv2d_q8_plain(
        torch.from_numpy(x).to(torch.int8), torch.from_numpy(w).to(torch.int8),
        x_scale=torch.tensor(x_scale), w_scale=torch.from_numpy(w_scale),
        padding=1, scale=torch.from_numpy(scale),
        shift=torch.from_numpy(shift), relu=True)
    acc = np.asarray(jax_ref.conv2d(jnp.asarray(x, jnp.float32),
                                    jnp.asarray(w, jnp.float32), padding=1))
    exp = np.maximum(acc.astype(np.float64) * 0.125 * 2.0 + shift, 0)
    np.testing.assert_array_equal(out.numpy(), exp.astype(np.float32))


@pytest.mark.parametrize("r,s,c", [(1, 1, 2048), (3, 3, 14793), (3, 3, 14794),
                                   (7, 7, 2717), (7, 7, 2718), (1, 1, 133144),
                                   (1, 1, 133145)])
def test_overflow_check_matches_reference(r, s, c):
    """The port raises exactly where the reference asserts."""
    try:
        jax_k3._check_overflow(r, s, c)
        overflows = False
    except AssertionError:
        overflows = True
    if overflows:
        with pytest.raises(ValueError, match="overflow"):
            k3._check_overflow(r, s, c)
    else:
        k3._check_overflow(r, s, c)


def test_wrapper_raises_on_overflow_and_bad_operands():
    x = torch.zeros((1, 3, 3, 16384), dtype=torch.int8)
    w = torch.zeros((3, 3, 16384, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="overflow"):
        k3.conv2d_q8(x, w, x_scale=torch.tensor(1.0), w_scale=torch.ones(8),
                     padding=1)
    kw = _as(torch.from_numpy, _data(CASES[0]))
    x_f32, w_q = kw.pop("x"), kw.pop("w_q")
    x_q = quantize_act(x_f32, kw["x_scale"])
    with pytest.raises(ValueError, match="int8"):
        k3.conv2d_q8(x_f32, w_q, **kw)
    with pytest.raises(ValueError, match="w_scale must be"):
        k3.conv2d_q8(x_q, w_q, **{**kw, "w_scale": kw["w_scale"][:-1]})
    with pytest.raises(ValueError, match="x_scale must hold one"):
        k3.conv2d_q8(x_q, w_q, **{**kw, "x_scale": torch.ones(2)})


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    kw = _as(torch.from_numpy, _data(CASES[0], bn=True, relu=True))
    x, w_q = kw.pop("x"), kw.pop("w_q")
    x_q = quantize_act(x, kw["x_scale"])
    before = k3.launches
    out = k3.conv2d_q8(x_q, w_q, **kw)
    assert k3.launches == before
    assert torch.equal(out, k3.conv2d_q8_plain(x_q, w_q, **kw))


@pytest.mark.parametrize("case", [CASES[0], CASES[6], CASES[8]])
def test_quantize_conv_inputs_matches_reference(case):
    n, h, w, c, k, r, _, _ = case
    rng = np.random.default_rng(4)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((r, r, c, k)) * 0.1).astype(np.float32)
    exp = jax_k3.quantize_conv_inputs(jnp.asarray(x), jnp.asarray(wt))
    got = k3.quantize_conv_inputs(torch.from_numpy(x), torch.from_numpy(wt))
    for g, e in zip(got, exp):
        assert g.numpy().dtype == np.asarray(e).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


def test_lane_rule_sends_only_the_stem_to_the_fallback():
    nl = resnet50(1000)
    convs = [t for t in GxM(nl, device="cpu", quantized=True).etg.tasks
             if t.op == "conv"]
    off = [t.name for t in convs if not lane_ok(t.attrs["c"], t.attrs["k"])]
    assert off == ["conv1"] and len(convs) == 53


def test_quantize_gxm_params_matches_reference():
    """From the same f32 params and the same scales, ``w_q``, ``w_scale``
    and ``x_scale`` equal the reference's bit for bit; tasks without a
    scale, and every other leaf, stay as they were."""
    ref = JaxGxM(jax_resnet50(10, stages=(1, 1, 1, 1)), impl="xla",
                 num_classes=10, quantized=True)
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    convs = [t.name for t in ref.etg.tasks if t.op == "conv"]
    scales = {name: np.float32(rng.uniform(0.01, 0.2)) for name in convs[1:]}
    exp = jax_quantize.quantize_gxm_params(
        ref.etg, jax.tree.map(jnp.asarray, tree),
        {n: jnp.asarray(v) for n, v in scales.items()})
    ours = GxM(resnet50(10, stages=(1, 1, 1, 1)), device="cpu",
               num_classes=10, quantized=True)
    got = quantize_gxm_params(ours.etg, params_from_jax(tree, device="cpu"),
                              {n: torch.tensor(v) for n, v in scales.items()})
    assert got.keys() == exp.keys()
    assert set(got[convs[0]]) == set(exp[convs[0]]) and "w" in got[convs[0]]
    for name in got:
        assert got[name].keys() == exp[name].keys(), name
        for leaf, v in got[name].items():
            e = np.asarray(exp[name][leaf])
            assert v.shape == e.shape and v.numpy().dtype == e.dtype, \
                (name, leaf)
            np.testing.assert_array_equal(v.numpy(), e)
    assert got[convs[1]]["x_scale"].dim() == 0


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[7]])
def test_plain_matches_jax_interpret_kernel(case):
    if not hasattr(jax_pallas, "unblocked"):
        pytest.skip("this jax's Pallas has no `unblocked`: the JAX kernel "
                    "cannot run in interpret mode here")
    kw = _data(case, bn=True, residual=True, relu=True)
    x, w_q = kw.pop("x"), kw.pop("w_q")
    x_q = np.asarray(jax_quantize.quantize_act(jnp.asarray(x),
                                               jnp.asarray(kw["x_scale"])))
    exp = jax_k3.conv2d_q8(jnp.asarray(x_q), jnp.asarray(w_q), rb_p=4,
                           interpret=True, **_as(jnp.asarray, kw))
    out = k3.conv2d_q8_plain(torch.from_numpy(x_q), torch.from_numpy(w_q),
                             **_as(torch.from_numpy, kw))
    np.testing.assert_array_equal(out.numpy(), np.asarray(exp))


def test_epilogue_sweep_covers_every_combination():
    """Every subset of {bias, bn, residual, relu} on one lane-aligned
    case, against the reference."""
    case = CASES[7]
    for bias, bn, residual, relu in itertools.product([False, True],
                                                      repeat=4):
        kw = _data(case, bias=bias, bn=bn, residual=residual, relu=relu)
        x, w_q = kw.pop("x"), kw.pop("w_q")
        exp = np.asarray(jax_conv.conv2d_q8_fwd(
            jnp.asarray(x), jnp.asarray(w_q), impl="xla",
            **_as(jnp.asarray, kw)))
        out = conv2d_q8_fwd(torch.from_numpy(x), torch.from_numpy(w_q),
                            **_as(torch.from_numpy, kw))
        assert _rel(out.numpy(), exp) <= REL_TOL, (bias, bn, residual, relu)
