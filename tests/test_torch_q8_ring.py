"""K3's ring route on the CPU: its plan, its weight layout and cache, its
route, and its summation order against the JAX package.

The ring kernel itself runs only on the card (``tests/test_torch_cuda.py``,
marker ``gpu``).  Here:

* ``ring_plan`` on every ResNet-50 int8 signature at serving buckets 1-16:
  the tiles partition the output pixels and channels, the splits partition
  the (r, s, c) steps and the steps the reduction, the shared memory fits
  a block, and the grid reaches ``roofline.SMS`` CTAs wherever tiles x
  (steps // RING_MIN_SPLIT_STEPS) allows it.
* An emulation of the route's arithmetic in plain torch: int32 partials of
  each split's steps, summed, then the f32 epilogue in
  ``q8::dequant_epilogue``'s order.  It equals ``conv2d_q8_plain`` bit for
  bit, and the reference's ``conv2d_q8_fwd(impl="xla")`` within
  max |diff| / max |ref| <= 1e-5 (the reference folds the dequant scale
  into the BN scale and sums in f32; ``tests/test_torch_q8.py``'s limit).
  Where the installed Pallas has ``unblocked``, the JAX kernel in
  interpret mode is a second reference, equal bit for bit.
* ``weight_words`` against a numpy re-layout, and its cache.
* ``route``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as jax_pallas

from repro.core import conv as jax_conv
from repro.core import quantize as jax_quantize
from repro.kernels import conv2d_q8 as jax_k3
from repro_torch.core.conv import lane_ok
from repro_torch.graph import build_etg, inception_v3, resnet50
from repro_torch.graph.serving import conv_shapes
from repro_torch.kernels import conv2d_q8 as k3
from repro_torch.kernels.conv2d_direct import SMEM_LIMIT
from repro_torch.launch import roofline

REL_TOL = 1e-5


def _signatures(graph, image):
    """Distinct lane-aligned conv shapes of one forward: (h, w, c, k, r, s,
    stride, padding)."""
    return sorted({(sh["h"], sh["w"], sh["c"], sh["k"], sh["r"], sh["s"],
                    sh["stride"], sh["padding"])
                   for sh in conv_shapes(build_etg(graph), (image, image))
                   if lane_ok(sh["c"], sh["k"])})


RESNET50 = _signatures(resnet50(), 224)


def _partitions(ranges, total):
    """True when the half-open ``ranges`` cover [0, total) once each."""
    ranges = sorted(ranges)
    return ranges[0][0] == 0 and ranges[-1][1] >= total and all(
        a[1] == b[0] for a, b in zip(ranges, ranges[1:])) and all(
        lo < hi for lo, hi in ranges) and ranges[-1][0] < total


def _steps(r, s, c, bk):
    """The (r, s, channel range) of every step, in the kernel's order:
    C innermost, then s, then r."""
    return [(rr, ss, c0, min(c, c0 + bk)) for rr in range(r)
            for ss in range(s) for c0 in range(0, c, bk)]


@pytest.mark.parametrize("n", range(1, 17))
def test_ring_plan_covers_every_output_and_step_once(n):
    for h, w, c, k, r, s, st, pad in RESNET50:
        p, q = (h + 2 * pad - r) // st + 1, (w + 2 * pad - s) // st + 1
        plan = k3.ring_plan(n, p, q, c, k, r, s, st)
        m = n * p * q
        m_tiles, k_tiles = -(-m // plan.bm), -(-k // plan.bn)
        assert plan.tiles == m_tiles * k_tiles
        assert plan.ctas == plan.tiles * plan.splits
        assert _partitions([(i * plan.bm, (i + 1) * plan.bm)
                            for i in range(m_tiles)], m)
        assert _partitions([(j * plan.bn, (j + 1) * plan.bn)
                            for j in range(k_tiles)], k)
        steps = _steps(r, s, c, plan.bk)
        assert plan.steps == len(steps)
        assert len(set(steps)) == len(steps)
        for rr in range(r):
            for ss in range(s):
                assert _partitions([(lo, hi) for a, b, lo, hi in steps
                                    if (a, b) == (rr, ss)], c)
        cuts = k3.split_steps(plan.steps, plan.splits)
        assert _partitions(cuts, plan.steps)
        assert all(hi - lo >= min(k3.RING_MIN_SPLIT_STEPS, plan.steps)
                   for lo, hi in cuts)
        assert plan.smem <= SMEM_LIMIT and plan.stages >= 3
        allows = plan.tiles * max(1, plan.steps
                                  // k3.RING_MIN_SPLIT_STEPS)
        assert plan.ctas >= min(roofline.SMS, allows), (n, h, c, k, plan)
        if plan.tiles >= roofline.SMS:
            assert plan.splits == 1


def test_ring_plan_takes_the_larger_tile_where_it_fills_the_card():
    plan = k3.ring_plan(16, 56, 56, 64, 256, 1, 1, 1)
    assert (plan.bm, plan.bn, plan.bk, plan.splits) == (128, 64, 64, 1)
    plan = k3.ring_plan(16, 14, 14, 1024, 256, 1, 1, 1)   # 100 CTAs at 128
    assert (plan.bm, plan.bn, plan.bk, plan.splits) == (64, 64, 128, 1)
    plan = k3.ring_plan(16, 7, 7, 512, 512, 3, 3, 1)
    assert (plan.bm, plan.bn, plan.bk) == (64, 64, 128)
    assert plan.splits == 2 and plan.ctas >= roofline.SMS
    assert k3.ring_plan(1, 7, 7, 512, 512, 3, 3, 1).splits == 17


def test_ring_plan_shared_memory_follows_the_steps_of_a_split():
    """RING_MAX_STAGES stages where two blocks still fit an SM; a split of
    fewer steps than stages claims only its steps' slots, and never less
    than the epilogue's int32 tile and factors."""
    one = k3.ring_plan(16, 56, 56, 64, 256, 1, 1, 1)         # one step
    assert one.stages == 4 and one.steps == 1
    assert one.smem == 128 * (64 + 8) * 4 + 4 * 64 * 4
    deep = k3.ring_plan(16, 28, 28, 512, 512, 1, 1, 1)       # 128x64x128
    assert deep.stages == 4 and deep.smem == 4 * 192 * 144
    assert k3.ring_plan(16, 14, 14, 256, 256, 3, 3, 1).smem == 4 * 128 * 144
    assert k3._ring_shape(128, 128, 128, 9) == (3, 3 * 256 * 144)


def test_ring_plan_refuses_what_the_route_excludes():
    with pytest.raises(ValueError, match="C % 16"):
        k3.ring_plan(1, 8, 8, 8, 16, 3, 3, 1)
    with pytest.raises(ValueError, match="K % 8"):
        k3.ring_plan(1, 8, 8, 16, 12, 3, 3, 1)


def test_route_by_channels():
    x16 = torch.zeros((1, 4, 4, 16), dtype=torch.int8)
    x8 = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    assert k3.route(x16, torch.zeros((3, 3, 16, 8), dtype=torch.int8)) \
        == "ring"
    assert k3.route(x16, torch.zeros((3, 3, 16, 12), dtype=torch.int8)) \
        == "sync"
    assert k3.route(x8, torch.zeros((3, 3, 8, 8), dtype=torch.int8)) \
        == "sync"


@pytest.mark.parametrize("graph,image", [(resnet50(), 224),
                                         (inception_v3(), 299)])
def test_ring_route_takes_every_lane_aligned_conv(graph, image):
    """Every lane-aligned conv of ResNet-50 and Inception-v3 (C a multiple
    of 16 in both) takes the ring route."""
    for h, w, c, k, r, s, st, pad in _signatures(graph, image):
        assert k3.route(torch.zeros((1, 1, 1, c), dtype=torch.int8),
                        torch.zeros((r, s, c, k), dtype=torch.int8)) \
            == "ring", (h, c, k, r)


# -- the route's arithmetic --------------------------------------------------

# n, h, w, c, k, r, stride, pad: split reductions (the small planes), K and
# M tails inside a tile, 64- and 128-channel stages with a C tail, stride 2
CASES = [
    (2, 7, 7, 64, 40, 3, 1, 1),
    (1, 9, 11, 144, 24, 3, 2, 1),
    (2, 6, 6, 256, 16, 1, 1, 0),
    (1, 8, 8, 48, 8, 5, 1, 2),
]


def _data(case, seed=0):
    """f32 activation quantized by the reference, int8 weights and scales
    from the reference's quantizer, and every epilogue operand; numpy."""
    n, h, w, c, k, r, stride, pad = case
    p, q = (h + 2 * pad - r) // stride + 1, (w + 2 * pad - r) // stride + 1
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = f(n, h, w, c)
    _, w_q, x_scale, w_scale = jax_k3.quantize_conv_inputs(
        jnp.asarray(x), jnp.asarray(f(r, r, c, k) * 0.1))
    return dict(x=x, w_q=np.array(w_q), x_scale=np.array(x_scale),
                w_scale=np.array(w_scale), stride=stride, padding=pad,
                bias=f(k), scale=rng.uniform(0.5, 1.5, k).astype(np.float32),
                shift=f(k), residual=f(n, p, q, k), relu=True)


def _ring_emulation(x_q, w_q, *, x_scale, w_scale, stride, padding, bias,
                    scale, shift, residual, relu):
    """The ring route's order in plain torch: each split's int32 partial
    over its steps (one (r, s) and bk channels a step; float64 products,
    exact), the partials summed, then __int2float_rn, __fmul_rn by deq and
    the non-contracting epilogue in the kernel's order."""
    n, h, wd, c = x_q.shape
    r, s, _, k = w_q.shape
    p = (h + 2 * padding - r) // stride + 1
    q = (wd + 2 * padding - s) // stride + 1
    plan = k3.ring_plan(n, p, q, c, k, r, s, stride)
    steps = _steps(r, s, c, plan.bk)
    xp = F.pad(x_q.to(torch.float64), (0, 0, padding, padding, padding,
                                       padding))
    wf = w_q.to(torch.float64)
    partials = []
    for lo, hi in k3.split_steps(plan.steps, plan.splits):
        acc = torch.zeros((n * p * q, k), dtype=torch.float64)
        for rr, ss, c0, c1 in steps[lo:hi]:
            xs = xp[:, rr:rr + (p - 1) * stride + 1:stride,
                    ss:ss + (q - 1) * stride + 1:stride, c0:c1]
            acc += xs.reshape(n * p * q, c1 - c0) @ wf[rr, ss, c0:c1]
        partials.append(acc.to(torch.int32))
    total = partials[0]
    for part in partials[1:]:
        total = total + part
    deq = x_scale.reshape(()) * w_scale
    y = total.reshape(n, p, q, k).to(torch.float32) * deq
    y = y * scale
    y = y + shift
    y = y + bias
    y = y + residual
    return torch.clamp_min(y, 0) if relu else y, plan


@pytest.mark.parametrize("case", CASES)
def test_ring_order_equals_plain_and_the_reference(case):
    kw = _data(case)
    x = kw.pop("x")
    x_q = np.array(jax_quantize.quantize_act(jnp.asarray(x),
                                               jnp.asarray(kw["x_scale"])))
    t = {key: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for key, v in kw.items()}
    out, plan = _ring_emulation(torch.from_numpy(x_q), **t)
    assert plan.splits > 1 or case[3] >= 144
    plain = k3.conv2d_q8_plain(torch.from_numpy(x_q), **t)
    assert torch.equal(out, plain)
    exp = np.asarray(jax_conv.conv2d_q8_fwd(
        jnp.asarray(x), jnp.asarray(kw["w_q"]), impl="xla",
        **{key: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for key, v in kw.items() if key != "w_q"}))
    rel = float(np.abs(out.numpy() - exp).max() / np.abs(exp).max())
    assert rel <= REL_TOL


@pytest.mark.parametrize("case", CASES[:2])
def test_ring_order_equals_jax_interpret_kernel(case):
    if not hasattr(jax_pallas, "unblocked"):
        pytest.skip("this jax's Pallas has no `unblocked`: the JAX kernel "
                    "cannot run in interpret mode here")
    kw = _data(case)
    x = kw.pop("x")
    x_q = np.array(jax_quantize.quantize_act(jnp.asarray(x),
                                               jnp.asarray(kw["x_scale"])))
    exp = jax_k3.conv2d_q8(jnp.asarray(x_q), rb_p=4, interpret=True,
                           **{key: jnp.asarray(v) if isinstance(
                               v, np.ndarray) else v
                              for key, v in kw.items()})
    t = {key: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for key, v in kw.items()}
    out, _ = _ring_emulation(torch.from_numpy(x_q), **t)
    np.testing.assert_array_equal(out.numpy(), np.asarray(exp))


# -- weight_words ------------------------------------------------------------

def _weights(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


@pytest.mark.parametrize("shape", [(3, 3, 48, 40), (1, 1, 16, 8),
                                   (5, 5, 32, 24)])
def test_weight_words_equal_a_numpy_relayout(shape):
    w = _weights(shape, 0)
    r, s, c, k = shape
    ring = k3.weight_words(w, "ring")
    np.testing.assert_array_equal(ring.numpy(),
                                  np.transpose(w.numpy(), (0, 1, 3, 2)))
    assert ring.is_contiguous()
    whole = k3.weight_words(w, "whole")
    np.testing.assert_array_equal(
        whole.numpy(), np.transpose(w.numpy().reshape(r, s, c // 4, 4, k),
                                    (0, 1, 2, 4, 3)))
    with pytest.raises(ValueError, match="layout"):
        k3.weight_words(w, "rsck")


def test_weight_words_cached_by_tensor_version_and_layout():
    w = _weights((3, 3, 32, 16), 1)
    first = k3.weight_words(w, "ring")
    assert k3.weight_words(w, "ring") is first
    assert k3.weight_words(w, "whole") is not first
    w[1, 2, 3, 4] = -w[1, 2, 3, 4] - 1          # an in-place edit
    edited = k3.weight_words(w, "ring")
    assert edited is not first
    assert int(edited[1, 2, 4, 3]) == int(w[1, 2, 3, 4])
    assert k3.weight_words(w, "ring") is edited
    other = w.clone()                           # same shape and values
    assert k3.weight_words(other, "ring") is not edited
    assert torch.equal(k3.weight_words(other, "ring"), edited)


def test_weight_words_cache_is_bounded_and_skips_inference_tensors():
    for seed in range(k3.WORDS_CACHE + 8):
        k3.weight_words(_weights((1, 1, 16, 8), seed), "ring")
    assert len(k3._words) <= k3.WORDS_CACHE
    with torch.inference_mode():
        w = _weights((1, 1, 16, 8), 99)
    assert w.is_inference()
    a, b = k3.weight_words(w, "ring"), k3.weight_words(w, "ring")
    assert a is not b and torch.equal(a, b)
