"""K10c's mma route (``mma.sync`` s8 on the tensor cores) on the CPU.

The route's kernel (``csrc/conv2d_q8_whole.cu``,
``conv2d_q8_whole_kernel_mma``, on K3's products of ``csrc/q8_mma.cuh``)
runs only on the card.  What decides it and what it computes are checked
here:

* ``conv2d_q8.route_whole`` by channels; the operands' alignment does not
  enter (the kernels read the wrapper's padded copy and re-laid weights);
* the cut (``whole_split``, ``whole_k_cta``, ``whole_rows_cta``,
  ``whole_slices``): every row and output channel of each reference block
  in one CTA, on every ResNet-50 int8 launch at batch 16 and on ragged
  blockings, and ``roofline.SMS`` CTAs reached where the reference's grid
  is smaller and its rows are cut;
* ``whole_mma_plan`` fits every ResNet-50 int8 launch in a block's shared
  memory and raises like ``whole_plan``;
* an emulation of the route in plain torch: per CTA, its output channels
  (k_blk, or half of it) and its rows in passes of
  ``rows_pass`` rows by ``cols`` columns, each pass's band cut from the
  padded plane as the kernel stages it (32-channel slices, the C tail zero),
  every tap's products read from the band at the tap's offset and summed in
  int64, then K3's epilogue (int32 -> f32, times deq, scale, shift, bias,
  residual, relu).  It equals ``conv2d_q8_whole_plain`` (and K3's plain
  version) bit for bit, cut or not, at the reference tests' reduced shapes,
  and the JAX package's whole-plane Pallas K10c in interpret mode bit for
  bit on the dequantized sums (within one rounding with the fused epilogue,
  which XLA's CPU backend contracts into FMAs);
* a CPU call launches nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.conv2d_q8 import conv2d_q8 as jax_conv2d_q8
from repro_torch.core import conv
from repro_torch.graph import build_etg, resnet50
from repro_torch.graph.serving import conv_shapes
from repro_torch.kernels import conv2d_q8 as k3
from repro_torch.kernels.conv2d_direct import pad_input
from repro_torch.launch import roofline

FIELDS = ("h", "w", "c", "k", "r", "s", "stride", "padding")
BATCH = 16


def _int8_launches():
    """Every distinct int8 whole-plane launch of ResNet-50 at batch 16
    (the lane-aligned convs K3 and K10c take), with the reference's q8
    blocking."""
    out = {}
    for sh in conv_shapes(build_etg(resnet50()), (224, 224)):
        if not conv.lane_ok(sh["c"], sh["k"]):
            continue
        key = tuple(sh[f] for f in FIELDS)
        h, w, c, k, r, s, st, pad = key
        p, q = (h + 2 * pad - r) // st + 1, (w + 2 * pad - s) // st + 1
        blk = conv.whole_blocking((BATCH, h, w, c), (r, s, c, k), stride=st,
                                  padding=pad, kind="q8")
        out[key] = dict(n=BATCH, h=h, w=w, c=c, k=k, r=r, s=s, stride=st,
                        padding=pad, p=p, q=q, rb_p=min(blk.rb_p, p),
                        k_blk=blk.k_blk)
    return out


LAUNCHES = _int8_launches()
# ragged blockings: P tails, k_blk below K, one row a block, a block of a
# few rows on a grid that fills the card or nearly does
RAGGED = [dict(n=2, p=10, q=10, k=16, rb_p=4, k_blk=8),
          dict(n=1, p=7, q=7, k=24, rb_p=7, k_blk=8),
          dict(n=3, p=13, q=5, k=64, rb_p=5, k_blk=32),
          dict(n=1, p=9, q=9, k=8, rb_p=1, k_blk=8),
          dict(n=66, p=4, q=4, k=16, rb_p=4, k_blk=8),
          dict(n=64, p=14, q=14, k=128, rb_p=14, k_blk=128)]


def _geo(g):
    return {f: g[f] for f in ("n", "p", "q", "k", "rb_p", "k_blk")}


def test_twenty_two_geometries():
    """23 serving signatures, one geometry shared by two epilogues."""
    assert len(LAUNCHES) == 22


# -- the route ----------------------------------------------------------------

def _xw(c, k, offset=None):
    def make(shape, off):
        n = int(np.prod(shape))
        if off:
            return torch.zeros(n + 1, dtype=torch.int8)[1:].view(shape)
        return torch.zeros(shape, dtype=torch.int8)
    return (make((2, 6, 6, c), offset == "x"),
            make((3, 3, c, k), offset == "w"))


@pytest.mark.parametrize("c,k,offset,want", [
    (64, 64, None, "mma"), (16, 8, None, "mma"), (2048, 512, None, "mma"),
    (48, 24, None, "mma"), (64, 64, "x", "mma"), (64, 64, "w", "mma"),
    (8, 16, None, "simt"), (24, 8, None, "simt"), (40, 16, "x", "simt")])
def test_route_whole_by_channels_and_alignment(c, k, offset, want):
    """mma for C a multiple of 16, simt for the other multiples of 8; an
    offset view keeps its route (the kernels read copies)."""
    x, w = _xw(c, k, offset)
    assert k3.route_whole(x, w) == want


@pytest.mark.parametrize("c", [3, 4, 12, 20])
def test_route_whole_raises_on_what_neither_takes(c):
    x, w = _xw(c, 8)
    with pytest.raises(ValueError, match="8 at a time"):
        k3.route_whole(x, w)


def test_every_resnet50_int8_conv_takes_the_mma_route():
    for g in LAUNCHES.values():
        assert k3.route_whole(*_xw(g["c"], g["k"])) == "mma"


# -- the cut ------------------------------------------------------------------

def _slice_rows(p, rb_p, rows_cta):
    """Output rows of each CTA of the mma grid, as the kernel cuts them:
    reference block pb, slice sl -> rows [pb*rb_p + sl*rows_cta,
    min(pb*rb_p + rb_p, + rows_cta, P))."""
    cuts = -(-rb_p // rows_cta)
    out = []
    for pb in range(-(-p // rb_p)):
        for sl in range(cuts):
            begin = pb * rb_p + sl * rows_cta
            end = min(pb * rb_p + rb_p, begin + rows_cta, p)
            out.append((pb, range(begin, max(begin, end))))
    return out


CUT_CASES = [("resnet50", key) for key in LAUNCHES] + \
    [("ragged", i) for i in range(len(RAGGED))]


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("table,key", CUT_CASES)
def test_the_cut_covers_each_block_once(table, key, split, monkeypatch):
    """Every output row and channel of each reference block in exactly one
    CTA, cut or not; where rows are cut, the fewest slices whose CTAs
    reach the SMs (as many as the rows allow)."""
    g = _geo(LAUNCHES[key] if table == "resnet50" else RAGGED[key])
    monkeypatch.setattr(k3, "whole_split", lambda **kw: split)
    rows, k_cta = k3.whole_rows_cta(**g), k3.whole_k_cta(**g)
    assert (rows, k_cta) == (k3.whole_rows_cta(**g), k3.whole_k_cta(**g))
    span = min(g["rb_p"], g["p"])
    assert 1 <= rows <= span and g["k_blk"] % k_cta == 0 and k_cta % 8 == 0
    if not split:
        assert (rows, k_cta) == (span, g["k_blk"])
    cut = _slice_rows(g["p"], g["rb_p"], rows)
    for pb in range(-(-g["p"] // g["rb_p"])):
        mine = [r_ for b, rng in cut if b == pb for r_ in rng]
        assert mine == list(range(pb * g["rb_p"],
                                  min((pb + 1) * g["rb_p"], g["p"])))
    for kb in range(g["k"] // g["k_blk"]):        # a CTA's channels
        mine = [c_ for j in range(g["k_blk"] // k_cta)
                for c_ in range(kb * g["k_blk"] + j * k_cta,
                                kb * g["k_blk"] + (j + 1) * k_cta)]
        assert mine == list(range(kb * g["k_blk"], (kb + 1) * g["k_blk"]))
    ctas = sum(1 for _, rng in cut if len(rng)) * g["n"] * (g["k"] // k_cta)
    if split and rows < span:
        slices = k3.whole_slices(n=g["n"], p=g["p"], k=g["k"],
                                 rb_p=g["rb_p"], k_blk=k_cta)
        blocks = g["n"] * (g["k"] // k_cta) * -(-g["p"] // g["rb_p"])
        assert -(-span // rows) == slices
        assert ctas >= roofline.SMS or rows == 1
        # no cut into fewer slices reaches the SMs
        assert all(blocks * -(-span // rc) < roofline.SMS
                   for rc in range(1, span + 1) if -(-span // rc) < slices)


def test_the_cut_fills_the_card_where_the_reference_grid_is_small():
    """Every ResNet-50 int8 launch whose reference grid has fewer blocks
    than the card has SMs is cut: the 17 with more than 64 pixels a block
    to at least 132 CTAs (their rows, and also their channels where the
    grid fills at most half the card with blocks of at most 256 pixels),
    the three 64-block grids of the 7x7 outputs' 49-pixel blocks by their
    channels alone (k_blk 128 -> 64: 128 CTAs); the two 256-block grids
    are not cut.  The 56x56 convs: 16 blocks of 56 rows -> 10 slices of 6 rows
    (the last 2), 160 CTAs."""
    cut = []
    for key, g in LAUNCHES.items():
        geo = _geo(g)
        blocks = g["n"] * (g["k"] // g["k_blk"]) * -(-g["p"] // g["rb_p"])
        rows, k_cta = k3.whole_rows_cta(**geo), k3.whole_k_cta(**geo)
        ctas = g["n"] * (g["k"] // k_cta) * -(-g["p"] // g["rb_p"]) \
            * -(-g["rb_p"] // rows)
        assert k3.whole_split(**geo) == (blocks < roofline.SMS)
        if blocks >= roofline.SMS:
            assert (rows, k_cta) == (g["rb_p"], g["k_blk"])
            continue
        cut.append(key)
        assert k_cta == g["k_blk"] // (
            2 if 2 * blocks <= roofline.SMS and g["rb_p"] * g["q"] <= 256
            else 1)
        if g["rb_p"] * g["q"] > 64:
            assert ctas >= roofline.SMS, (g, rows, ctas)
        else:
            assert rows == g["rb_p"] and ctas == 2 * blocks == 128
    assert len(cut) == 20
    g = LAUNCHES[(56, 56, 64, 64, 3, 3, 1, 1)]
    assert (k3.whole_rows_cta(**_geo(g)),
            k3.whole_slices(**{f: g[f] for f in ("n", "p", "k", "rb_p",
                                                 "k_blk")})) == (6, 10)


# -- the plan -----------------------------------------------------------------

def test_whole_mma_plan_fits_every_resnet50_int8_launch():
    for g in LAUNCHES.values():
        for rows in (g["rb_p"], k3.whole_rows_cta(**_geo(g)), 1):
            plan = k3.whole_mma_plan(
                p=g["p"], q=g["q"], k_blk=g["k_blk"], rb_p=g["rb_p"],
                r=g["r"], s=g["s"], stride=g["stride"], rows_cta=rows)
            assert plan.smem <= k3.SMEM_LIMIT
            assert plan.cols == g["q"]          # whole rows: Q <= 128
            assert plan.rows_pass * plan.cols <= k3.WHOLE_MMA_PASS
            assert plan.rows_pass == min(rows, k3.WHOLE_MMA_PASS // g["q"])
            assert plan.rows_cta == rows
            assert plan.band_rows == (plan.rows_pass - 1) * g["stride"] \
                + g["r"]
            assert plan.band_cols == (g["q"] - 1) * g["stride"] + g["s"]
            assert plan.band_cols <= g["w"] + 2 * g["padding"]
            assert plan.bn >= g["k_blk"]
            stage = plan.smem // plan.stages
            assert plan.stages in k3.WHOLE_MMA_STAGES
            # two blocks an SM where two stages leave room for them
            room = k3.WHOLE_MMA_TWO_BLOCKS if 2 * stage <= \
                k3.WHOLE_MMA_TWO_BLOCKS else k3.SMEM_LIMIT
            assert plan.smem <= room
            assert all(n * stage > room for n in k3.WHOLE_MMA_STAGES
                       if n > plan.stages)
            assert k3.whole_mma_plan(
                p=g["p"], q=g["q"], k_blk=g["k_blk"], rb_p=g["rb_p"],
                r=g["r"], s=g["s"], stride=g["stride"],
                rows_cta=rows) is plan              # cached


def test_whole_mma_plan_raises_like_whole_plan():
    kw = dict(p=8, q=8, rb_p=4, r=3, s=3, stride=1, rows_cta=4)
    with pytest.raises(ValueError, match="k_blk 12"):
        k3.whole_mma_plan(k_blk=12, **kw)
    with pytest.raises(ValueError, match="k_blk 256"):
        k3.whole_mma_plan(k_blk=256, **kw)
    with pytest.raises(ValueError, match="shared memory"):
        k3.whole_mma_plan(k_blk=128, p=8, q=8, rb_p=4, r=7, s=7, stride=1,
                          rows_cta=4)
    # a row wider than a pass: segments of 128 columns, one row a pass
    wide = k3.whole_mma_plan(k_blk=8, p=8, q=300, rb_p=4, r=3, s=3,
                             stride=1, rows_cta=4)
    assert (wide.rows_pass, wide.cols, wide.band_rows, wide.band_cols) == \
        (1, k3.WHOLE_MMA_PASS, 3, 127 + 3)


# -- the emulation ------------------------------------------------------------

def emulate(x_q, w_q, *, x_scale, w_scale, stride, padding, rb_p, k_blk,
            rows_cta, bias=None, scale=None, shift=None, residual=None,
            relu=False):
    """K10c's mma route in plain torch, CTA by CTA as the kernel cuts the
    work: (N, P, Q, K) f32."""
    n, h, wd, c = x_q.shape
    r, s, _, k = w_q.shape
    p = (h + 2 * padding - r) // stride + 1
    q = (wd + 2 * padding - s) // stride + 1
    rb_p = min(rb_p, p)
    plan = k3.whole_mma_plan(p=p, q=q, k_blk=k_blk, rb_p=rb_p, r=r, s=s,
                             stride=stride, rows_cta=rows_cta)
    xp = pad_input(x_q, padding=padding, stride=stride, rb_p=rb_p, r=r, p=p)
    slices = -(-c // 32)
    xp = F.pad(xp.to(torch.int64), (0, slices * 32 - c))   # the C tail, zero
    wz = F.pad(w_q.to(torch.int64), (0, 0, 0, slices * 32 - c))
    acc = torch.full((n, p, q, k), -2 ** 40, dtype=torch.int64)
    for nn in range(n):
        for kb in range(k // k_blk):
            ks = slice(kb * k_blk, (kb + 1) * k_blk)
            for pb, rows in _slice_rows(p, rb_p, plan.rows_cta):
                if not len(rows):
                    continue
                for prow in range(rows.start, rows.stop, plan.rows_pass):
                    for q0 in range(0, q, plan.cols):
                        nr = min(plan.rows_pass, rows.stop - prow)
                        pc = min(plan.cols, q - q0)
                        bw = (pc - 1) * stride + s
                        band = xp[nn, prow * stride:prow * stride
                                  + (nr - 1) * stride + r,
                                  q0 * stride:q0 * stride + bw]
                        m = torch.arange(nr * pc)
                        prow_m, col_m = m // pc * stride, m % pc * stride
                        tot = torch.zeros((nr * pc, k_blk), dtype=torch.int64)
                        for sc in range(slices):
                            cs = slice(sc * 32, (sc + 1) * 32)
                            for rr in range(r):
                                for ss in range(s):
                                    a = band[prow_m + rr, col_m + ss, cs]
                                    tot += a @ wz[rr, ss, cs, ks]
                        acc[nn, prow:prow + nr, q0:q0 + pc, ks] = \
                            tot.reshape(nr, pc, k_blk)
    assert int(acc.min()) > -2 ** 31                   # every output written
    y = acc.to(torch.int32).to(torch.float32) * k3._deq(x_scale, w_scale)
    if scale is not None:
        y = y * scale
        y = y + shift
    if bias is not None:
        y = y + bias
    if residual is not None:
        y = y + residual
    if relu:
        y = torch.clamp_min(y, 0)
    return y


# the reference's whole-plane q8 cases at C 16 (tests/test_kernels_q8_pool.py
# via tests/test_torch_whole_plane.py) and three more: C 48 (a half slice at
# the tail), C 32 at stride 2, C 64 with k_blk below K; n, h, c, k, r, stride,
# pad, rb_p, k_blk
Q8_MMA_CASES = [
    (2, 12, 16, 16, 3, 1, 1, 5, 16),
    (1, 10, 16, 8, 3, 1, 1, 4, 8),
    (2, 11, 48, 24, 3, 1, 1, 4, 8),
    (1, 13, 32, 16, 3, 2, 1, 3, 16),
    (2, 9, 64, 32, 1, 1, 0, 9, 16),
]


def _case(case, seed, epilogue=True):
    n, h, c, k, r, st, pad, rb_p, k_blk = case
    rng = np.random.default_rng(seed)
    p = (h + 2 * pad - r) // st + 1
    x = torch.from_numpy(rng.standard_normal((n, h, h, c)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((r, r, c, k)) * 0.1)
                         .astype(np.float32))
    x_q, w_q, x_scale, w_scale = k3.quantize_conv_inputs(x, w)
    f32 = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    kw = dict(x_scale=x_scale, w_scale=w_scale, stride=st, padding=pad)
    if epilogue:
        kw.update(bias=f32(k), scale=torch.from_numpy(rng.uniform(
            0.5, 1.5, k).astype(np.float32)), shift=f32(k),
            residual=f32(n, p, p, k), relu=True)
    return x_q, w_q, kw, dict(rb_p=rb_p, k_blk=k_blk)


@pytest.mark.parametrize("case", Q8_MMA_CASES)
@pytest.mark.parametrize("epilogue", [False, True])
def test_emulation_equals_plain_and_the_jax_k10c(case, epilogue):
    """Bit for bit against the plain version, cut or not, with and without
    the fused epilogue; bit for bit against the JAX K10c on the dequantized
    sums.  With the fused epilogue the JAX kernel in interpret mode differs
    by at most a rounding: XLA's CPU backend contracts a multiply and the
    add after it into one FMA, where K3, the plain versions and this route
    round each (so it is held within 1e-6 of max |JAX|, as
    tests/test_torch_whole_plane.py holds the plain version)."""
    x_q, w_q, kw, blk = _case(case, 11, epilogue)
    assert k3.route_whole(x_q, w_q) == "mma"
    jkw = {key: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor)
                 else v) for key, v in kw.items()}
    jax_out = torch.from_numpy(np.array(jax_conv2d_q8(
        jnp.asarray(x_q.numpy()), jnp.asarray(w_q.numpy()), whole_plane=True,
        interpret=True, **jkw, **blk)))
    plain = k3.conv2d_q8_whole_plain(x_q, w_q, **kw, **blk)
    assert torch.equal(plain, k3.conv2d_q8_plain(x_q, w_q, **kw))
    rb_p = min(blk["rb_p"], plain.shape[1])
    cuts = [(blk["k_blk"], rows) for rows in
            sorted({rb_p, 1, 2, 3} & set(range(1, rb_p + 1)))]
    if blk["k_blk"] % 16 == 0:                  # the K_b cut, with the rows
        cuts += [(blk["k_blk"] // 2, rb_p), (blk["k_blk"] // 2, 1)]
    for k_cta, rows_cta in cuts:
        out = emulate(x_q, w_q, **kw, rb_p=blk["rb_p"], k_blk=k_cta,
                      rows_cta=rows_cta)
        assert torch.equal(out, plain), (k_cta, rows_cta)
        if epilogue:
            assert float((out - jax_out).abs().max()) <= \
                1e-6 * float(jax_out.abs().max())
        else:
            assert torch.equal(out, jax_out), (k_cta, rows_cta)


def test_cpu_call_counts_no_launch():
    x_q, w_q, kw, blk = _case(Q8_MMA_CASES[0], 3)
    k3.launches_whole = k3.launches_whole_mma = 0
    out = k3.conv2d_q8_whole(x_q, w_q, **kw, **blk)
    assert (k3.launches_whole, k3.launches_whole_mma) == (0, 0)
    assert torch.equal(out, k3.conv2d_q8_whole_plain(x_q, w_q, **kw, **blk))
