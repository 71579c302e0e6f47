"""K4's mma route (3xTF32 on the tensor cores) on the CPU.

The route's kernel (``csrc/conv2d_streams.cu``,
``conv2d_streams_kernel_mma``, on the products mainloop of
``csrc/conv_tf32.cuh``) runs only on the card.  What decides it and what it
computes are checked here:

* ``conv2d_streams.route`` by channels, blocks and alignment, and the
  tuner's ``route_of`` on every ResNet-50 candidate blocking;
* ``mma_tile_config``: its sub-tiles cover every run's rb_p*Q x k_blk tile
  once, the CTAs of run j are j*subs .. j*subs + subs - 1 (schedule order),
  and its modeled share stays in (0, 1];
* an emulation of the route in plain torch (``tests/_tf32_emulation``):
  each run's steps in the schedule's order, each step's stages in K4's
  order (C in stages of ``mma_stage_c`` channels innermost, then s, then
  r), each stage's
  3xTF32 run added to the run's f32 sums, bias and ReLU at the epilogue
  step.  It stays within 1e-5 of max |out| against the plain replay and the
  JAX package's Pallas K4 in interpret mode, under both models of the
  tensor cores' adder, on order nkpc and another, and on shuffled runs,
  which give the same bits as runs in order;
* ``tune.measure._streams_util`` reads the model of the route K4 takes;
* a CPU call launches nothing.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _tf32_emulation import single_thread, stage_run
from repro.core import streams as jax_streams
from repro.kernels.conv2d_streams import conv2d_streams as jax_conv2d_streams
from repro_torch import tune
from repro_torch.core import conv, streams
from repro_torch.core.streams import FLAG_EPILOGUE, FLAG_INIT, FLAG_RELU
from repro_torch.graph import build_etg, resnet50
from repro_torch.graph.serving import conv_shapes
from repro_torch.kernels import conv2d_streams as k4
from repro_torch.launch import roofline
from repro_torch.tune import measure

LIMIT = 1e-5
# n, h, w, c, k, r, stride, pad, rb_p, k_blk, c_blk: the cases of
# tests/test_torch_streams.py, then c_blk 36 (a stage of 32 channels and
# one of 4) and a 56-wide row with c_blk 64 over k_blk 64
CASES = [
    (2, 8, 8, 16, 16, 3, 1, 1, 4, 8, 8),
    (1, 9, 9, 8, 16, 3, 1, 1, 4, 8, 8),
    (2, 16, 16, 8, 8, 3, 2, 1, 3, 8, 8),
    (1, 14, 14, 16, 32, 1, 1, 0, 4, 16, 8),
    (1, 24, 24, 8, 16, 7, 2, 3, 5, 8, 8),
    (1, 8, 8, 16, 8, 1, 2, 0, 3, 8, 16),
    (1, 10, 10, 72, 24, 3, 1, 1, 3, 12, 36),
    (1, 56, 56, 128, 64, 3, 1, 1, 1, 64, 64),
]


def _data(case, seed):
    n, h, w, c, k, r = case[:6]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((r, r, c, k))
          * math.sqrt(2.0 / (r * r * c))).astype(np.float32)
    bias = (rng.standard_normal(k) * 0.1).astype(np.float32)
    return x, wt, bias


def _schedule(case, order, relu=True):
    n, h, w, c, k, r, stride, pad, rb_p, k_blk, c_blk = case
    p = (h + 2 * pad - r) // stride + 1
    return streams.build_conv_schedule(
        n=n, k_b=k // k_blk, p_b=math.ceil(p / min(rb_p, p)), c_b=c // c_blk,
        order=order, relu=relu)


def _shuffled(sched, seed):
    runs = len(streams.run_starts(sched))
    return streams.permute_runs(
        sched, np.random.default_rng(seed).permutation(runs).tolist())


def _to_jax(sched):
    return jax_streams.ConvSchedule(
        n_ids=sched.n_ids, kb_ids=sched.kb_ids, pb_ids=sched.pb_ids,
        cb_ids=sched.cb_ids, flags=sched.flags, segments=sched.segments,
        grid=sched.grid)


# -- the route ----------------------------------------------------------------

def _xw(c, k, offset=None):
    def make(shape, off):
        n = int(np.prod(shape))
        if off:
            return torch.zeros(n + 1)[1:].view(shape)
        return torch.zeros(shape)
    return (make((2, 6, 6, c), offset == "x"),
            make((3, 3, c, k), offset == "w"))


@pytest.mark.parametrize("c,k,c_blk,k_blk,offset,want", [
    (64, 64, 64, 64, None, "mma"), (16, 8, 8, 8, None, "mma"),
    (72, 24, 36, 12, None, "mma"), (2048, 512, 128, 128, None, "mma"),
    (12, 20, 6, 10, None, "simt"), (16, 16, 8, 2, None, "simt"),
    (6, 8, 6, 8, None, "simt"), (64, 64, 64, 64, "x", "simt"),
    (64, 64, 64, 64, "w", "simt")])
def test_route_by_channels_blocks_and_alignment(c, k, c_blk, k_blk, offset,
                                                want):
    x, w = _xw(c, k, offset)
    assert k4.route(x, w, c_blk, k_blk) == want


@pytest.mark.parametrize("c_blk,k_blk", [(6, 8), (16, 12), (0, 8)])
def test_route_raises_on_blocks_that_do_not_divide(c_blk, k_blk):
    x, w = _xw(16, 16)
    with pytest.raises(ValueError, match="must divide"):
        k4.route(x, w, c_blk, k_blk)


def _resnet50_shapes():
    out = []
    for sh in conv_shapes(build_etg(resnet50()), (224, 224)):
        if conv.lane_ok(sh["c"], sh["k"]):
            g = {f: sh[f] for f in ("h", "w", "c", "k", "r", "s", "stride",
                                    "padding")}
            if g not in out:
                out.append(g)
    return out


RESNET50 = _resnet50_shapes()


def test_every_resnet50_blocking_takes_the_mma_route():
    """Every candidate the tuner offers for every ResNet-50 serving shape,
    the analytic seed included."""
    for g in RESNET50:
        for blk in tune.conv_candidates(**g, kind="streams"):
            assert k4.route_of(c=g["c"], k=g["k"], c_blk=blk.c_blk,
                               k_blk=blk.k_blk) == "mma"


# -- the CTA tiles ------------------------------------------------------------

@pytest.mark.parametrize("tile_m", [7, 14, 28, 49, 56, 112, 196, 448, 3136])
@pytest.mark.parametrize("k_blk", [8, 12, 64, 128, 256])
@pytest.mark.parametrize("runs", [1, 64, 448, 4096])
def test_mma_tile_config_covers_every_runs_tile_once(tile_m, k_blk, runs):
    code, share = k4.mma_tile_config(tile_m=tile_m, k_blk=k_blk, runs=runs)
    assert code in k4.MMA_TILES and 0 < share <= 1
    assert k4.mma_tile_config(tile_m=tile_m, k_blk=k_blk,
                              runs=runs) == (code, share)   # a pure function
    bm, bn = k4.MMA_TILES[code]
    m_sub, k_sub = -(-tile_m // bm), -(-k_blk // bn)
    subs = m_sub * k_sub
    seen = np.zeros((tile_m, k_blk), dtype=np.int64)
    for run in range(min(runs, 3)):
        for cta in range(run * subs, (run + 1) * subs):
            assert cta // subs == run          # CTAs in schedule order
            sub = cta % subs
            m0, kt0 = sub // k_sub * bm, sub % k_sub * bn
            if run == 0:
                seen[m0:m0 + bm, kt0:kt0 + bn] += 1
    assert (seen == 1).all()


def test_mma_tile_config_prefers_full_tiles_on_a_full_card():
    """A 512-pixel tile over 128 channels on 896 runs: sub-tiles with no
    idle lane and within 5 % of the card's rounds; the 7-pixel tiles of
    the 7x7 3x3 convs take 64x128."""
    code, share = k4.mma_tile_config(tile_m=512, k_blk=128, runs=896)
    bm, bn = k4.MMA_TILES[code]
    assert 512 % bm == 0 and 128 % bn == 0 and share >= 0.95
    assert k4.MMA_TILES[k4.mma_tile_config(tile_m=7, k_blk=128,
                                           runs=448)[0]] == (64, 128)


@pytest.mark.parametrize("c_blk,depth", [(4, 8), (8, 8), (12, 16), (16, 16),
                                         (20, 32), (32, 32), (36, 32),
                                         (128, 32)])
def test_mma_stage_c_fits_small_blocks(c_blk, depth):
    """A stage is 32 input channels, or 16 or 8 for a c_blk that small."""
    assert k4.mma_stage_c(c_blk) == depth


# -- the emulation ------------------------------------------------------------

def emulate(x, w, bias, sched, *, stride, padding, rb_p, k_blk, c_blk,
            adder):
    """The mma route's output, run by run in the schedule's order, on one
    torch thread."""
    with single_thread():
        return _emulate(x, w, bias, sched, stride=stride, padding=padding,
                        rb_p=rb_p, k_blk=k_blk, c_blk=c_blk, adder=adder)


def _emulate(x, w, bias, sched, *, stride, padding, rb_p, k_blk, c_blk,
             adder):
    n, h, wd, c = x.shape
    r, s, _, k = w.shape
    p = (h + 2 * padding - r) // stride + 1
    q = (wd + 2 * padding - s) // stride + 1
    rb_p = min(rb_p, p)
    depth = k4.mma_stage_c(c_blk)
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    out = torch.full((n, p, q, k), float("nan"))
    acc = None
    for f, nn, kb, pb, cb in zip(sched.flags.tolist(), sched.n_ids.tolist(),
                                 sched.kb_ids.tolist(), sched.pb_ids.tolist(),
                                 sched.cb_ids.tolist()):
        p0 = pb * rb_p
        rows = min(rb_p, p - p0)
        ks = slice(kb * k_blk, (kb + 1) * k_blk)
        if f & FLAG_INIT:
            acc = torch.zeros((rows * q, k_blk))
        for rr in range(r):
            for ss in range(s):
                h0 = p0 * stride + rr
                a = xp[nn, h0:h0 + (rows - 1) * stride + 1:stride,
                       ss:ss + (q - 1) * stride + 1:stride,
                       cb * c_blk:(cb + 1) * c_blk].reshape(rows * q, c_blk)
                b = w[rr, ss, cb * c_blk:(cb + 1) * c_blk, ks]
                for c0 in range(0, c_blk, depth):       # zero past c_blk
                    cs = slice(c0, min(c0 + depth, c_blk))
                    pad_c = depth - (cs.stop - cs.start)
                    acc = acc + stage_run(F.pad(a[:, cs], (0, pad_c)),
                                          F.pad(b[cs], (0, 0, 0, pad_c)),
                                          adder)
        if f & FLAG_EPILOGUE:
            y = acc + bias[ks]
            if f & FLAG_RELU:
                y = torch.clamp_min(y, 0)
            out[nn, p0:p0 + rows, :, ks] = y.reshape(rows, q, k_blk)
    return out


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("order", ["nkpc", "npkc"])
def test_emulation_holds_the_limit(case, order):
    """Against the plain replay and the JAX K4 in interpret mode, both
    adder models; shuffled runs give the same bits as runs in order."""
    n, h, w, c, k, r, stride, pad, rb_p, k_blk, c_blk = case
    x, wt, bias = _data(case, sum(case))
    xt, wtt, bt = map(torch.from_numpy, (x, wt, bias))
    assert k4.route(xt, wtt, c_blk, k_blk) == "mma"
    sched = _schedule(case, order)
    kw = dict(stride=stride, padding=pad, rb_p=rb_p, k_blk=k_blk, c_blk=c_blk)
    plain = k4.conv2d_streams_plain(xt, wtt, schedule=sched, bias=bt, **kw)
    exp = np.asarray(jax_conv2d_streams(
        jnp.asarray(x), jnp.asarray(wt), schedule=_to_jax(sched),
        bias=jnp.asarray(bias), interpret=True, **kw))
    shuf = _shuffled(sched, seed=sum(case))
    for adder in ("rn", "rz"):
        out = emulate(xt, wtt, bt, sched, adder=adder, **kw)
        rel_plain, rel_jax = _rel(out, plain), _rel(out, exp)
        print(f"{case} {order} {adder}: max_rel {rel_plain:.3e} against the "
              f"plain replay, {rel_jax:.3e} against the JAX K4")
        assert rel_plain <= LIMIT and rel_jax <= LIMIT
        assert torch.equal(emulate(xt, wtt, bt, shuf, adder=adder, **kw),
                           out)


# -- the tuner's model --------------------------------------------------------

def test_streams_util_follows_the_route():
    """The mma model at the 3xTF32 rate for blockings on the mma route, the
    SIMT model at the f32 rate for the rest; the cost follows."""
    shape = dict(h=56, w=56, c=64, k=64, r=3, s=3, stride=1, padding=1)
    for blk in tune.conv_candidates(**shape, kind="streams")[:6]:
        p = q = 56
        rb_p = min(blk.rb_p, p)
        runs = 16 * (64 // blk.k_blk) * -(-p // rb_p)
        util, peak = measure._streams_util(shape, blk, minibatch=16)
        share = k4.mma_tile_config(tile_m=rb_p * q, k_blk=blk.k_blk,
                                   runs=runs)[1]
        assert peak == roofline.TF32_PEAK_FLOPS / 3 == k4.MMA_PEAK_FLOPS
        depth = k4.mma_stage_c(blk.c_blk)
        assert util == pytest.approx(
            share * blk.c_blk / (-(-blk.c_blk // depth) * depth), rel=1e-12)
    ragged = dict(h=9, w=9, c=12, k=20, r=3, s=3, stride=1, padding=1)
    blk = tune.conv_candidates(**ragged, kind="streams")[0]
    blk = type(blk)(**{**blk.__dict__, "c_blk": 6, "k_blk": 10})
    util, peak = measure._streams_util(ragged, blk, minibatch=2)
    p = q = 9
    runs = 2 * 2 * -(-p // min(blk.rb_p, p))
    assert (util, peak) == (k4.tile_config(
        tile_m=min(blk.rb_p, p) * q, k_blk=10, c_blk=6, runs=runs)[1],
        roofline.F32_PEAK_FLOPS)


def test_cpu_call_counts_no_launch():
    case = CASES[0]
    x, wt, bias = map(torch.from_numpy, _data(case, 0))
    n, h, w, c, k, r, stride, pad, rb_p, k_blk, c_blk = case
    k4.launches = k4.launches_mma = 0
    out = k4.conv2d_streams(x, wt, schedule=_schedule(case, "nkpc"),
                            bias=bias, stride=stride, padding=pad, rb_p=rb_p,
                            k_blk=k_blk, c_blk=c_blk)
    assert (k4.launches, k4.launches_mma) == (0, 0)
    assert torch.isfinite(out).all()
