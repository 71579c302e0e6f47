"""K1's and K10a's mma routes (3xTF32 on the tensor cores) on the CPU.

The routes' kernels (``csrc/conv2d_direct.cu``, ``conv2d_direct_kernel_mma``;
``csrc/conv2d_direct_whole.cu``, ``conv2d_direct_whole_kernel_mma``; both on
the products mainloop of ``csrc/conv_tf32.cuh``) run only on the card.  What
decides them and what they compute are checked here:

* ``conv2d_direct.route`` and ``route_whole`` by channels and alignment;
* K1's ``mma_plan`` on every ResNet-50 serving signature at batch 16, every
  dual signature and every training forward at batch 32: its blocks cover
  every output once, its chunks cover the reduction steps once, in order,
  each of at least ``MMA_MIN_CHUNK`` steps, and the busiest SM's share of
  the products stays near an even one;
* K10a's ``whole_slices`` / ``whole_rows_cta``: the row slices cover each
  reference block once, and ``whole_mma_plan`` fits every whole-plane
  launch of ResNet-50 in a block's shared memory;
* an emulation of the routes' arithmetic in plain torch: tf32 rounding
  (``cvt.rna``) by integer operations on the f32 bits, the split v = hi +
  lo, the three products lo*hi, hi*lo, hi*hi of every 8-channel step summed
  exactly and rounded to f32 under two models of the tensor cores' adder
  (to nearest, toward zero), each 32-channel stage's run added to the f32
  sums in the kernel's stage order ((r, s) outer, C inner for K1; C slice
  outer, tap inner for K10a), a split's partials summed in split order
  (the stage's products: ``tests/_tf32_emulation.stage_run``).  It
  is held to the kernels' limit, 1e-5 of max |out|, against the JAX
  package's ``repro.kernels.ref.conv2d`` (the ``xla`` path) on reduced
  ResNet-50's signatures and on four full-size ones, and prints its
  max_rel there: the prediction the card's reading is set beside;
* a CPU call launches nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _tf32_emulation import single_thread, split, stage_run
from repro.kernels import ref as jax_ref
from repro_torch.core import conv
from repro_torch.core.duality import dual_conv_signatures
from repro_torch.graph import build_etg, resnet50
from repro_torch.graph.serving import conv_shapes
from repro_torch.kernels import conv2d_direct as k1

LIMIT = 1e-5          # K1 and K10a against their reference, max |diff| / max |ref|
H100_SMS = 132
STAGE = k1.MMA_STAGE_C


def _out(h, w, r, s, stride, pad):
    return (h + 2 * pad - r) // stride + 1, (w + 2 * pad - s) // stride + 1


def _signatures(topology, image, batch, *, dual=False):
    """Distinct lane-aligned forward (or dual) signatures of ``topology``:
    key -> dict(n, h, w, c, k, r, s, stride, padding, p, q)."""
    out = {}
    for sh in conv_shapes(build_etg(topology), (image, image)):
        if not conv.lane_ok(sh["c"], sh["k"]):
            continue
        geos = [sh]
        if dual:
            geos = [d for d in dual_conv_signatures(
                r=sh["r"], s=sh["s"], c=sh["c"], k=sh["k"],
                stride=sh["stride"], padding=sh["padding"],
                input_hw=(sh["h"], sh["w"])) if conv.lane_ok(d["c"], d["k"])]
        for g in geos:
            key = (g["h"], g["w"], g["c"], g["k"], g["r"], g["s"],
                   g["stride"], g["padding"])
            h, w, c, k, r, s, st, pad = key
            p, q = _out(h, w, r, s, st, pad)
            out[key] = dict(n=batch, h=h, w=w, c=c, k=k, r=r, s=s, stride=st,
                            padding=pad, p=p, q=q)
    return out


SERVING = _signatures(resnet50(), 224, 16)
TRAIN_FWD = _signatures(resnet50(), 224, 32)
DUAL = _signatures(resnet50(), 224, 32, dual=True)
REDUCED = _signatures(resnet50(10, stages=(1, 1, 1, 1)), 32, 4)
REDUCED_DUAL = _signatures(resnet50(10, stages=(1, 1, 1, 1)), 32, 4,
                           dual=True)


def _plan_args(g):
    return {key: g[key] for key in ("n", "p", "q", "c", "k", "r", "s")}


def test_signature_counts():
    """23 distinct serving signatures have 22 distinct geometries (one
    shared by two epilogues); the training step's 31 distinct duals."""
    assert len(SERVING) == 22 and len(TRAIN_FWD) == 22 and len(DUAL) == 31


# -- routes -------------------------------------------------------------------

def _xw(c, k, offset=None):
    def make(shape, off):
        n = int(np.prod(shape))
        if off:
            return torch.zeros(n + 1)[1:].view(shape)
        return torch.zeros(shape)
    return (make((2, 6, 6, c), offset == "x"),
            make((3, 3, c, k), offset == "w"))


@pytest.mark.parametrize("fn", [k1.route, k1.route_whole],
                         ids=["route", "route_whole"])
@pytest.mark.parametrize("c,k,offset,want", [
    (64, 64, None, "mma"), (4, 12, None, "mma"), (2048, 512, None, "mma"),
    (8, 16, None, "mma"), (5, 7, None, "simt"), (6, 8, None, "simt"),
    (8, 6, None, "simt"), (64, 64, "x", "simt"), (64, 64, "w", "simt")])
def test_route_by_channels_and_alignment(fn, c, k, offset, want):
    """mma when C and K are multiples of 4 and x and w start on 16 bytes;
    a ragged channel count or an offset view takes the SIMT kernel."""
    x, w = _xw(c, k, offset)
    assert fn(x, w) == want


def test_every_lane_aligned_conv_and_dual_takes_the_mma_route():
    for g in list(SERVING.values()) + list(DUAL.values()):
        x, w = _xw(g["c"], g["k"])
        assert k1.route(x, w) == "mma" == k1.route_whole(x, w)


# -- K1's plan ----------------------------------------------------------------

PLANNED = ([("serving", key) for key in SERVING]
           + [("train_fwd", key) for key in TRAIN_FWD]
           + [("dual", key) for key in DUAL])


def _table(kind):
    return {"serving": SERVING, "train_fwd": TRAIN_FWD, "dual": DUAL}[kind]


@pytest.mark.parametrize("kind,key", PLANNED)
def test_mma_plan_covers_every_output_and_step_once(kind, key):
    g = _table(kind)[key]
    pl = k1.mma_plan(**_plan_args(g))
    assert pl.tile in k1.MMA_TILES
    bm, bn = k1.MMA_TILES[pl.tile]
    m = g["n"] * g["p"] * g["q"]
    steps = g["r"] * g["s"] * -(-g["c"] // STAGE)
    tiles = -(-m // bm) * -(-g["k"] // bn)
    assert pl.blocks == tiles * pl.splits
    # every output pixel and channel in one tile
    assert [i for t in range(-(-m // bm))
            for i in range(t * bm, min((t + 1) * bm, m))] == list(range(m))
    # the chunks cover the steps once, in order; none empty
    chunks = [range(j * pl.chunk, min((j + 1) * pl.chunk, steps))
              for j in range(pl.splits)]
    assert all(len(ch) > 0 for ch in chunks)
    assert [t for ch in chunks for t in ch] == list(range(steps))
    assert pl.splits <= k1.MAX_GRID_Z
    if pl.splits > 1:
        assert pl.chunk >= k1.MMA_MIN_CHUNK
    assert k1.mma_plan(**_plan_args(g)) == pl   # a pure function


def test_mma_plan_splits_the_small_planes_at_batch_16():
    """The 7x7 and 14x14 stages at batch 16: the 3x3 512->512 conv has 784
    output pixels, 28 tiles of 128x128 for 132 SMs; the plan cuts its 144
    steps in 5 chunks over 52 tiles of 64x128 (260 blocks: two on 128
    SMs).  Only convs with 14x14 or 7x7 outputs split; none at 56x56 or
    28x28."""
    g = SERVING[(7, 7, 512, 512, 3, 3, 1, 1)]
    pl = k1.mma_plan(**_plan_args(g))
    assert (pl.tile, pl.splits, pl.chunk, pl.blocks) == (2, 5, 29, 260)
    split = sorted(key for key, g in SERVING.items()
                   if k1.mma_plan(**_plan_args(g)).splits > 1)
    print("serving signatures that split:",
          [(key, k1.mma_plan(**_plan_args(SERVING[key]))) for key in split])
    assert split and all(SERVING[key]["p"] <= 14 for key in split)


def test_mma_plan_spreads_the_work():
    """The SM that runs the most blocks does at most 1.35 x an even share
    of a conv's products (a grid of 98 to 112 tiles of 128x128 on 132 SMs;
    splitting those would cost more partials than it saves), and the
    plan's modelled time is no more than the best unsplit one's."""
    for table in (SERVING, TRAIN_FWD, DUAL):
        for g in table.values():
            pl = k1.mma_plan(**_plan_args(g))
            bm, bn = k1.MMA_TILES[pl.tile]
            m = g["n"] * g["p"] * g["q"]
            steps = g["r"] * g["s"] * -(-g["c"] // STAGE)
            busiest = -(-pl.blocks // H100_SMS) * bm * bn * pl.chunk
            assert busiest <= 1.35 * m * g["k"] * steps / H100_SMS, pl
            cost = k1._mma_cost(m, g["k"], pl.tile, pl.splits, pl.chunk)
            assert cost <= min(k1._mma_cost(m, g["k"], code, 1, steps)
                               for code in k1.MMA_TILES)


def test_cpu_call_counts_no_launch():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 9, 9, 8), np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 8, 16), np.float32))
    assert k1.route(x, w) == "mma"
    k1.launches = k1.launches_mma = 0
    k1.launches_whole = k1.launches_whole_mma = 0
    out = k1.conv2d_direct(x, w, stride=1, padding=1)
    whole = k1.conv2d_direct_whole(x, w, stride=1, padding=1, rb_p=4,
                                   k_blk=8)
    assert (k1.launches, k1.launches_mma, k1.launches_whole,
            k1.launches_whole_mma) == (0, 0, 0, 0)
    assert torch.equal(out, k1.conv2d_direct_plain(x, w, stride=1,
                                                   padding=1))
    assert torch.equal(whole, k1.conv2d_direct_whole_plain(
        x, w, stride=1, padding=1, rb_p=4, k_blk=8))


# -- K10a's row split and plan ------------------------------------------------

def _whole_geos():
    """Every whole-plane K10a launch of ResNet-50 at batch 16 (serving) and
    32 (training, forwards and duals), with the reference's blocking."""
    out = []
    for batch, table, kind in ((16, SERVING, "fwd"), (32, TRAIN_FWD, "fwd"),
                               (32, DUAL, "bwd")):
        for g in table.values():
            blk = conv.whole_blocking((batch, g["h"], g["w"], g["c"]),
                                      (g["r"], g["s"], g["c"], g["k"]),
                                      stride=g["stride"],
                                      padding=g["padding"], kind=kind)
            out.append(dict(g, n=batch, rb_p=min(blk.rb_p, g["p"]),
                            k_blk=blk.k_blk))
    return out


WHOLE_GEOS = _whole_geos()


def _slice_rows(p, rb_p, rows_cta):
    """Output rows of each block of K10a's mma grid, as the kernel cuts
    them: reference block pb, slice sl -> rows [pb*rb_p + sl*rows_cta,
    min(pb*rb_p + rb_p, + rows_cta, P))."""
    slices = -(-rb_p // rows_cta)
    out = []
    for pb in range(-(-p // rb_p)):
        for sl in range(slices):
            begin = pb * rb_p + sl * rows_cta
            end = min(pb * rb_p + rb_p, begin + rows_cta, p)
            out.append((pb, range(begin, max(begin, end))))
    return out


@pytest.mark.parametrize("split", [False, True])
def test_whole_row_slices_cover_each_block_once(split, monkeypatch):
    monkeypatch.setattr(k1, "whole_split", lambda **kw: split)
    for g in WHOLE_GEOS:
        kw = dict(n=g["n"], p=g["p"], q=g["q"], k=g["k"], rb_p=g["rb_p"],
                  k_blk=g["k_blk"])
        rows = k1.whole_rows_cta(**kw)
        assert rows == k1.whole_rows_cta(**kw)      # a pure function
        assert 1 <= rows <= g["rb_p"]
        if not split:
            assert rows == g["rb_p"]
        cut = _slice_rows(g["p"], g["rb_p"], rows)
        for pb in range(-(-g["p"] // g["rb_p"])):
            mine = [r_ for b, rng in cut if b == pb for r_ in rng]
            assert mine == list(range(pb * g["rb_p"],
                                      min((pb + 1) * g["rb_p"], g["p"])))
        ctas = sum(1 for _, rng in cut if len(rng)) * g["n"] \
            * (g["k"] // g["k_blk"])
        blocks = g["n"] * (g["k"] // g["k_blk"]) * -(-g["p"] // g["rb_p"])
        if split and blocks < H100_SMS and g["rb_p"] > 1:
            assert ctas > blocks


def test_whole_slices_fill_the_card_where_the_grid_is_small():
    """The 14x14 3x3 256->256 conv at batch 16: 64 reference blocks (a
    10-row and a 4-row one per image and k_blk); 3 slices of at most 4
    rows each (4 + 4 + 2, and 4) give 192 CTAs.  The 56x56 grid of 304
    blocks is cut into none."""
    g = dict(n=16, p=14, k=256, rb_p=10, k_blk=128)
    assert k1.whole_slices(**g) == 3
    assert k1.whole_slices(n=16, p=56, k=64, rb_p=3, k_blk=64) == 1


def test_whole_split_takes_the_small_grids_of_two_passes():
    """The rule cuts the reference blocks of exactly the three batch-16
    signatures with 14x14 outputs, 10-row blocks (a 126- and a 14-pixel
    pass) and 64 blocks; no training launch at batch 32 (their grids hold
    128 blocks or more)."""
    def split(g):
        return k1.whole_split(n=g["n"], p=g["p"], q=g["q"], k=g["k"],
                              rb_p=g["rb_p"], k_blk=g["k_blk"])
    taken = sorted((g["h"], g["c"], g["k"], g["r"], g["stride"])
                   for g in WHOLE_GEOS if g["n"] == 16 and split(g))
    assert taken == [(14, 256, 256, 3, 1), (14, 1024, 256, 1, 1),
                     (28, 256, 256, 3, 2)]
    assert not any(split(g) for g in WHOLE_GEOS if g["n"] == 32)


def test_whole_mma_plan_fits_every_resnet50_launch():
    """Every whole-plane launch of ResNet-50 fits the shared memory, in
    passes of whole rows of at most WHOLE_MMA_PASS pixels."""
    for g in WHOLE_GEOS:
        for rows in (g["rb_p"], 1):
            plan = k1.whole_mma_plan(
                p=g["p"], q=g["q"], k_blk=g["k_blk"], rb_p=g["rb_p"],
                r=g["r"], s=g["s"], stride=g["stride"], rows_cta=rows)
            assert plan.smem <= k1.SMEM_LIMIT
            assert plan.cols == g["q"]          # whole rows: Q <= 128
            assert plan.rows_pass * plan.cols <= k1.WHOLE_MMA_PASS
            assert plan.rows_pass <= plan.rows_cta == rows
            assert plan.rows_pass == min(rows, k1.WHOLE_MMA_PASS // g["q"])
            assert plan.band_rows == (plan.rows_pass - 1) * g["stride"] \
                + g["r"]
            assert plan.band_cols == (g["q"] - 1) * g["stride"] + g["s"]
            assert plan.band_cols <= g["w"] + 2 * g["padding"]
            assert plan.bn >= g["k_blk"]


def test_whole_mma_plan_raises_like_whole_plan():
    kw = dict(p=8, q=8, rb_p=4, r=3, s=3, stride=1, rows_cta=4)
    with pytest.raises(ValueError, match="k_blk 12"):
        k1.whole_mma_plan(k_blk=12, **kw)
    with pytest.raises(ValueError, match="k_blk 256"):
        k1.whole_mma_plan(k_blk=256, **kw)
    with pytest.raises(ValueError, match="shared memory"):
        k1.whole_mma_plan(k_blk=8, p=8, q=300, rb_p=4, r=99, s=99,
                          stride=1, rows_cta=4)
    # a row wider than a pass: segments of 128 columns, one row a pass; at
    # stride 2 their band exceeds the shared memory, 64 columns fit
    wide = k1.whole_mma_plan(k_blk=8, p=8, q=300, rb_p=4, r=3, s=3,
                             stride=1, rows_cta=4)
    assert (wide.rows_pass, wide.cols, wide.band_rows, wide.band_cols) == \
        (1, k1.WHOLE_MMA_PASS, 3, 127 + 3)
    wide = k1.whole_mma_plan(k_blk=8, p=8, q=300, rb_p=4, r=3, s=3,
                             stride=2, rows_cta=4)
    assert (wide.rows_pass, wide.cols, wide.band_cols) == (1, 64, 129)


# -- the emulation ------------------------------------------------------------

def emulate(x, w, *, stride, padding, adder, order="k1", chunk=None,
            rows=4096):
    """out (N,P,Q,K) before the epilogue, as an mma route computes it, on
    f32 CPU tensors.  The stages are (tap, 32-channel slice) pairs, taps
    outer for K1 (``order="k1"``), slices outer for K10a ("k10a"); each
    stage's run joins the f32 sums (to nearest) in that order; with
    ``chunk``, every ``chunk`` stages start a new partial from zero and
    the partials are summed in split order.  Pixels are independent, so
    they go ``rows`` at a time, on one torch thread."""
    n, h, wd, c = x.shape
    r, s, _, k = w.shape
    p, q = _out(h, wd, r, s, stride, padding)
    m = n * p * q
    cs = -(-c // STAGE)
    pad_c = cs * STAGE - c
    xp = F.pad(x, (0, pad_c, padding, padding, padding, padding))
    wz = F.pad(w, (0, 0, 0, pad_c))
    taps = [(rr, ss) for rr in range(r) for ss in range(s)]
    a_tap = {t: xp[:, t[0]:t[0] + (p - 1) * stride + 1:stride,
                   t[1]:t[1] + (q - 1) * stride + 1:stride, :].reshape(m, -1)
             for t in taps}
    stages = ([(t, sc) for t in taps for sc in range(cs)] if order == "k1"
              else [(t, sc) for sc in range(cs) for t in taps])
    chunk = chunk or len(stages)
    # each stage's weights split once, for every run of pixels
    w_split = {(t, sc): split(wz[t[0], t[1], sc * STAGE:(sc + 1) * STAGE])
               for t, sc in stages}
    out = torch.empty((m, k))
    with single_thread():
        for m0 in range(0, m, rows):
            parts, acc = [], None
            for i, (t, sc) in enumerate(stages):
                if i % chunk == 0:
                    if acc is not None:
                        parts.append(acc)
                    acc = torch.zeros((min(rows, m - m0), k))
                a = a_tap[t][m0:m0 + rows, sc * STAGE:(sc + 1) * STAGE]
                acc = acc + stage_run(a, w_split[t, sc], adder)
            parts.append(acc)
            total = parts[0]
            for part in parts[1:]:
                total = total + part
            out[m0:m0 + rows] = total
    return out.reshape(n, p, q, k)


def _inputs(g, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((g["n"], g["h"], g["w"], g["c"])).astype(
        np.float32)
    w = (rng.standard_normal((g["r"], g["s"], g["c"], g["k"]))
         * np.sqrt(2.0 / (g["r"] * g["s"] * g["c"]))).astype(np.float32)
    return x, w


def _jax_out(x, w, g):
    return np.asarray(jax_ref.conv2d(jnp.asarray(x), jnp.asarray(w),
                                     stride=g["stride"],
                                     padding=g["padding"]), np.float32)


def _rel(out, exp):
    return float(np.abs(out.numpy() - exp).max() / np.abs(exp).max())


REDUCED_CASES = ([("fwd", key) for key in REDUCED]
                 + [("dual", key) for key in REDUCED_DUAL])


@pytest.mark.parametrize("kind,key", REDUCED_CASES)
def test_emulation_holds_the_limit_on_reduced_resnet50(kind, key):
    """Both routes' orders, K1's with its plan's split, under both adder
    models, against the JAX reference on reduced ResNet-50 (32x32, batch
    4)."""
    g = (REDUCED if kind == "fwd" else REDUCED_DUAL)[key]
    x, w = _inputs(g, sum(key))
    exp = _jax_out(x, w, g)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    pl = k1.mma_plan(**_plan_args(g))
    for order, chunk in (("k1", pl.chunk), ("k10a", None)):
        for adder in ("rn", "rz"):
            out = emulate(xt, wt, stride=g["stride"], padding=g["padding"],
                          adder=adder, order=order, chunk=chunk)
            rel = _rel(out, exp)
            print(f"reduced {kind} {key} {order} {adder}: predicted max_rel "
                  f"{rel:.3e}")
            assert rel <= LIMIT, (key, order, adder, rel)


# the four full-size signatures the card's readings are set beside: the
# 7x7 3x3 512->512 (R*S*C = 4608) and 1x1 2048->512 convs and the 56x56 1x1
# 64->256 one at batch 16 (serving), and the 2x2 dual sub-filter of the
# 56x56 -> 28x28 3x3 stride-2 layer at batch 32 (a training step)
FULL = [("serving", (7, 7, 512, 512, 3, 3, 1, 1)),
        ("serving", (7, 7, 2048, 512, 1, 1, 1, 0)),
        ("serving", (56, 56, 64, 256, 1, 1, 1, 0)),
        ("dual", (30, 30, 128, 128, 2, 2, 1, 0))]


@pytest.mark.parametrize("kind,key", FULL)
def test_emulation_predicts_the_full_size_signatures(kind, key):
    """K1's order with its plan at full size: the prediction for each model
    of the adder, against the JAX reference and against the port's plain
    version (what chip_smoke.py phases 2 and 8 hold the kernel to)."""
    g = _table(kind)[key]
    x, w = _inputs(g, 23)
    exp = _jax_out(x, w, g)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    plain = k1.conv2d_direct_plain(xt, wt, stride=g["stride"],
                                   padding=g["padding"])
    pl = k1.mma_plan(**_plan_args(g))
    for adder in ("rn", "rz"):
        out = emulate(xt, wt, stride=g["stride"], padding=g["padding"],
                      adder=adder, chunk=pl.chunk)
        rel = _rel(out, exp)
        rel_plain = _rel(out, plain.numpy())
        print(f"{kind} {key} batch {g['n']} ({pl}), adder {adder}: "
              f"predicted max_rel {rel:.3e} against the JAX reference, "
              f"{rel_plain:.3e} against the plain version (limit {LIMIT})")
        assert rel <= LIMIT and rel_plain <= LIMIT, (key, adder, rel)
