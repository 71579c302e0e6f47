"""K2's mma route (3xTF32 on the tensor cores) on the CPU.

The route's kernel (``csrc/conv2d_wu.cu``, ``conv2d_wu_kernel_mma``) runs
only on the card.  What decides it and what it computes are checked here:

* ``conv2d_wu.route`` by channels and alignment, and the raises of
  ``plan`` on either route;
* the mma route's ``plan`` on every ResNet-50 weight-update signature at
  batch 32: its chunks cover every pixel once, each a whole number of
  32-pixel stages and at most ``MMA_MAX_CHUNK``, and its grid fills the
  card's block slots;
* an emulation of the kernel's arithmetic in plain torch: tf32 rounding
  (``cvt.rna``) by integer operations on the f32 bits, the split v = hi +
  lo, the three products lo*hi, hi*lo, hi*hi of every 8-pixel step summed
  exactly and rounded to f32 under two models of the tensor cores' adder
  (to nearest, toward zero), each 32-pixel stage's run added to the
  block's f32 sums, and the chunks' partials summed in split order.  It is
  held to the kernel's limit, 1e-5 of max |dW|, against the JAX package's
  ``repro.kernels.ref.conv2d_bwd_weights`` on reduced ResNet-50's
  signatures and on two full-size ones at batch 32 (the 56x56 1x1 64->64
  layer's 100,352 pixels, the 7x7 3x3 512->512 layer), and prints its
  max_rel there: the prediction the card's reading is set beside;
* the same emulation with one tensor-core run over a whole chunk, which
  under the toward-zero model drifts past the limit: why the kernel adds
  each stage's run to SIMT sums.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jax_ref
from repro_torch.core import conv
from repro_torch.graph import build_etg, resnet50
from repro_torch.graph.serving import conv_shapes
from repro_torch.kernels import conv2d_wu as k2

LIMIT = 1e-5          # K2 against its reference, max |diff| / max |ref|
STAGE = k2.MMA_PIX_STEP
H100_SMS = 132


def _signatures(topology, image, batch):
    """Distinct lane-aligned weight-update signatures of ``topology``."""
    out = {}
    for sh in conv_shapes(build_etg(topology), (image, image)):
        if not conv.lane_ok(sh["c"], sh["k"]):
            continue
        key = (sh["h"], sh["w"], sh["c"], sh["k"], sh["r"], sh["s"],
               sh["stride"], sh["padding"])
        h, w, c, k, r, s, st, pad = key
        out[key] = dict(n=batch, h=h, w=w, c=c, k=k, r=r, s=s, stride=st,
                        padding=pad, p=(h + 2 * pad - r) // st + 1,
                        q=(w + 2 * pad - s) // st + 1)
    return out


RESNET50 = _signatures(resnet50(), 224, 32)
REDUCED = _signatures(resnet50(10, stages=(1, 1, 1, 1)), 32, 8)


def _plan_args(g):
    return {key: g[key] for key in ("n", "p", "q", "c", "k", "r", "s")}


# -- route and plan -----------------------------------------------------------

def _xd(c, k, offset=None):
    def make(shape, off):
        n = int(np.prod(shape))
        if off:
            return torch.zeros(n + 1)[1:].view(shape)
        return torch.zeros(shape)
    return (make((2, 6, 6, c), offset == "x"),
            make((2, 6, 6, k), offset == "do"))


@pytest.mark.parametrize("c,k,offset,want", [
    (64, 64, None, "mma"), (4, 12, None, "mma"), (2048, 512, None, "mma"),
    (5, 7, None, "simt"), (6, 8, None, "simt"), (8, 6, None, "simt"),
    (64, 64, "x", "simt"), (64, 64, "do", "simt")])
def test_route_by_channels_and_alignment(c, k, offset, want):
    """mma when C and K are multiples of 4 and both operands start on 16
    bytes; a ragged channel count or an offset view takes the SIMT
    kernel."""
    x, do = _xd(c, k, offset)
    assert k2.route(x, do) == want


def test_every_resnet50_signature_takes_the_mma_route():
    for g in RESNET50.values():
        x, do = _xd(g["c"], g["k"])
        assert k2.route(x, do) == "mma"


def test_plan_raises_on_either_route():
    with pytest.raises(ValueError, match="route must be one of"):
        k2.plan(n=1, p=4, q=4, c=8, k=8, r=1, s=1, route="wgmma")
    for route in k2.ROUTES:     # splits x R x S past the grid's z limit
        with pytest.raises(ValueError, match="z limit"):
            k2.plan(n=2 ** 20, p=64, q=64, c=8, k=8, r=7, s=7, route=route)


def test_simt_plan_is_the_default_and_unchanged():
    for g in RESNET50.values():
        a = _plan_args(g)
        assert k2.plan(**a) == k2.plan(**a, route="simt")
        assert k2.plan(**a).route == "simt"


@pytest.mark.parametrize("key", list(RESNET50))
def test_mma_plan_covers_every_pixel_once(key):
    g = RESNET50[key]
    m = g["n"] * g["p"] * g["q"]
    pl = k2.plan(**_plan_args(g), route="mma")
    assert pl.route == "mma" and pl.tile in k2.MMA_TILES
    bm, bn = k2.MMA_TILES[pl.tile]
    assert bm == (128 if g["c"] >= 128 else 64)
    assert bn == (128 if g["k"] >= 128 else 64)
    assert pl.chunk % STAGE == 0 and pl.chunk <= k2.MMA_MAX_CHUNK
    assert pl.splits <= max(1, -(-m // k2.MMA_MIN_CHUNK))
    chunks = [range(j * pl.chunk, min((j + 1) * pl.chunk, m))
              for j in range(pl.splits)]
    assert all(len(ch) > 0 for ch in chunks)
    assert [i for ch in chunks for i in ch] == list(range(m))
    assert pl.splits * g["r"] * g["s"] <= k2.MAX_GRID_Z
    # the grid fills the card's block slots wherever the pixels allow
    tiles = -(-g["c"] // bm) * -(-g["k"] // bn) * g["r"] * g["s"]
    slots = H100_SMS * k2.MMA_BLOCKS_PER_SM[pl.tile]
    most = tiles * max(1, -(-m // k2.MMA_MIN_CHUNK))
    assert tiles * pl.splits >= 0.9 * min(slots, most), (pl, tiles, slots)
    assert k2.plan(**_plan_args(g), route="mma") == pl   # a pure function


def test_mma_plan_fills_the_rounds():
    """The 3x3 convs of the 14x14 and 28x28 stages at batch 32: 36 output
    tiles; the split fills three rounds of the card's 132 one-block slots
    (11 chunks of 576 pixels) where a fixed two-blocks-an-SM target gave
    288 blocks in three rounds of 800."""
    g = RESNET50[(14, 14, 256, 256, 3, 3, 1, 1)]
    pl = k2.plan(**_plan_args(g), route="mma")
    assert (pl.tile, pl.splits, pl.chunk) == (0, 11, 576)
    assert 36 * pl.splits == 3 * H100_SMS


def test_cpu_call_counts_no_launch():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 9, 9, 8), np.float32))
    do = torch.from_numpy(rng.standard_normal((2, 9, 9, 16), np.float32))
    assert k2.route(x, do) == "mma"
    k2.launches = k2.launches_mma = 0
    out = k2.conv2d_wu(x, do, stride=1, padding=1, filter_rs=(3, 3))
    assert (k2.launches, k2.launches_mma) == (0, 0)
    assert torch.equal(out, k2.conv2d_wu_plain(x, do, stride=1, padding=1,
                                               filter_rs=(3, 3)))


# -- the emulation ------------------------------------------------------------

def tf32(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on f32 bits: round the 13 low mantissa bits to
    nearest, ties away from zero (the sign is apart from the magnitude, so
    adding half a step to the bits rounds the magnitude up on a tie)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def to_f32(x64: torch.Tensor, adder: str) -> torch.Tensor:
    """An exact float64 sum rounded to f32: to nearest ("rn") or toward
    zero ("rz")."""
    r = x64.float()
    if adder == "rz":
        over = r.double().abs() > x64.abs()
        r = torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def emulate(x, do, *, stride, padding, r, s, adder, stage=STAGE, pl=None):
    """dW (R,S,C,K) as the mma route computes it, on f32 CPU tensors: per
    tap the (pixels, C)^T x (pixels, K) product, the pixels cut as
    ``plan(route="mma")`` cuts them; in each chunk the tensor-core run of
    every ``stage`` pixels starts at zero and takes, per 8 pixels, the
    exact sums of lo*hi, hi*lo and hi*hi, each rounded to f32 by
    ``adder``; the run then joins the chunk's f32 sums (to nearest); the
    chunks' partials are summed in split order.  ``stage`` = the chunk
    gives one run over the whole chunk; ``pl`` replaces the plan."""
    n, h, w, c = x.shape
    _, p, q, k = do.shape
    pl = pl or k2.plan(n=n, p=p, q=q, c=c, k=k, r=r, s=s, route="mma")
    m = n * p * q
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    taps = [xp[:, rr:rr + (p - 1) * stride + 1:stride,
               ss:ss + (q - 1) * stride + 1:stride, :].reshape(m, c)
            for rr in range(r) for ss in range(s)]
    pad = pl.splits * pl.chunk - m
    a = torch.stack(taps)                                   # (taps, m, c)
    a = torch.cat([a, a.new_zeros(len(taps), pad, c)], dim=1)
    a = a.reshape(len(taps) * pl.splits, pl.chunk, c)
    b = torch.cat([do.reshape(m, k), do.new_zeros(pad, k)])
    b = b.reshape(1, pl.splits, pl.chunk, k).expand(len(taps), -1, -1, -1) \
        .reshape(len(taps) * pl.splits, pl.chunk, k)
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    pairs = [(x_.transpose(1, 2).double(), y_.double())
             for x_, y_ in ((al, bh), (ah, bl), (ah, bh))]
    acc = torch.zeros((a.shape[0], c, k))
    for t0 in range(0, pl.chunk, stage):
        run = torch.zeros_like(acc)
        for t in range(t0, min(t0 + stage, pl.chunk), 8):
            for at, bt in pairs:
                run = to_f32(run.double() + torch.bmm(at[:, :, t:t + 8],
                                                     bt[:, t:t + 8]), adder)
        acc = acc + run
    acc = acc.reshape(len(taps), pl.splits, c, k)
    dw = acc[:, 0].clone()
    for j in range(1, pl.splits):
        dw = dw + acc[:, j]
    return dw.reshape(r, s, c, k)


def _inputs(g, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((g["n"], g["h"], g["w"], g["c"])).astype(
        np.float32)
    do = rng.standard_normal((g["n"], g["p"], g["q"], g["k"])).astype(
        np.float32)
    return x, do


def _jax_dw(x, do, g):
    return np.asarray(jax_ref.conv2d_bwd_weights(
        jnp.asarray(x), jnp.asarray(do), stride=g["stride"],
        padding=g["padding"], filter_rs=(g["r"], g["s"])), np.float32)


def _rel(out, exp):
    return float(np.abs(out.numpy() - exp).max() / np.abs(exp).max())


@pytest.mark.parametrize("key", list(REDUCED))
def test_emulation_holds_the_limit_on_reduced_resnet50(key):
    g = REDUCED[key]
    x, do = _inputs(g, sum(key))
    exp = _jax_dw(x, do, g)
    for adder in ("rn", "rz"):
        out = emulate(torch.from_numpy(x), torch.from_numpy(do),
                      stride=g["stride"], padding=g["padding"], r=g["r"],
                      s=g["s"], adder=adder)
        rel = _rel(out, exp)
        print(f"reduced {key} {adder}: predicted max_rel {rel:.3e}")
        assert rel <= LIMIT, (key, adder, rel)


FULL = [(56, 56, 64, 64, 1, 1, 1, 0), (7, 7, 512, 512, 3, 3, 1, 1)]


@pytest.mark.parametrize("key", FULL)
def test_emulation_predicts_the_full_size_signatures(key):
    """The two signatures the card's reading is compared with, at batch
    32: the prediction for each model of the adder, against the JAX
    reference and against the port's plain version (what phase 9 of
    chip_smoke.py holds the kernel to)."""
    g = RESNET50[key]
    x, do = _inputs(g, 22)
    exp = _jax_dw(x, do, g)
    xt, dot = torch.from_numpy(x), torch.from_numpy(do)
    plain = k2.conv2d_wu_plain(xt, dot, stride=g["stride"],
                               padding=g["padding"],
                               filter_rs=(g["r"], g["s"]))
    pl = k2.plan(**_plan_args(g), route="mma")
    for adder in ("rn", "rz"):
        out = emulate(xt, dot, stride=g["stride"], padding=g["padding"],
                      r=g["r"], s=g["s"], adder=adder)
        rel = _rel(out, exp)
        rel_plain = _rel(out, plain.numpy())
        print(f"{key} batch 32 ({pl}), adder {adder}: predicted max_rel "
              f"{rel:.3e} against the JAX reference, {rel_plain:.3e} "
              f"against the plain version (limit {LIMIT})")
        assert rel <= LIMIT and rel_plain <= LIMIT, (key, adder, rel)


def test_one_run_over_a_chunk_drifts_toward_zero():
    """Without the stage runs, chunks of MMA_MAX_CHUNK pixels summed in the
    tensor cores' accumulator alone, rounded toward zero at every product
    step, leave the limit; rounded to nearest they would not, nor do runs
    of one stage."""
    g = dict(n=32, h=16, w=16, c=64, k=64, r=1, s=1, stride=1, padding=0,
             p=16, q=16)
    x, do = _inputs(g, 5)
    pl = k2.WuPlan(tile=3, splits=4, chunk=k2.MMA_MAX_CHUNK, route="mma")
    xt, dot = torch.from_numpy(x), torch.from_numpy(do)
    exp = _jax_dw(x, do, g)
    kw = dict(stride=1, padding=0, r=1, s=1, pl=pl)
    drift = _rel(emulate(xt, dot, adder="rz", stage=pl.chunk, **kw), exp)
    nearest = _rel(emulate(xt, dot, adder="rn", stage=pl.chunk, **kw), exp)
    staged = _rel(emulate(xt, dot, adder="rz", **kw), exp)
    print(f"one run of {pl.chunk} pixels: toward zero {drift:.3e}, to nearest "
          f"{nearest:.3e}; runs of {STAGE}: {staged:.3e}")
    assert drift > LIMIT > 10 * max(nearest, staged)
