"""The port's CUDA kernels on the card, against their plain versions.

These need an NVIDIA GPU with the CUDA toolkit (``nvcc``): a CUDA kernel has
no CPU mode, so elsewhere they skip.  On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import math

import pytest
import torch

from repro_torch.core import streams
from repro_torch.core.conv import conv2d_train
from repro_torch.kernels import conv2d_direct as k1
from repro_torch.kernels import conv2d_q8 as k3
from repro_torch.kernels import conv2d_streams as k4
from repro_torch.kernels import conv2d_wu as k2
from repro_torch.kernels import ref

pytestmark = pytest.mark.gpu

# n, h, w, c, k, r, stride, pad — ragged C/K (no float4 path), P/Q tails,
# 1x1 / 3x3 / 7x7, stride 1 and 2, a plane small enough for the 64x64 tile
CASES = [
    (2, 9, 9, 8, 16, 3, 1, 1),
    (1, 14, 14, 16, 32, 1, 1, 0),
    (2, 16, 16, 8, 8, 3, 2, 1),
    (1, 12, 12, 8, 8, 5, 1, 2),
    (1, 24, 24, 8, 16, 7, 2, 3),
    (3, 11, 13, 5, 7, 3, 2, 1),
    (2, 7, 7, 512, 2048, 1, 1, 0),
    (16, 56, 56, 64, 64, 3, 1, 1),
]
EPILOGUES = [dict(), dict(bn=True, relu=True),
             dict(bn=True, residual=True, relu=True),
             dict(bias=True, bn=True, residual=True, relu=True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.backend import resolve_device
    return resolve_device("cuda")


def _args(case, dev, *, bias=False, bn=False, residual=False, relu=False):
    n, h, w, c, k, r, stride, pad = case
    g = torch.Generator(device=dev).manual_seed(0)
    p = (h + 2 * pad - r) // stride + 1
    q = (w + 2 * pad - r) // stride + 1
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    return dict(x=rnd(n, h, w, c), w=rnd(r, r, c, k) / math.sqrt(r * r * c),
                stride=stride, padding=pad,
                bias=rnd(k) if bias else None,
                scale=rnd(k) if bn else None, shift=rnd(k) if bn else None,
                residual=rnd(n, p, q, k) if residual else None, relu=relu)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("epi", range(len(EPILOGUES)))
def test_kernel_matches_plain(cuda, case, epi):
    args = _args(case, cuda, **EPILOGUES[epi])
    before = k1.launches
    out = k1.conv2d_direct(**args)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    exp = k1.conv2d_direct_plain(**args)
    assert out.shape == exp.shape and out.device == exp.device
    err = float((out - exp).abs().max())
    assert err <= 1e-5 * max(float(exp.abs().max()), 1.0), err


def test_kernel_rejects_what_it_does_not_take(cuda):
    args = _args(CASES[0], cuda)
    with pytest.raises(ValueError, match="float32"):
        k1.conv2d_direct(**{**args, "x": args["x"].double()})
    with pytest.raises(ValueError, match="contiguous"):
        k1.conv2d_direct(**{**args, "x": args["x"].transpose(1, 2)})
    with pytest.raises(ValueError, match="on cpu"):
        k1.conv2d_direct(**{**args, "w": args["w"].cpu()})


def _rel_err(out, exp):
    return float((out - exp).abs().max()) / float(exp.abs().max())


def _row_rel_err(out, exp):
    """max |diff| / max |exp| within each row of the last axis, the worst
    row's."""
    return float(((out - exp).abs().amax(-1)
                  / exp.abs().amax(-1).clamp_min(1e-30)).max())


@pytest.mark.parametrize("r,s", [(2, 2), (2, 1), (1, 2), (1, 1)])
def test_kernel_on_dual_subfilters(cuda, r, s):
    """The sub-filters of the phase plan of a 3x3 stride-2 conv, padding 0,
    on the pre-padded dO plane of ResNet-50's 56x56 -> 28x28 layer."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((4, 28 + r - 1, 28 + s - 1, 128), generator=g,
                    device=cuda)
    w = torch.randn((r, s, 128, 128), generator=g, device=cuda) / 16
    before = k1.launches
    out = k1.conv2d_direct(x, w, stride=1, padding=0)
    torch.cuda.synchronize()
    assert k1.launches == before + 1 and out.shape == (4, 28, 28, 128)
    assert _rel_err(out, k1.conv2d_direct_plain(x, w, stride=1,
                                                padding=0)) <= 1e-5


# n, h, w, c, k, r, stride, pad
WU_CASES = [
    (3, 11, 13, 5, 7, 3, 2, 1),          # ragged C and K
    (2, 9, 9, 8, 16, 3, 1, 1),           # P/Q tails
    (2, 16, 16, 8, 8, 3, 2, 1),          # stride 2
    (1, 24, 24, 8, 16, 7, 2, 3),         # 7x7 stride-2 halo
    (1, 4, 4, 8, 8, 1, 1, 0),            # one split
    (32, 56, 56, 64, 64, 1, 1, 0),       # 100k-pixel reduction, many splits
    (32, 28, 28, 128, 128, 3, 1, 1),     # the 128x128 tile
    (8, 14, 14, 256, 64, 1, 2, 0),       # the 128x64 tile, 1x1 stride 2
    (4, 7, 7, 2048, 512, 1, 1, 0),
] + [(2, 15, 15, 16, 24, r, 1, r // 2) for r in range(1, 8)]


def _wu_args(case, dev):
    n, h, w, c, k, r, stride, pad = case
    g = torch.Generator(device=dev).manual_seed(2)
    p = (h + 2 * pad - r) // stride + 1
    q = (w + 2 * pad - r) // stride + 1
    return dict(x=torch.randn((n, h, w, c), generator=g, device=dev),
                do=torch.randn((n, p, q, k), generator=g, device=dev),
                stride=stride, padding=pad, filter_rs=(r, r))


@pytest.mark.parametrize("case", WU_CASES)
def test_wu_kernel_matches_plain(cuda, case):
    args = _wu_args(case, cuda)
    before = k2.launches
    out = k2.conv2d_wu(**args)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    exp = k2.conv2d_wu_plain(**args)
    assert out.shape == exp.shape and out.device == exp.device
    assert _rel_err(out, exp) <= 1e-5
    again = k2.conv2d_wu(**args)           # a fixed summation order
    assert torch.equal(out, again)


def test_wu_plan_extremes_run(cuda):
    one = _wu_args(WU_CASES[4], cuda)
    assert k2.plan(n=1, p=4, q=4, c=8, k=8, r=1, s=1).splits == 1
    assert _rel_err(k2.conv2d_wu(**one), k2.conv2d_wu_plain(**one)) <= 1e-5
    assert k2.plan(n=32, p=56, q=56, c=64, k=64, r=1, s=1).splits > 200


def test_wu_kernel_rejects_what_it_does_not_take(cuda):
    args = _wu_args(WU_CASES[1], cuda)
    with pytest.raises(ValueError, match="float32"):
        k2.conv2d_wu(**{**args, "x": args["x"].double()})
    with pytest.raises(ValueError, match="contiguous"):
        k2.conv2d_wu(**{**args, "do": args["do"].transpose(1, 2)})
    with pytest.raises(ValueError, match="on cpu"):
        k2.conv2d_wu(**{**args, "do": args["do"].cpu()})


# h, c, k, r, stride, pad: the scenarios of tests/test_duality.py
TRAIN_CASES = [(8, 8, 16, 3, 1, 1), (8, 8, 8, 1, 2, 0), (16, 8, 8, 3, 2, 1),
               (9, 8, 8, 3, 2, 1), (11, 8, 8, 5, 3, 2), (24, 8, 16, 7, 2, 3),
               (13, 24, 40, 3, 2, 1)]


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_conv2d_train_grads_match_ref(cuda, case):
    """dI by duality through K1 and dW through K2, against autograd of the
    cuDNN oracle with TF32 off: max |diff| <= 1e-4 * max |ref|."""
    h, c, k, r, stride, pad = case
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((2, h, h, c), generator=g, device=cuda)
    w = torch.randn((r, r, c, k), generator=g, device=cuda) * 0.1
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    b1, b2 = k1.launches, k2.launches
    torch.sin(conv2d_train(xk, wk, stride, pad)).sum().backward()
    torch.cuda.synchronize()
    assert k1.launches > b1 and k2.launches == b2 + 1
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    torch.sin(ref.conv2d(xr, wr, stride=stride, padding=pad)).sum().backward()
    assert _rel_err(xk.grad, xr.grad) <= 1e-4
    assert _rel_err(wk.grad, wr.grad) <= 1e-4


def _q8_args(case, dev, *, bias=False, bn=False, residual=False, relu=False):
    """int8 operands from ``quantize_conv_inputs`` on random f32, f32
    epilogue operands."""
    f = _args(case, dev, bias=bias, bn=bn, residual=residual, relu=relu)
    x_q, w_q, x_scale, w_scale = k3.quantize_conv_inputs(f.pop("x"),
                                                         f.pop("w"))
    return dict(x_q=x_q, w_q=w_q, x_scale=x_scale, w_scale=w_scale, **f)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("epi", range(len(EPILOGUES)))
def test_q8_kernel_matches_plain_bit_for_bit(cuda, case, epi):
    """K3 against its plain version: int32 sums are exact and the f32
    epilogue rounds in the same places, so max |diff| = 0."""
    args = _q8_args(case, cuda, **EPILOGUES[epi])
    before = k3.launches
    out = k3.conv2d_q8(**args)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    exp = k3.conv2d_q8_plain(**args)
    assert out.shape == exp.shape and out.dtype == torch.float32
    assert torch.equal(out, exp), float((out - exp).abs().max())


# K3's 128x128 tile, with whole-vector loads (C % 16 == 0) and byte loads
Q8_TILE_CASES = [(16, 28, 28, 64, 256, 1, 1, 0), (32, 28, 28, 24, 100, 3, 1, 1)]


@pytest.mark.parametrize("case", Q8_TILE_CASES)
def test_q8_kernel_large_tile_matches_plain(cuda, case):
    args = _q8_args(case, cuda, **EPILOGUES[-1])
    out = k3.conv2d_q8(**args)
    assert torch.equal(out, k3.conv2d_q8_plain(**args))


@pytest.mark.parametrize("c,k", [(8, 8), (64, 128), (5, 7)])
def test_q8_kernel_integer_inputs_exact(cuda, c, k):
    """Integer-valued inputs with unit scales and no epilogue: K3 equals
    the float64 conv of the same integers on the CPU."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randint(-3, 4, (2, 9, 9, c), generator=g, device=cuda)
    w = torch.randint(-3, 4, (3, 3, c, k), generator=g, device=cuda)
    out = k3.conv2d_q8(x.to(torch.int8), w.to(torch.int8),
                       x_scale=torch.ones((), device=cuda),
                       w_scale=torch.ones(k, device=cuda), stride=1,
                       padding=1)
    exp = ref.conv2d(x.double().cpu(), w.double().cpu(), stride=1,
                     padding=1)
    assert torch.equal(out.cpu(), exp.float())


def test_q8_kernel_overflow_and_rejects(cuda):
    x = torch.zeros((1, 3, 3, 16384), dtype=torch.int8, device=cuda)
    w = torch.zeros((3, 3, 16384, 8), dtype=torch.int8, device=cuda)
    one, ones = torch.ones((), device=cuda), torch.ones(8, device=cuda)
    before = k3.launches
    with pytest.raises(ValueError, match="overflow"):
        k3.conv2d_q8(x, w, x_scale=one, w_scale=ones, padding=1)
    args = _q8_args(CASES[0], cuda)
    with pytest.raises(ValueError, match="int8"):
        k3.conv2d_q8(**{**args, "x_q": args["x_q"].float()})
    with pytest.raises(ValueError, match="contiguous"):
        k3.conv2d_q8(**{**args, "x_q": args["x_q"].transpose(1, 2)})
    with pytest.raises(ValueError, match="on cpu"):
        k3.conv2d_q8(**{**args, "x_scale": args["x_scale"].cpu()})
    with pytest.raises(ValueError, match="float32"):
        k3.conv2d_q8(**{**args, "w_scale": args["w_scale"].double()})
    assert k3.launches == before



# K3's two routes: n, h, w, c, k, r, stride, pad.  Grids the plan splits
# (7x7 and 14x14 planes with long reductions, a batch of 1), tails of M and
# K inside a tile (K 40, 200), 64-channel stages (C 16, 48, 64) and
# 128-channel ones, stride 2
Q8_RING_CASES = [
    (16, 7, 7, 512, 512, 3, 1, 1), (1, 7, 7, 2048, 512, 1, 1, 0),
    (2, 14, 14, 256, 256, 3, 1, 1), (3, 9, 11, 48, 40, 3, 2, 1),
    (1, 13, 13, 16, 200, 5, 1, 2), (16, 56, 56, 64, 256, 1, 1, 0),
    (2, 28, 28, 128, 128, 3, 2, 1), (1, 14, 14, 1024, 2048, 1, 2, 0),
]


@pytest.mark.parametrize("case", Q8_RING_CASES)
@pytest.mark.parametrize("epi", [0, 2, 3])
def test_q8_both_routes_match_plain_bit_for_bit(cuda, case, epi,
                                                monkeypatch):
    """The ring route (the plan's split where it takes one) and the sync
    route forced on the same inputs: both equal the plain version, and a
    second ring launch gives the same bits (the split's counters reset)."""
    args = _q8_args(case, cuda, **EPILOGUES[epi])
    exp = k3.conv2d_q8_plain(**args)
    assert k3.route(args["x_q"], args["w_q"]) == "ring"
    before, ring = k3.launches, k3.launches_ring
    out = k3.conv2d_q8(**args)
    again = k3.conv2d_q8(**args)
    torch.cuda.synchronize()
    assert (k3.launches, k3.launches_ring) == (before + 2, ring + 2)
    assert torch.equal(out, exp), float((out - exp).abs().max())
    assert torch.equal(again, exp)
    monkeypatch.setattr(k3, "route", lambda x_q, w_q: "sync")
    sync = k3.conv2d_q8(**args)
    torch.cuda.synchronize()
    assert (k3.launches, k3.launches_ring) == (before + 3, ring + 2)
    assert torch.equal(sync, exp)


@pytest.mark.parametrize("tile", k3.RING_TILES)
@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("splits", [1, 3])
def test_q8_ring_every_instance(cuda, tile, bk, splits, monkeypatch):
    """Every (BM, BN, BK) instance the kernel is built for, split and not,
    on a shape with M, K and C tails inside the tile."""
    case = (2, 11, 9, 144, 200, 3, 1, 1)
    args = _q8_args(case, cuda, bias=True, bn=True, residual=True, relu=True)
    steps = 9 * -(-144 // bk)
    stages, smem = k3._ring_shape(*tile, bk, -(-steps // splits))
    tiles = -(-2 * 11 * 9 // tile[0]) * -(-200 // tile[1])
    plan = k3.RingPlan(bm=tile[0], bn=tile[1], bk=bk, stages=stages,
                       splits=splits, steps=steps, tiles=tiles,
                       ctas=tiles * splits, smem=smem)
    monkeypatch.setattr(k3, "ring_plan", lambda *a: plan)
    out = k3.conv2d_q8(**args)
    assert torch.equal(out, k3.conv2d_q8_plain(**args))


def test_q8_ring_refuses_what_its_route_excludes(cuda, monkeypatch):
    args = _q8_args(CASES[0], cuda)             # C 8: the sync route
    assert k3.route(args["x_q"], args["w_q"]) == "sync"
    monkeypatch.setattr(k3, "route", lambda x_q, w_q: "ring")
    before = k3.launches
    with pytest.raises(ValueError, match="C % 16"):
        k3.conv2d_q8(**args)
    args = _q8_args(Q8_RING_CASES[2], cuda)
    buf = torch.empty(args["x_q"].numel() + 1, dtype=torch.int8,
                      device=cuda)
    shifted = buf[1:].view(args["x_q"].shape)
    shifted.copy_(args["x_q"])
    with pytest.raises(ValueError, match="16-byte"):
        k3.conv2d_q8(**{**args, "x_q": shifted})
    assert k3.launches == before


def test_q8_weight_words_cached_across_calls(cuda):
    """One re-layout per weight tensor: the same words on a second call,
    fresh ones after an in-place edit (and the output follows it), and
    for another tensor of the same shape."""
    args = _q8_args(Q8_RING_CASES[0], cuda, bn=True)
    first = k3.weight_words(args["w_q"], "ring")
    k3.conv2d_q8(**args)
    assert k3.weight_words(args["w_q"], "ring") is first
    assert torch.equal(first.cpu(), args["w_q"].permute(0, 1, 3, 2).cpu())
    args["w_q"][0, 0, 0].neg_()
    edited = k3.weight_words(args["w_q"], "ring")
    assert edited is not first
    assert torch.equal(k3.conv2d_q8(**args), k3.conv2d_q8_plain(**args))
    other = args["w_q"].clone()
    assert k3.weight_words(other, "ring") is not edited
    assert torch.equal(k3.weight_words(other, "whole").cpu(),
                       k3.weight_words(args["w_q"], "whole").cpu())

# n, h, w, c, k, r, stride, pad, rb_p, k_blk, c_blk: the CPU cases of
# tests/test_torch_streams.py, a ragged c_blk, and two ResNet-50 layers
STREAM_CASES = [
    (2, 8, 8, 16, 16, 3, 1, 1, 4, 8, 8),
    (1, 9, 9, 8, 16, 3, 1, 1, 4, 8, 8),
    (2, 16, 16, 8, 8, 3, 2, 1, 3, 8, 8),
    (1, 14, 14, 16, 32, 1, 1, 0, 4, 16, 8),
    (1, 24, 24, 8, 16, 7, 2, 3, 5, 8, 8),
    (1, 8, 8, 16, 8, 1, 2, 0, 3, 8, 16),
    (2, 9, 9, 12, 20, 3, 1, 1, 4, 10, 6),
    (4, 56, 56, 64, 64, 3, 1, 1, 8, 64, 32),
    (4, 7, 7, 512, 256, 1, 1, 0, 7, 128, 128),
]
STREAM_ORDERS = ("nkpc", "npkc", "knpc", "pknc")


def _stream_args(case, dev, order="nkpc", relu=True):
    n, h, w, c, k, r, stride, pad, rb_p, k_blk, c_blk = case
    g = torch.Generator(device=dev).manual_seed(5)
    p = (h + 2 * pad - r) // stride + 1
    sched = streams.build_conv_schedule(
        n=n, k_b=k // k_blk, p_b=math.ceil(p / min(rb_p, p)), c_b=c // c_blk,
        order=order, relu=relu)
    return dict(x=torch.randn((n, h, w, c), generator=g, device=dev),
                w=torch.randn((r, r, c, k), generator=g, device=dev)
                / math.sqrt(r * r * c),
                bias=torch.randn(k, generator=g, device=dev),
                schedule=sched, stride=stride, padding=pad, rb_p=rb_p,
                k_blk=k_blk, c_blk=c_blk)


@pytest.mark.parametrize("case", STREAM_CASES)
@pytest.mark.parametrize("order", STREAM_ORDERS)
def test_streams_kernel_matches_plain(cuda, case, order):
    args = _stream_args(case, cuda, order)
    before = k4.launches
    out = k4.conv2d_streams(**args)
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    exp = k4.conv2d_streams_plain(**args)
    assert out.shape == exp.shape and out.device == exp.device
    assert _rel_err(out, exp) <= 1e-5


@pytest.mark.parametrize("case", [STREAM_CASES[0], STREAM_CASES[4],
                                  STREAM_CASES[7]])
def test_streams_kernel_follows_shuffled_runs(cuda, case):
    """Whole runs permuted in the streams: the kernel must give the same
    output, which it can only if it reads its work from the streams."""
    args = _stream_args(case, cuda, relu=False)
    base = k4.conv2d_streams(**args)
    runs = len(streams.run_starts(args["schedule"]))
    perm = torch.randperm(runs, generator=torch.Generator().manual_seed(1))
    shuf = streams.permute_runs(args["schedule"], perm.tolist())
    out = k4.conv2d_streams(**{**args, "schedule": shuf})
    torch.cuda.synchronize()
    assert torch.equal(out, base)
    assert _rel_err(out, k4.conv2d_streams_plain(**args)) <= 1e-5


@pytest.mark.parametrize("tile", range(len(k4.TILES)))
def test_streams_kernel_every_tile(cuda, tile, monkeypatch):
    """Each CTA tile of the SIMT kernel's switch, forced (with its route),
    on a case with a P tail and ragged k_blk and c_blk edges."""
    monkeypatch.setattr(k4, "route", lambda *a: "simt")
    monkeypatch.setattr(k4, "tile_config", lambda **kw: (tile, 1.0))
    for case in (STREAM_CASES[6], STREAM_CASES[7]):
        args = _stream_args(case, cuda)
        out = k4.conv2d_streams(**args)
        torch.cuda.synchronize()
        assert _rel_err(out, k4.conv2d_streams_plain(**args)) <= 1e-5


def test_streams_auto_on_the_card(cuda):
    args = _stream_args(STREAM_CASES[0], cuda)
    out = k4.conv2d_streams_auto(args["x"], args["w"], stride=1, padding=1,
                                 bias=args["bias"], relu=True,
                                 autotune="off")
    exp = ref.conv2d_fused(args["x"], args["w"], stride=1, padding=1,
                           bias=args["bias"], relu=True)
    assert _rel_err(out, exp) <= 1e-5


def test_streams_kernel_rejects_what_it_does_not_take(cuda):
    args = _stream_args(STREAM_CASES[0], cuda)
    before = k4.launches
    with pytest.raises(ValueError, match="float32"):
        k4.conv2d_streams(**{**args, "x": args["x"].double()})
    with pytest.raises(ValueError, match="contiguous"):
        k4.conv2d_streams(**{**args, "x": args["x"].transpose(1, 2)})
    with pytest.raises(ValueError, match="on cpu"):
        k4.conv2d_streams(**{**args, "w": args["w"].cpu()})
    with pytest.raises(ValueError, match="on cpu"):
        k4.conv2d_streams(**{**args, "bias": args["bias"].cpu()})
    with pytest.raises(ValueError, match="float32"):
        k4.conv2d_streams(**{**args, "bias": args["bias"].double()})
    assert k4.launches == before


# -- K7 (flash attention) and K6 (fused matmul) -----------------------------

from repro_torch.kernels import attention as k7  # noqa: E402
from repro_torch.kernels import matmul_fused as k6  # noqa: E402

# b, hq, hkv, l, dh: tails of the 64-query and 64-key blocks, L = 1, GQA
# groups of 1 to 6, every head width the kernel takes
ATTN_CASES = [
    (1, 4, 4, 1, 64), (2, 4, 2, 37, 16), (1, 6, 2, 64, 16),
    (2, 12, 2, 65, 128), (1, 15, 5, 200, 64), (3, 8, 8, 129, 128),
]


def _attn_args(case, dev, dtype):
    b, hq, hkv, l, dh = case
    g = torch.Generator(device=dev).manual_seed(l)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
    return rnd(b, hq, l, dh), rnd(b, hkv, l, dh), rnd(b, hkv, l, dh)


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, case, causal, dtype):
    q, k, v = _attn_args(case, cuda, dtype)
    before = k7.launches
    out = k7.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert k7.launches == before + 1
    exp = k7.flash_attention_plain(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == exp.shape
    if dtype == torch.float32:
        assert _rel_err(out, exp) <= 1e-5
    else:   # per query row: a late causal row's outputs are small
        assert _row_rel_err(out.float(), exp.float()) <= 1e-2


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _attn_args((1, 4, 2, 8, 64), cuda, torch.float32)
    with pytest.raises(ValueError, match="Dh"):
        k7.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                           v[..., :48].contiguous())
    wide = torch.zeros((1, 4, 8, 128), device=cuda)[..., :64]
    with pytest.raises(ValueError, match="contiguous"):
        k7.flash_attention(wide, k, v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        k7.flash_attention(q.double(), k.double(), v.double())


# the bf16 cases of ATTN_CASES that the wgmma route takes (Dh 64 and 128):
# L = 1, 65, 129, 200 (tails of the 64-query and of both key blocks), GQA
# groups of 1 to 6
ATTN_WGMMA_CASES = [c for c in ATTN_CASES if c[4] in k7.WGMMA_HEAD_DIMS]


@pytest.mark.parametrize("case", ATTN_WGMMA_CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kb", k7.KEY_BLOCKS)
def test_flash_wgmma_route_matches_plain(cuda, case, causal, kb,
                                         monkeypatch):
    """bf16 at Dh 64 and 128 takes the TMA + wgmma kernel at either key
    block: within 1e-2 of max |plain| per query row, the same bits twice."""
    monkeypatch.setattr(k7, "wgmma_key_block", lambda *_: kb)
    q, k, v = _attn_args(case, cuda, torch.bfloat16)
    assert k7.route(q, k, v) == "wgmma"
    before = (k7.launches, k7.launches_wgmma)
    out = k7.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (k7.launches, k7.launches_wgmma) == (before[0] + 1, before[1] + 1)
    exp = k7.flash_attention_plain(q, k, v, causal=causal)
    assert out.dtype == torch.bfloat16 and out.shape == exp.shape
    assert bool(torch.isfinite(out).all())
    assert _row_rel_err(out.float(), exp.float()) <= 1e-2
    assert torch.equal(out, k7.flash_attention(q, k, v, causal=causal))


def test_flash_simt_route_for_f32_and_dh16(cuda):
    """f32 at every head width (held to 1e-5) and bf16 at Dh 16 keep the
    SIMT kernel."""
    for case, dtype, tol in (((1, 4, 2, 70, 128), torch.float32, 1e-5),
                             ((1, 6, 2, 70, 64), torch.float32, 1e-5),
                             ((2, 4, 2, 37, 16), torch.bfloat16, 1e-2)):
        q, k, v = _attn_args(case, cuda, dtype)
        assert k7.route(q, k, v) == "simt"
        before = (k7.launches, k7.launches_wgmma)
        out = k7.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert (k7.launches, k7.launches_wgmma) == (before[0] + 1, before[1])
        exp = k7.flash_attention_plain(q, k, v, causal=True)
        assert _row_rel_err(out.float(), exp.float()) <= tol


# m, k, n: both tiles, ragged M/N/K (no vector path), K = 1
MM_CASES = [(64, 96, 32), (300, 129, 257), (1024, 512, 768), (7, 1, 5),
            (4096, 64, 256)]


@pytest.mark.parametrize("case", MM_CASES)
@pytest.mark.parametrize("act", ["none", "relu", "gelu", "silu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_matches_plain(cuda, case, act, dtype):
    m, kk, n = case
    g = torch.Generator(device=cuda).manual_seed(m + n)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)  # noqa: E731
    a, b, bias, res = rnd(m, kk), rnd(kk, n) / kk ** 0.5, rnd(n), rnd(m, n)
    for kw in (dict(), dict(bias=bias), dict(bias=bias, residual=res)):
        before = k6.launches
        out = k6.matmul_fused(a, b, act=act, **kw)
        torch.cuda.synchronize()
        assert k6.launches == before + 1
        exp = k6.matmul_fused_plain(a, b, act=act, **kw)
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        assert out.dtype == dtype
        assert _rel_err(out.float(), exp.float()) <= tol, kw.keys()


def test_matmul_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.zeros(8, 4, device=cuda)
    b = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        k6.matmul_fused(a, b.t().contiguous().t())
    with pytest.raises(ValueError, match="is torch.bfloat16"):
        k6.matmul_fused(a, b.bfloat16())


# m, k, n of the wgmma route: M of 1, 63 and 4097 rows, N and K tails of
# its 128 x 128 x 64 tiles in multiples of 8
WGMMA_CASES = [(1, 72, 136), (63, 200, 520), (4097, 1528, 1000)]
EPILOGUE_OPERANDS = [(False, False), (True, False), (False, True),
                     (True, True)]


@pytest.mark.parametrize("case", WGMMA_CASES)
@pytest.mark.parametrize("act", ["none", "relu", "gelu", "silu"])
def test_matmul_wgmma_route_matches_plain(cuda, case, act):
    m, kk, n = case
    g = torch.Generator(device=cuda).manual_seed(m + kk + n)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).bfloat16()  # noqa: E731
    a, b, bias, res = rnd(m, kk), rnd(kk, n) / kk ** 0.5, rnd(n), rnd(m, n)
    assert k6.route(a, b) == "wgmma"
    for with_bias, with_res in EPILOGUE_OPERANDS:
        kw = dict(bias=bias if with_bias else None,
                  residual=res if with_res else None)
        before = (k6.launches, k6.launches_wgmma)
        out = k6.matmul_fused(a, b, act=act, **kw)
        torch.cuda.synchronize()
        assert (k6.launches, k6.launches_wgmma) == (before[0] + 1,
                                                    before[1] + 1)
        exp = k6.matmul_fused_plain(a, b, act=act, **kw)
        assert out.dtype == torch.bfloat16 and out.shape == (m, n)
        assert _rel_err(out.float(), exp.float()) <= 1e-2, (with_bias,
                                                            with_res)


def test_matmul_wgmma_route_takes_unaligned_bias_and_residual(cuda):
    """bias and residual 2 bytes off 4-byte alignment: the epilogue reads
    them an element at a time."""
    m, kk, n = 130, 64, 136
    g = torch.Generator(device=cuda).manual_seed(5)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).bfloat16()  # noqa: E731
    a, b = rnd(m, kk), rnd(kk, n) / 8
    bias = rnd(n + 1)[1:]
    res = rnd(m * n + 1)[1:].view(m, n)
    out = k6.matmul_fused(a, b, bias=bias, residual=res, act="silu")
    exp = k6.matmul_fused_plain(a, b, bias=bias, residual=res, act="silu")
    assert k6.route(a, b) == "wgmma"
    assert _rel_err(out.float(), exp.float()) <= 1e-2


def test_matmul_simt_route_for_f32_and_bf16_off_the_rule(cuda):
    """f32 (held to 1e-5), and bf16 whose K or N is off the multiples of 8
    or whose a lies off 16-byte alignment, take the SIMT kernel."""
    g = torch.Generator(device=cuda).manual_seed(6)
    offset = torch.randn(64 * 96 + 1, generator=g, device=cuda).bfloat16()
    for a, b, tol in (
            (torch.randn(64, 96, generator=g, device=cuda),
             torch.randn(96, 40, generator=g, device=cuda) / 10, 1e-5),
            (torch.randn(64, 90, generator=g, device=cuda).bfloat16(),
             torch.randn(90, 40, generator=g, device=cuda).bfloat16(), 1e-2),
            (torch.randn(64, 96, generator=g, device=cuda).bfloat16(),
             torch.randn(96, 36, generator=g, device=cuda).bfloat16(), 1e-2),
            (offset[1:].view(64, 96),
             torch.randn(96, 40, generator=g, device=cuda).bfloat16(), 1e-2)):
        assert k6.route(a, b) == "simt"
        before = (k6.launches, k6.launches_wgmma)
        out = k6.matmul_fused(a, b, act="gelu")
        torch.cuda.synchronize()
        assert (k6.launches, k6.launches_wgmma) == (before[0] + 1, before[1])
        exp = k6.matmul_fused_plain(a, b, act="gelu")
        assert _rel_err(out.float(), exp.float()) <= tol


def test_lm_smoke_forward_and_serving_match_the_cpu(cuda):
    """A 2-layer smoke qwen2 (Dh 16): the card's prefill logits (through
    K7) within 1e-4 of the CPU's, and the same greedy tokens."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.convert import params_to
    from repro_torch.launch import serve
    from repro_torch.nn import transformer as T
    cfg = dataclasses.replace(smoke_config(get_config("qwen2-1.5b")),
                              n_layers=2)
    cpu = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    dev = params_to(cpu, cuda)
    toks = torch.randint(0, cfg.vocab, (2, 70),
                         generator=torch.Generator().manual_seed(1))
    before = k7.launches
    lg, _ = T.forward(dev, cfg, tokens=toks.to(cuda))
    assert k7.launches == before + cfg.n_layers
    lc, _ = T.forward(cpu, cfg, tokens=toks)
    assert _rel_err(lg.cpu(), lc) <= 1e-4
    prompts = [toks[0, :9].numpy(), toks[1, :4].numpy(), toks[0, 3:8].numpy()]
    assert serve.serve_continuous(dev, cfg, prompts, lanes=2, max_len=32,
                                  max_new=5) == \
        serve.serve_continuous(cpu, cfg, prompts, lanes=2, max_len=32,
                               max_new=5)


# -- K8 (depthwise causal conv1d) and the hybrid LM -------------------------

from repro_torch.kernels import conv1d_causal as k8  # noqa: E402

# b, l, d, kw: the served widths (L 1, a ragged run), D tails that are and
# are not multiples of the 16-byte vector (1000, 1003), every tap count up to
# 8, and runs that cross each other's halos
CONV1D_CASES = [
    (1, 1, 16384, 4), (1, 333, 16384, 4), (2, 77, 1000, 4), (2, 77, 1003, 4),
    (3, 5, 24, 2), (1, 64, 8, 8), (2, 17, 256, 1), (1, 200, 4096, 3),
    (4, 130, 136, 5), (1, 9, 40, 7), (2, 70, 48, 6),
]


def _conv1d_args(case, dev, dtype):
    b, l, d, kw = case
    g = torch.Generator(device=dev).manual_seed(l * d + kw)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)
    return (rnd(b, l, d).to(dtype), (rnd(kw, d) * kw ** -0.5).to(dtype),
            rnd(d).to(dtype))


@pytest.mark.parametrize("case", CONV1D_CASES)
@pytest.mark.parametrize("act", ["silu", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv1d_kernel_matches_plain(cuda, case, act, dtype):
    x, w, bias = _conv1d_args(case, cuda, dtype)
    for kw in (dict(bias=bias), dict()):
        before = k8.launches
        out = k8.conv1d_causal(x, w, act=act, **kw)
        torch.cuda.synchronize()
        assert k8.launches == before + 1
        exp = k8.conv1d_causal_plain(x, w, act=act, **kw)
        assert out.dtype == dtype and out.shape == exp.shape
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        assert _rel_err(out.float(), exp.float()) <= tol, kw.keys()


@pytest.mark.parametrize("d", [2048, 1003])
def test_conv1d_kernel_on_strided_rows(cuda, d):
    """The Mamba mixer's input: one half of a projection, rows 2 D apart
    (16-byte aligned for D 2048, not for D 1003), read in place."""
    xz = torch.randn((2, 45, 2 * d), device=cuda).bfloat16()
    x = xz.chunk(2, dim=-1)[1]
    assert not x.is_contiguous()
    w = torch.randn((4, d), device=cuda).bfloat16()
    bias = torch.randn((d,), device=cuda).bfloat16()
    out = k8.conv1d_causal(x, w, bias=bias)
    exp = k8.conv1d_causal_plain(x.contiguous(), w, bias=bias)
    assert _rel_err(out.float(), exp.float()) <= 1e-2


def test_conv1d_kernel_rejects_what_it_does_not_take(cuda):
    x, w, bias = _conv1d_args((1, 8, 16, 4), cuda, torch.float32)
    before = k8.launches
    with pytest.raises(ValueError, match="taps"):
        k8.conv1d_causal(x, torch.zeros((9, 16), device=cuda))
    with pytest.raises(ValueError, match="is torch.bfloat16"):
        k8.conv1d_causal(x, w.bfloat16())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        k8.conv1d_causal(x.half(), w.half())
    strided = x.transpose(1, 2).contiguous().transpose(1, 2)
    assert strided.stride(2) != 1
    with pytest.raises(ValueError, match="channels"):
        k8.conv1d_causal(strided, w)
    assert k8.launches == before



# K8's tile route: the served widths, every tap count, rows in place
CONV1D_TILE_CASES = [
    (1, 1, 16384, 4), (1, 333, 16384, 4), (1, 1024, 16384, 4),
    (8, 512, 2048, 4), (2, 77, 1000, 4), (1, 64, 8, 8), (2, 17, 256, 1),
    (4, 130, 136, 5), (2, 70, 48, 6), (1, 200, 4096, 3),
]


@pytest.mark.parametrize("case", CONV1D_TILE_CASES)
@pytest.mark.parametrize("act", ["silu", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv1d_both_routes_match_plain(cuda, case, act, dtype,
                                        monkeypatch):
    """The tile route where the rows allow it, and the thread route forced
    on the same inputs, both within the limits of max |plain|."""
    x, w, bias = _conv1d_args(case, cuda, dtype)
    if dtype == torch.float32 or case[2] % 8 == 0:
        assert k8.route(x, w, bias) == "tile"
    exp = k8.conv1d_causal_plain(x, w, bias=bias, act=act)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    before, tile = k8.launches, k8.launches_tile
    out = k8.conv1d_causal(x, w, bias=bias, act=act)
    torch.cuda.synchronize()
    assert (k8.launches, k8.launches_tile) == (before + 1, tile + 1)
    assert _rel_err(out.float(), exp.float()) <= tol
    monkeypatch.setattr(k8, "route", lambda *a: "thread")
    thread = k8.conv1d_causal(x, w, bias=bias, act=act)
    torch.cuda.synchronize()
    assert (k8.launches, k8.launches_tile) == (before + 2, tile + 1)
    assert _rel_err(thread.float(), exp.float()) <= tol


def test_conv1d_tile_route_on_rows_in_place(cuda):
    """The mixer's input, half of a (B, L, 2 D) projection: the tile route
    reads its rows 2 D apart in place."""
    d = 4096
    xz = torch.randn((2, 300, 2 * d), device=cuda).bfloat16()
    x = xz.chunk(2, dim=-1)[0]
    w = torch.randn((4, d), device=cuda).bfloat16()
    bias = torch.randn((d,), device=cuda).bfloat16()
    assert k8.route(x, w, bias) == "tile"
    out = k8.conv1d_causal(x, w, bias=bias)
    exp = k8.conv1d_causal_plain(x.contiguous(), w, bias=bias)
    assert _rel_err(out.float(), exp.float()) <= 1e-2


def test_conv1d_tile_route_refuses_what_it_excludes(cuda, monkeypatch):
    x, w, bias = _conv1d_args((2, 77, 1003, 4), cuda, torch.bfloat16)
    assert k8.route(x, w, bias) == "thread"
    monkeypatch.setattr(k8, "route", lambda *a: "tile")
    with pytest.raises(RuntimeError, match="tile route"):
        k8.conv1d_causal(x, w, bias=bias)

def test_hybrid_smoke_forward_and_serving_match_the_cpu(cuda):
    """The smoke Jamba period (7 Mamba + 1 attention, MoE on odd layers):
    the card's prefill logits (through K8 and K7) within 1e-4 of the CPU's,
    7 K8 and 1 K7 launches per forward, none in decode, and the same greedy
    tokens from ``serve_continuous``."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.convert import params_to
    from repro_torch.launch import serve
    from repro_torch.nn import transformer as T
    cfg = smoke_config(get_config("jamba-1.5-large-398b-1chip"))
    cpu = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    dev = params_to(cpu, cuda)
    toks = torch.randint(0, cfg.vocab, (2, 70),
                         generator=torch.Generator().manual_seed(1))
    k7_before, k8_before = k7.launches, k8.launches
    lg, aux = T.forward(dev, cfg, tokens=toks.to(cuda))
    assert (k7.launches - k7_before, k8.launches - k8_before) == (1, 7)
    lc, aux_c = T.forward(cpu, cfg, tokens=toks)
    assert _rel_err(lg.cpu(), lc) <= 1e-4
    assert abs(float(aux) - float(aux_c)) <= 1e-4 * abs(float(aux_c))
    cache = T.init_cache(cfg, 2, 4, device=cuda)
    k8_before = k8.launches
    T.decode_step(dev, cfg, toks[:, :1].to(cuda), cache, 0)
    assert k8.launches == k8_before
    prompts = [toks[0, :9].numpy(), toks[1, :4].numpy(), toks[0, 3:8].numpy()]
    assert serve.serve_continuous(dev, cfg, prompts, lanes=2, max_len=32,
                                  max_new=5) == \
        serve.serve_continuous(cpu, cfg, prompts, lanes=2, max_len=32,
                               max_new=5)


# -- K9 (grouped MoE matmul) ------------------------------------------------

from repro_torch.kernels import moe_gmm as k9  # noqa: E402

# t, d, f, e, bm: the decode layout (tiles of 16, few rows each), the
# moe_streams bench's shapes, a prefill tile of 128, bm 32 (two blocks of 16
# per tile), tails of T, D and F that are multiples of no block (and of no
# 16-byte vector)
K9_CASES = [(144, 256, 512, 8, 16), (512, 128, 256, 8, 64),
            (640, 256, 384, 4, 128), (100, 64, 72, 2, 32),
            (77, 1003, 517, 3, 16), (70, 40, 20, 5, 64)]


def _k9_args(case, dev, dtype):
    t, d, f, e, bm = case
    g = torch.Generator(device=dev).manual_seed(t * d + f)
    tiles = -(-t // bm)
    tile_eid = torch.randint(-1, e, (tiles,), generator=g, device=dev,
                             dtype=torch.int32)
    tile_eid[0], tile_eid[-1] = e - 1, -1 if tiles > 2 else 0
    tokens = torch.randn((t, d), generator=g, device=dev).to(dtype)
    weights = (torch.randn((e, d, f), generator=g, device=dev)
               * d ** -0.5).to(dtype)
    return tokens, weights, tile_eid


@pytest.mark.parametrize("case", K9_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_kernel_matches_plain(cuda, case, dtype):
    """Every tile's rows against its expert's product; -1 tiles zero."""
    tokens, weights, tile_eid = _k9_args(case, cuda, dtype)
    bm = case[-1]
    before = k9.launches
    out = k9.moe_gmm(tokens, weights, tile_eid, bm=bm)
    torch.cuda.synchronize()
    assert k9.launches == before + 1
    exp = k9.moe_gmm_plain(tokens, weights, tile_eid, bm=bm)
    assert out.dtype == dtype and out.shape == exp.shape
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert _rel_err(out.float(), exp.float()) <= tol
    for i, eid in enumerate(tile_eid.tolist()):
        if eid < 0:
            assert not out[i * bm:(i + 1) * bm].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_kernel_gives_the_same_bits_twice(cuda, dtype):
    tokens, weights, tile_eid = _k9_args(K9_CASES[2], cuda, dtype)
    first = k9.moe_gmm(tokens, weights, tile_eid, bm=128)
    assert torch.equal(first, k9.moe_gmm(tokens, weights, tile_eid, bm=128))


def test_moe_gmm_kernel_rejects_what_it_does_not_take(cuda):
    tokens, weights, tile_eid = _k9_args((64, 32, 48, 4, 16), cuda,
                                         torch.float32)
    before = k9.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        k9.moe_gmm(tokens, weights, torch.zeros((8,), dtype=torch.int32,
                                                device=cuda), bm=8)
    with pytest.raises(ValueError, match="weights are torch.bfloat16"):
        k9.moe_gmm(tokens, weights.bfloat16(), tile_eid, bm=16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        k9.moe_gmm(tokens.half(), weights.half(), tile_eid, bm=16)
    with pytest.raises(ValueError, match="tile_eid on cpu"):
        k9.moe_gmm(tokens, weights, tile_eid.cpu(), bm=16)
    with pytest.raises(ValueError, match="contiguous"):
        k9.moe_gmm(tokens, weights.transpose(1, 2).contiguous()
                   .transpose(1, 2), tile_eid, bm=16)
    assert k9.launches == before


# t, d, f, e, bm of the wgmma route: both block shapes (bm 128: 128 x 128;
# bm 64: 64 x 256), ragged T, a D tail inside a 64-deep stage (72) and F
# tails (136, 264) in multiples of 8
K9_WGMMA_CASES = [(640, 256, 384, 4, 128), (300, 128, 264, 3, 64),
                  (1000, 512, 1024, 8, 128), (200, 72, 136, 5, 64)]


def _k9_wgmma_args(case, dev):
    """bf16 inputs whose id stream holds the last expert E-1 first, -1
    tiles in the middle and at the end, and random ids between."""
    tokens, weights, tile_eid = _k9_args(case, dev, torch.bfloat16)
    e, tiles = case[3], tile_eid.shape[0]
    tile_eid[0], tile_eid[tiles // 2], tile_eid[-1] = e - 1, -1, -1
    return tokens, weights, tile_eid


@pytest.mark.parametrize("case", K9_WGMMA_CASES)
def test_moe_gmm_wgmma_route_matches_plain(cuda, case):
    """The prefill route: every tile's rows against its expert's product
    within 1e-2, -1 tiles zero, the same bits twice."""
    tokens, weights, tile_eid = _k9_wgmma_args(case, cuda)
    bm = case[-1]
    assert k9.route(tokens, weights, bm) == "wgmma"
    before = (k9.launches, k9.launches_wgmma)
    out = k9.moe_gmm(tokens, weights, tile_eid, bm=bm)
    torch.cuda.synchronize()
    assert (k9.launches, k9.launches_wgmma) == (before[0] + 1, before[1] + 1)
    exp = k9.moe_gmm_plain(tokens, weights, tile_eid, bm=bm)
    assert out.dtype == torch.bfloat16 and out.shape == exp.shape
    assert _rel_err(out.float(), exp.float()) <= 1e-2
    for i, eid in enumerate(tile_eid.tolist()):
        if eid < 0:
            assert not out[i * bm:(i + 1) * bm].any()
    assert torch.equal(out, k9.moe_gmm(tokens, weights, tile_eid, bm=bm))


def test_moe_gmm_mma_route_for_decode_f32_and_ragged(cuda):
    """bm 16 (decode) and bm 64 with a D off the multiples of 8, and f32,
    keep the mma.sync / SIMT kernel, at their present limits."""
    for case, dtype, tol in (((144, 250, 512, 8, 16), torch.bfloat16, 1e-2),
                             ((640, 256, 384, 4, 128), torch.float32, 1e-5),
                             ((300, 1003, 520, 3, 64), torch.bfloat16, 1e-2)):
        tokens, weights, tile_eid = _k9_args(case, cuda, dtype)
        bm = case[-1]
        assert k9.route(tokens, weights, bm) == "mma"
        before = (k9.launches, k9.launches_wgmma)
        out = k9.moe_gmm(tokens, weights, tile_eid, bm=bm)
        torch.cuda.synchronize()
        assert (k9.launches, k9.launches_wgmma) == (before[0] + 1, before[1])
        exp = k9.moe_gmm_plain(tokens, weights, tile_eid, bm=bm)
        assert _rel_err(out.float(), exp.float()) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l", [(8, 1), (2, 600)])
def test_moe_layer_on_the_card_matches_the_cpu(cuda, dtype, b, l):
    """The smoke MoE layer (4 experts, top-2; a share of 2) on the card:
    3 K9 launches (through the wgmma route in the bf16 prefill), no host
    synchronisation, the same bits twice, and the CPU's output (f32 within
    1e-5, bf16 within 2e-2 of max |out|)."""
    import dataclasses
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.convert import params_to
    from repro_torch.nn import moe
    cfg = smoke_config(get_config("jamba-1.5-large-398b"))
    cfg = dataclasses.replace(cfg, dtype=dtype, moe=dataclasses.replace(
        cfg.moe, expert_share=(1, 2)))
    tdt = getattr(torch, dtype)
    cpu = moe.init(torch.Generator().manual_seed(0), cfg, tdt, "cpu")
    dev = params_to(cpu, cuda)
    x = torch.randn((b, l, cfg.d_model),
                    generator=torch.Generator().manual_seed(l)).to(tdt)
    x_dev = x.to(cuda)
    before = (k9.launches, k9.launches_wgmma)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, _ = moe.apply(dev, cfg, x_dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    wgmma = 3 if dtype == "bfloat16" and l > 1 else 0
    assert (k9.launches, k9.launches_wgmma) == (before[0] + 3,
                                                before[1] + wgmma)
    assert torch.equal(out, moe.apply(dev, cfg, x_dev)[0])   # same bits
    exp, _ = moe.apply(cpu, cfg, x)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert _rel_err(out.float().cpu(), exp.float()) <= tol


# -- the whole-plane kernels (K10a, K10b, K10c) and the max-pool K5 ---------

from repro_torch import backend as be  # noqa: E402
from repro_torch.core import conv as core_conv  # noqa: E402
from repro_torch.kernels import pool2d as k5  # noqa: E402

# the lane-aligned CASES, each with the reference's blocking
WHOLE_CASES = [c for c in CASES if c[3] % 8 == 0 and c[4] % 8 == 0]


def _whole_blk(case, kind="fwd"):
    n, h, w, c, k, r, stride, pad = case
    blk = core_conv.whole_blocking((n, h, w, c), (r, r, c, k), stride=stride,
                                   padding=pad, kind=kind)
    return dict(rb_p=blk.rb_p, k_blk=blk.k_blk)


# blockings beside the reference's: a P tail, rb_p = P at 56x56 (several
# passes per block), k_blk below K, one row per block
WHOLE_BLOCKINGS = [
    (CASES[0], dict(rb_p=4, k_blk=8)),
    (CASES[7], dict(rb_p=56, k_blk=64)),
    (CASES[7], dict(rb_p=5, k_blk=32)),
    (CASES[6], dict(rb_p=7, k_blk=128)),
    (CASES[2], dict(rb_p=1, k_blk=8)),
]


@pytest.mark.parametrize("case", WHOLE_CASES)
@pytest.mark.parametrize("epi", range(len(EPILOGUES)))
def test_whole_kernel_matches_plain(cuda, case, epi):
    args = _args(case, cuda, **EPILOGUES[epi])
    blk = _whole_blk(case)
    before, tiled = k1.launches_whole, k1.launches
    out = k1.conv2d_direct_whole(**args, **blk)
    torch.cuda.synchronize()
    assert (k1.launches_whole, k1.launches) == (before + 1, tiled)
    exp = k1.conv2d_direct_whole_plain(**args, **blk)
    assert out.shape == exp.shape and out.device == exp.device
    assert _rel_err(out, exp) <= 1e-5
    assert _rel_err(out, k1.conv2d_direct(**args)) <= 1e-5


@pytest.mark.parametrize("case,blk", WHOLE_BLOCKINGS)
def test_whole_kernel_other_blockings(cuda, case, blk):
    args = _args(case, cuda, bn=True, residual=True, relu=True)
    out = k1.conv2d_direct_whole(**args, **blk)
    assert _rel_err(out, k1.conv2d_direct_whole_plain(**args, **blk)) <= 1e-5


def test_whole_kernel_rejects_what_it_does_not_take(cuda):
    args = _args(CASES[0], cuda)
    with pytest.raises(ValueError, match="float32"):
        k1.conv2d_direct_whole(**{**args, "x": args["x"].double()},
                               rb_p=4, k_blk=8)
    with pytest.raises(ValueError, match="8 input"):
        k1.conv2d_direct_whole(**_args(CASES[5], cuda), rb_p=4, k_blk=7)
    with pytest.raises(ValueError, match="k_blk"):
        k1.conv2d_direct_whole(**args, rb_p=4, k_blk=12)


@pytest.mark.parametrize("case", WHOLE_CASES)
@pytest.mark.parametrize("epi", [0, 2, 3])
def test_whole_q8_kernel_equals_plain_and_k3(cuda, case, epi):
    """K10c = its plain version = K3, bit for bit, at the reference's int8
    blocking (rb_p grows to the budget: several passes per block)."""
    args = _q8_args(case, cuda, **EPILOGUES[epi])
    blk = _whole_blk(case, "q8")
    before, tiled = k3.launches_whole, k3.launches
    out = k3.conv2d_q8_whole(**args, **blk)
    torch.cuda.synchronize()
    assert (k3.launches_whole, k3.launches) == (before + 1, tiled)
    assert torch.equal(out, k3.conv2d_q8_whole_plain(**args, **blk))
    assert torch.equal(out, k3.conv2d_q8(**args))


@pytest.mark.parametrize("case,blk", WHOLE_BLOCKINGS)
def test_whole_q8_kernel_other_blockings(cuda, case, blk):
    args = _q8_args(case, cuda, bias=True, residual=True, relu=True)
    assert torch.equal(k3.conv2d_q8_whole(**args, **blk),
                       k3.conv2d_q8_plain(**args))


# the lane-aligned WU_CASES whose P the reference's b_p divides
WU_WHOLE_CASES = [c for c in WU_CASES if c[3] % 8 == 0 and c[4] % 8 == 0]


@pytest.mark.parametrize("case", WU_WHOLE_CASES)
def test_wu_whole_kernel_matches_plain(cuda, case):
    args = _wu_args(case, cuda)
    n, h, w, c, k, r, stride, pad = case
    blk = core_conv.whole_blocking((n, h, w, c), (r, r, c, k), stride=stride,
                                   padding=pad, kind="wu")
    kw = dict(b_p=blk.rb_p, k_blk=blk.k_blk)
    before, tiled = k2.launches_whole, k2.launches
    out = k2.conv2d_wu_whole(**args, **kw)
    torch.cuda.synchronize()
    assert (k2.launches_whole, k2.launches) == (before + 1, tiled)
    exp = k2.conv2d_wu_whole_plain(**args, **kw)
    assert out.shape == exp.shape
    assert _rel_err(out, exp) <= 1e-5
    assert _rel_err(out, k2.conv2d_wu_plain(**args)) <= 1e-5
    assert torch.equal(out, k2.conv2d_wu_whole(**args, **kw))  # same bits


def test_wu_whole_kernel_every_tile_and_raises(cuda):
    for c, k, k_blk in ((128, 128, 128), (128, 64, 64), (64, 128, 128),
                        (64, 64, 64), (136, 72, 24)):
        args = _wu_args((2, 9, 9, c, k, 3, 1, 1), cuda)
        out = k2.conv2d_wu_whole(**args, b_p=3, k_blk=k_blk)
        assert _rel_err(out, k2.conv2d_wu_plain(**args)) <= 1e-5, (c, k)
    with pytest.raises(ValueError, match="does not divide P"):
        k2.conv2d_wu_whole(**args, b_p=4, k_blk=24)


# ResNet-50's weight-update signatures at 56x56 (h, w, c, k, r, stride,
# pad) at batch 32, the layers that had 1-9 blocks before the split
WU_WHOLE_56 = [(56, 56, 64, 64, 1, 1, 0), (56, 56, 64, 64, 3, 1, 1),
               (56, 56, 64, 256, 1, 1, 0), (56, 56, 256, 64, 1, 1, 0),
               (56, 56, 256, 128, 1, 1, 0), (56, 56, 128, 128, 3, 2, 1),
               (56, 56, 256, 512, 1, 2, 0)]


@pytest.mark.parametrize("sig", WU_WHOLE_56)
def test_wu_whole_kernel_at_the_56x56_signatures(cuda, sig):
    h, w, c, k, r, stride, pad = sig
    args = _wu_args((32, h, w, c, k, r, stride, pad), cuda)
    blk = core_conv.whole_blocking((32, h, w, c), (r, r, c, k), stride=stride,
                                   padding=pad, kind="wu")
    kw = dict(b_p=blk.rb_p, k_blk=blk.k_blk)
    p = (h + 2 * pad - r) // stride + 1
    assert k2.plan_whole(n=32, p=p, q=p, c=c, k=k, r=r, s=r,
                         **kw).blocks >= 132
    before = k2.launches_whole
    out = k2.conv2d_wu_whole(**args, **kw)
    again = k2.conv2d_wu_whole(**args, **kw)
    torch.cuda.synchronize()
    assert k2.launches_whole == before + 2
    assert torch.equal(out, again)                      # same bits
    assert _rel_err(out, k2.conv2d_wu_whole_plain(**args, **kw)) <= 1e-5


# n, h, c, k, r, b_p, k_blk: every tile of WHOLE_TILES, once with one run
# (splits == 1: no sum pass) and once with many; and a C and K off the
# multiples of 4 (4-byte copies)
WU_WHOLE_TILES = [(1, 9, 128, 128, 3, 9, 128), (16, 9, 128, 128, 1, 3, 128),
                  (1, 9, 128, 64, 3, 9, 64), (16, 9, 136, 72, 1, 3, 24),
                  (1, 9, 64, 128, 3, 9, 128), (16, 9, 64, 128, 1, 3, 128),
                  (1, 9, 64, 64, 3, 9, 64), (16, 9, 64, 64, 1, 9, 32),
                  (3, 11, 5, 7, 3, 11, 7)]


@pytest.mark.parametrize("case", WU_WHOLE_TILES)
def test_wu_whole_kernel_every_tile_split_and_not(cuda, case):
    n, h, c, k, r, b_p, k_blk = case
    args = _wu_args((n, h, h, c, k, r, 1, r // 2), cuda)
    p = h + 2 * (r // 2) - r + 1
    plan = k2.plan_whole(n=n, p=p, q=p, c=c, k=k, r=r, s=r, b_p=b_p,
                         k_blk=k_blk)
    out = k2.conv2d_wu_whole(**args, b_p=b_p, k_blk=k_blk)
    torch.cuda.synchronize()
    exp = k2.conv2d_wu_whole_plain(**args, b_p=b_p, k_blk=k_blk)
    assert _rel_err(out, exp) <= 1e-5, plan
    assert torch.equal(out, k2.conv2d_wu_whole(**args, b_p=b_p, k_blk=k_blk))


def test_wu_whole_tile_cases_meet_one_run_and_many():
    splits = []
    for n, h, c, k, r, b_p, k_blk in WU_WHOLE_TILES:
        p = h + 2 * (r // 2) - r + 1
        splits.append(k2.plan_whole(n=n, p=p, q=p, c=c, k=k, r=r, s=r,
                                    b_p=b_p, k_blk=k_blk).splits)
    assert 1 in splits and max(splits) > 1, splits


@pytest.mark.parametrize("shape", [(16, 112, 112, 64), (2, 12, 12, 8),
                                   (2, 9, 7, 5), (3, 8, 8, 12)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("window,stride,pad", [(3, 2, 1), (2, 2, 0),
                                               (3, 1, 1)])
def test_maxpool_kernel_equals_plain_and_max_pool2d(cuda, shape, dtype,
                                                    window, stride, pad):
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    before = k5.launches
    out = k5.maxpool2d(x, window=window, stride=stride, padding=pad)
    torch.cuda.synchronize()
    assert k5.launches == before + 1 and out.dtype == dtype
    assert torch.equal(out, k5.maxpool2d_plain(x, window=window,
                                               stride=stride, padding=pad))
    lib = torch.nn.functional.max_pool2d(x.permute(0, 3, 1, 2), window,
                                         stride, pad).permute(0, 2, 3, 1)
    assert torch.equal(out, lib)


def test_maxpool_kernel_nan_and_rejects(cuda):
    x = torch.randn((2, 8, 8, 8), device=cuda)
    x[0, 3, 3, 2] = float("nan")
    assert torch.equal(torch.isnan(k5.maxpool2d(x)),
                       torch.isnan(k5.maxpool2d_plain(x)))
    with pytest.raises(ValueError, match="contiguous"):
        k5.maxpool2d(x.transpose(1, 2))
    with pytest.raises(ValueError, match="float32"):
        k5.maxpool2d(x.double())


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_whole_plane_smoke_resnet_on_the_card(cuda, quantized):
    """Reduced ResNet-50 under ``whole`` on the card: only K10a (or K10c)
    launch, 16 per forward, K1 and K3 none; f32 within 1e-4 of the CPU,
    int8 equal bit for bit to the tiled int8 forward on the card."""
    from repro_torch.convert import params_to
    from repro_torch.core.quantize import (calibrate_network,
                                           quantize_gxm_params)
    from repro_torch.graph import GxM, resnet50
    net = lambda dev: GxM(resnet50(10, stages=(1, 1, 1, 1)), device=dev,  # noqa: E731
                          num_classes=10, quantized=quantized)
    cpu = net("cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    if quantized:
        scales = calibrate_network(cpu, params, [x])
        params = quantize_gxm_params(cpu.etg, params, scales)
    card = net(cuda)
    on_card = params_to(params, cuda)
    counts = lambda: (k1.launches, k1.launches_whole, k3.launches,  # noqa: E731
                      k3.launches_whole)
    before = counts()
    with be.use_conv_tiling("whole"):
        out = card.infer(on_card, x.to(cuda))
        torch.cuda.synchronize()
    delta = [a - b for a, b in zip(counts(), before)]
    assert delta == ([0, 0, 0, 16] if quantized else [0, 16, 0, 0])
    if quantized:
        assert torch.equal(out, card.infer(on_card, x.to(cuda)))
    else:
        with be.use_conv_tiling("whole"):
            exp = cpu.infer(params, x)
        assert _rel_err(out.cpu(), exp) <= 1e-4


# -- K2's mma route (3xTF32) and K9's stream route ---------------------------

def _wu_signatures(batch):
    """ResNet-50's 22 lane-aligned weight-update signatures at ``batch`` as
    WU_CASES tuples (n, h, w, c, k, r, stride, pad)."""
    from repro_torch.core.conv import lane_ok
    from repro_torch.graph import build_etg, resnet50
    from repro_torch.graph.serving import conv_shapes
    out = []
    for sh in conv_shapes(build_etg(resnet50()), (224, 224)):
        case = (batch, sh["h"], sh["w"], sh["c"], sh["k"], sh["r"],
                sh["stride"], sh["padding"])
        if lane_ok(sh["c"], sh["k"]) and case not in out:
            out.append(case)
    return out


# ragged pixel counts: N*P*Q not a multiple of the 32-pixel stage, chunks
# that end inside a stage, one pixel
WU_MMA_RAGGED = [(1, 5, 7, 8, 12, 1, 1, 0), (3, 11, 13, 12, 20, 3, 2, 1),
                 (1, 1, 1, 4, 4, 1, 1, 0), (5, 17, 19, 36, 44, 3, 1, 1),
                 (7, 23, 23, 64, 64, 1, 1, 0)]


@pytest.mark.parametrize("case", WU_MMA_RAGGED + _wu_signatures(2))
def test_wu_mma_route_matches_plain(cuda, case):
    """The mma route at ragged pixel counts and at the 22 training
    signatures' shapes at batch 2: within 1e-5 of max |plain|, the same
    bits twice, one launch counted on both counters."""
    args = _wu_args(case, cuda)
    assert k2.route(args["x"], args["do"]) == "mma"
    before = (k2.launches, k2.launches_mma)
    out = k2.conv2d_wu(**args)
    torch.cuda.synchronize()
    assert (k2.launches, k2.launches_mma) == (before[0] + 1, before[1] + 1)
    exp = k2.conv2d_wu_plain(**args)
    assert _rel_err(out, exp) <= 1e-5
    assert torch.equal(out, k2.conv2d_wu(**args))


def test_wu_simt_route_keeps_ragged_channels(cuda):
    args = _wu_args((3, 11, 13, 5, 7, 3, 2, 1), cuda)
    assert k2.route(args["x"], args["do"]) == "simt"
    before = (k2.launches, k2.launches_mma)
    out = k2.conv2d_wu(**args)
    torch.cuda.synchronize()
    assert (k2.launches, k2.launches_mma) == (before[0] + 1, before[1])
    assert _rel_err(out, k2.conv2d_wu_plain(**args)) <= 1e-5
    assert torch.equal(out, k2.conv2d_wu(**args))


def test_wu_mma_kernel_refuses_what_its_route_excludes(cuda):
    """The mma route's C function returns an error for C or K off the
    multiples of 4, an unaligned operand and a chunk off the stage: the
    wrapper would raise on it, and never gives way to the SIMT kernel."""
    args = _wu_args((3, 11, 13, 5, 7, 3, 2, 1), cuda)
    x, do = args["x"], args["do"]
    dw = torch.empty((3, 3, 5, 7), device=cuda)
    fn = k2._kernel_fn_mma()
    stream = torch.cuda.current_stream().cuda_stream
    assert fn(x.data_ptr(), do.data_ptr(), dw.data_ptr(), dw.data_ptr(),
              3, 11, 13, 5, 7, 3, 3, 2, 1, 3, 1, 2048, stream) != 0
    x8 = torch.randn((2, 9, 9, 8), device=cuda)
    d8 = torch.randn((2, 9, 9, 8), device=cuda)
    w8 = torch.empty((1, 1, 8, 8), device=cuda)
    flat = torch.empty(8 * 9 * 9 * 2 + 1, device=cuda)[1:].view(2, 9, 9, 8)
    for xp, chunk in ((flat, 192), (x8, 100)):
        assert fn(xp.data_ptr(), d8.data_ptr(), w8.data_ptr(),
                  w8.data_ptr(), 2, 9, 9, 8, 8, 1, 1, 1, 0, 3, 1, chunk,
                  stream) != 0


def _k9_stream_args(case, dev, ids):
    t, d, f, e, bm = case
    g = torch.Generator(device=dev).manual_seed(t + d + f)
    tokens = torch.randn((t, d), generator=g, device=dev).bfloat16()
    weights = (torch.randn((e, d, f), generator=g, device=dev)
               * d ** -0.5).bfloat16()
    return tokens, weights, torch.tensor(ids, dtype=torch.int32, device=dev)


# (t, d, f, e, bm), tile_eid: the decode layout spread over 8 experts and
# on one, -1 tiles in the middle and at the end, D and F tails (D 200 ends
# inside a 64-row stage, F 136 inside a 256-column box), bm 32 and 48, a
# ragged last tile, and the cut's D (one expert's items cut into D chunks)
K9_STREAM_CASES = [
    ((144, 256, 512, 8, 16), [0, 1, 2, 3, 4, 5, 6, 7, -1]),
    ((144, 256, 512, 8, 16), [3, -1, -1, -1, -1, -1, -1, -1, -1]),
    ((144, 512, 768, 8, 16), [2, -1, 0, 5, -1, 1, 7, 7, -1]),
    ((144, 200, 136, 4, 16), [1, 3, -1, 0, 2, -1, 3, 1, -1]),
    ((96, 328, 264, 3, 32), [2, -1, 0]),
    ((100, 64, 72, 2, 48), [1, 0, -1]),
    ((130, 96, 40, 3, 16), [0, 1, 2, -1, 0, 1, 2, -1, 2]),
    ((144, 8192, 3072, 8, 16), [0, 1, 2, 3, 4, 5, 6, 7, -1]),
    ((144, 8192, 3072, 8, 16), [6, -1, -1, -1, -1, -1, -1, -1, -1]),
    ((144, 1024, 8192, 8, 16), [0, 1, 2, 3, 4, 5, 6, 7, -1]),
]


@pytest.mark.parametrize("case,ids", K9_STREAM_CASES)
def test_moe_gmm_stream_route_matches_plain(cuda, case, ids):
    """The decode route: every used tile's rows against its expert's
    product within 1e-2 (bf16), -1 tiles zero, the same bits twice, one
    launch on ``launches`` and ``launches_stream``."""
    tokens, weights, tile_eid = _k9_stream_args(case, cuda, ids)
    bm = case[-1]
    assert k9.route(tokens, weights, bm) == "stream"
    before = (k9.launches, k9.launches_stream, k9.launches_wgmma)
    out = k9.moe_gmm(tokens, weights, tile_eid, bm=bm)
    torch.cuda.synchronize()
    assert (k9.launches, k9.launches_stream, k9.launches_wgmma) == \
        (before[0] + 1, before[1] + 1, before[2])
    exp = k9.moe_gmm_plain(tokens, weights, tile_eid, bm=bm)
    assert out.dtype == torch.bfloat16 and out.shape == exp.shape
    assert _rel_err(out.float(), exp.float()) <= 1e-2
    for i, eid in enumerate(ids):
        if eid < 0:
            assert not out[i * bm:(i + 1) * bm].any()
    assert torch.equal(out, k9.moe_gmm(tokens, weights, tile_eid, bm=bm))


@pytest.mark.parametrize("bm,dtype,want", [
    (16, torch.bfloat16, "stream"), (32, torch.bfloat16, "stream"),
    (64, torch.bfloat16, "wgmma"), (128, torch.bfloat16, "wgmma"),
    (16, torch.float32, "mma"), (64, torch.float32, "mma"),
    (128, torch.float32, "mma")])
def test_moe_gmm_dispatch_by_bm_and_dtype_on_the_card(cuda, bm, dtype, want):
    """K9's dispatch as the card runs it: each call counts one launch on
    ``launches`` and one on its route's counter (none for mma), and agrees
    with the plain version."""
    tokens, weights, tile_eid = _k9_args((512, 256, 384, 4, bm), cuda, dtype)
    assert k9.route(tokens, weights, bm) == want
    before = (k9.launches, k9.launches_wgmma, k9.launches_stream)
    out = k9.moe_gmm(tokens, weights, tile_eid, bm=bm)
    torch.cuda.synchronize()
    delta = [a - b for a, b in zip(
        (k9.launches, k9.launches_wgmma, k9.launches_stream), before)]
    assert delta == [1, int(want == "wgmma"), int(want == "stream")]
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    exp = k9.moe_gmm_plain(tokens, weights, tile_eid, bm=bm)
    assert _rel_err(out.float(), exp.float()) <= tol


def test_moe_gmm_stream_kernel_refuses_what_its_route_excludes(cuda):
    """The stream route's C function returns an error for bm 64 or 8, a D
    off the multiples of 8, and more D chunks than it takes or than its
    scratch holds: no route gives way to another."""
    tokens, weights, tile_eid = _k9_stream_args(
        (144, 256, 512, 8, 16), cuda, [0] * 9)
    out = torch.empty((144, 512), dtype=torch.bfloat16, device=cuda)
    fn = k9._kernel_fn_stream()
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (tokens.data_ptr(), weights.data_ptr(), tile_eid.data_ptr(),
            out.data_ptr())
    for t, d, bm, s_max in ((144, 256, 64, 1), (144, 256, 8, 1),
                            (144, 250, 16, 1), (144, 256, 16, 2),
                            (144, 256, 16, 9)):
        assert fn(*ptrs, None, t, d, 512, 8, bm, s_max, stream) != 0


# -- K1's and K10a's mma routes (3xTF32 on the tensor cores) -----------------

# ragged pixel counts: N*P*Q off the 64- and 128-pixel tiles, one pixel, C
# off the 32-channel stage (a zero-filled tail), K off the 64-channel tile
K1_MMA_RAGGED = [(1, 5, 7, 8, 12, 1, 1, 0), (3, 11, 13, 12, 20, 3, 2, 1),
                 (1, 1, 1, 4, 4, 1, 1, 0), (5, 17, 19, 36, 44, 3, 1, 1),
                 (7, 23, 23, 64, 72, 1, 1, 0), (2, 9, 9, 100, 68, 3, 1, 1)]
K1_MMA_CASES = [c for c in CASES if c[3] % 4 == 0 and c[4] % 4 == 0] \
    + K1_MMA_RAGGED


def _k1_counts():
    return k1.launches, k1.launches_mma


@pytest.mark.parametrize("case", K1_MMA_CASES)
@pytest.mark.parametrize("epi", range(len(EPILOGUES)))
def test_conv_mma_route_matches_plain(cuda, case, epi):
    """K1's mma route on CASES and ragged pixel counts, every epilogue:
    within 1e-5 of max |plain|, the same bits twice, one launch counted on
    both counters."""
    args = _args(case, cuda, **EPILOGUES[epi])
    assert k1.route(args["x"], args["w"]) == "mma"
    before = _k1_counts()
    out = k1.conv2d_direct(**args)
    torch.cuda.synchronize()
    assert _k1_counts() == (before[0] + 1, before[1] + 1)
    exp = k1.conv2d_direct_plain(**args)
    assert out.shape == exp.shape
    assert _rel_err(out, exp) <= 1e-5
    assert torch.equal(out, k1.conv2d_direct(**args))


@pytest.mark.parametrize("r,s", [(2, 2), (2, 1), (1, 2), (1, 1)])
def test_conv_mma_route_on_dual_subfilters(cuda, r, s):
    """The four sub-filters of the 56x56 -> 28x28 3x3 stride-2 layer's
    phase plan, on its pre-padded dO plane, through the mma route."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((4, 28 + r - 1, 28 + s - 1, 128), generator=g,
                    device=cuda)
    w = torch.randn((r, s, 128, 128), generator=g, device=cuda) / 16
    assert k1.route(x, w) == "mma"
    before = _k1_counts()
    out = k1.conv2d_direct(x, w, stride=1, padding=0)
    torch.cuda.synchronize()
    assert _k1_counts() == (before[0] + 1, before[1] + 1)
    assert _rel_err(out, k1.conv2d_direct_plain(x, w, stride=1,
                                                padding=0)) <= 1e-5
    assert torch.equal(out, k1.conv2d_direct(x, w, stride=1, padding=0))


@pytest.mark.parametrize("tile", sorted(k1.MMA_TILES))
@pytest.mark.parametrize("splits", [1, 2, 3])
def test_conv_mma_every_tile_and_split(cuda, tile, splits):
    """Each block tile, unsplit and split (the sum pass applies the
    epilogue), on a 7x7 stage's shape with a residual: within 1e-5 of
    plain, the same bits twice."""
    case = (3, 7, 7, 96, 136, 3, 1, 1)
    args = _args(case, cuda, bn=True, residual=True, relu=True)
    steps = 9 * 3
    chunk = -(-steps // splits)
    plan = k1.MmaPlan(tile=tile, splits=splits, chunk=chunk, blocks=0)
    out = torch.empty((3, 7, 7, 136), device=cuda)
    kw = dict(scale=args["scale"], shift=args["shift"], bias=None,
              residual=args["residual"], relu=True, stride=1, padding=1)
    k1._launch_mma(args["x"], args["w"], out, plan=plan, **kw)
    again = k1._launch_mma(args["x"], args["w"], torch.empty_like(out),
                           plan=plan, **kw)
    torch.cuda.synchronize()
    assert _rel_err(out, k1.conv2d_direct_plain(**args)) <= 1e-5
    assert torch.equal(out, again)


def test_conv_simt_route_keeps_ragged_channels(cuda):
    args = _args((3, 11, 13, 5, 7, 3, 2, 1), cuda, bn=True, relu=True)
    assert k1.route(args["x"], args["w"]) == "simt"
    before = _k1_counts()
    out = k1.conv2d_direct(**args)
    torch.cuda.synchronize()
    assert _k1_counts() == (before[0] + 1, before[1])
    assert _rel_err(out, k1.conv2d_direct_plain(**args)) <= 1e-5
    flat = torch.empty(2 * 9 * 9 * 8 + 1, device=cuda)[1:].view(2, 9, 9, 8)
    flat.copy_(torch.randn((2, 9, 9, 8), device=cuda))
    w = torch.randn((3, 3, 8, 8), device=cuda)
    assert k1.route(flat, w) == "simt"
    out = k1.conv2d_direct(flat, w, stride=1, padding=1)
    assert _k1_counts() == (before[0] + 2, before[1])
    assert _rel_err(out, k1.conv2d_direct_plain(flat, w, stride=1,
                                                padding=1)) <= 1e-5


def test_conv_mma_kernel_refuses_what_its_route_excludes(cuda):
    """The mma route's C function returns an error for C or K off the
    multiples of 4, an unaligned operand and a chunk that leaves a split
    empty or steps uncovered: the wrapper would raise, and never gives way
    to the SIMT kernel."""
    fn = k1._kernel_fn_mma()
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.randn((2, 9, 9, 8), device=cuda)
    w = torch.randn((3, 3, 8, 8), device=cuda)
    out = torch.empty((2, 9, 9, 8), device=cuda)
    flat = torch.empty(8 * 9 * 9 * 2 + 1, device=cuda)[1:].view(2, 9, 9, 8)

    def call(xp, c, k, splits, chunk):
        return fn(xp.data_ptr(), w.data_ptr(), None, None, None, None,
                  out.data_ptr(), out.data_ptr(), 2, 9, 9, c, k, 3, 3, 1, 1,
                  0, 0, splits, chunk, stream)
    assert call(x, 8, 8, 1, 9) == 0       # 9 steps in one block
    torch.cuda.synchronize()
    assert call(x, 6, 8, 1, 9) != 0
    assert call(x, 8, 6, 1, 9) != 0
    assert call(flat, 8, 8, 1, 9) != 0
    assert call(x, 8, 8, 1, 8) != 0       # a step uncovered
    assert call(x, 8, 8, 3, 5) != 0       # the third split empty


@pytest.mark.parametrize("case", WHOLE_CASES)
@pytest.mark.parametrize("epi", range(len(EPILOGUES)))
def test_whole_mma_route_matches_plain_split_or_not(cuda, case, epi,
                                                    monkeypatch):
    """K10a's mma route on WHOLE_CASES with the reference's blocking:
    within 1e-5 of plain, the same bits twice, and the same bits with each
    reference block's rows cut across blocks (``whole_split``)."""
    args = _args(case, cuda, **EPILOGUES[epi])
    blk = _whole_blk(case)
    assert k1.route_whole(args["x"], args["w"]) == "mma"
    before = (k1.launches_whole, k1.launches_whole_mma, k1.launches)
    monkeypatch.setattr(k1, "whole_split", lambda **kw: False)
    out = k1.conv2d_direct_whole(**args, **blk)
    torch.cuda.synchronize()
    assert (k1.launches_whole, k1.launches_whole_mma, k1.launches) == \
        (before[0] + 1, before[1] + 1, before[2])
    assert _rel_err(out, k1.conv2d_direct_whole_plain(**args, **blk)) <= 1e-5
    assert torch.equal(out, k1.conv2d_direct_whole(**args, **blk))
    monkeypatch.setattr(k1, "whole_split", lambda **kw: True)
    assert torch.equal(out, k1.conv2d_direct_whole(**args, **blk))


@pytest.mark.parametrize("case,blk", WHOLE_BLOCKINGS)
def test_whole_mma_route_other_blockings(cuda, case, blk, monkeypatch):
    """A P tail, rb_p = P at 56x56 (several passes a block), k_blk below K,
    one row a block: split and unsplit equal bit for bit."""
    args = _args(case, cuda, bn=True, residual=True, relu=True)
    outs = []
    for split in (False, True):
        monkeypatch.setattr(k1, "whole_split", lambda **kw: split)
        outs.append(k1.conv2d_direct_whole(**args, **blk))
    assert _rel_err(outs[0],
                    k1.conv2d_direct_whole_plain(**args, **blk)) <= 1e-5
    assert torch.equal(outs[0], outs[1])


def test_whole_mma_route_on_rows_wider_than_a_pass(cuda):
    """Q 150 and 200 (rows in segments of at most 128 columns), stride 1
    and 2."""
    for case in ((1, 6, 150, 8, 16, 3, 1, 1), (2, 8, 400, 16, 8, 3, 2, 1)):
        args = _args(case, cuda, bn=True, relu=True)
        blk = dict(rb_p=3, k_blk=8)
        out = k1.conv2d_direct_whole(**args, **blk)
        assert _rel_err(out, k1.conv2d_direct_whole_plain(**args, **blk)) \
            <= 1e-5


def test_conv_mma_dispatch_by_counters(cuda):
    """Reduced ResNet-50 on the card: a tiled forward and a training step's
    K1 launches all take the mma route; under ``whole`` every K10a launch
    does."""
    from repro_torch.convert import params_to
    from repro_torch.graph import GxM, resnet50
    net = GxM(resnet50(10, stages=(1, 1, 1, 1)), device=cuda,
              num_classes=10)
    params = params_to(net.init(torch.Generator().manual_seed(0)), cuda)
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(1)
                    ).to(cuda)
    before = _k1_counts()
    net.infer(params, x)
    torch.cuda.synchronize()
    fwd = [a - b for a, b in zip(_k1_counts(), before)]
    assert fwd[0] == fwd[1] == 16
    before = (k1.launches_whole, k1.launches_whole_mma)
    with be.use_conv_tiling("whole"):
        net.infer(params, x)
    torch.cuda.synchronize()
    assert (k1.launches_whole - before[0],
            k1.launches_whole_mma - before[1]) == (16, 16)
    case = (2, 10, 10, 16, 24, 3, 2, 1)
    n, h, w, c, k, r, st, pad = case
    xx = torch.randn((n, h, w, c), device=cuda, requires_grad=True)
    ww = torch.randn((r, r, c, k), device=cuda, requires_grad=True)
    before = _k1_counts()
    conv2d_train(xx, ww, st, pad).square().sum().backward()
    torch.cuda.synchronize()
    delta = [a - b for a, b in zip(_k1_counts(), before)]
    assert delta[0] == delta[1] >= 2     # the forward and the dual convs


# -- K10c's and K4's mma routes -----------------------------------------------

# n, h, w, c, k, r, stride, pad and rb_p, k_blk: ragged P (rb_p not dividing
# it), Q (odd, and over 128: row segments), k_blk below K, C with a half
# slice (48), stride 2, a 1x1 conv
Q8_MMA_CASES = [
    ((2, 13, 11, 48, 24, 3, 1, 1), dict(rb_p=5, k_blk=8)),
    ((1, 12, 150, 32, 16, 3, 1, 1), dict(rb_p=3, k_blk=16)),
    ((3, 15, 15, 16, 40, 3, 2, 1), dict(rb_p=4, k_blk=8)),
    ((2, 9, 9, 64, 64, 1, 1, 0), dict(rb_p=9, k_blk=32)),
    ((16, 56, 56, 64, 64, 3, 1, 1), dict(rb_p=56, k_blk=64)),
]


@pytest.mark.parametrize("case,blk", Q8_MMA_CASES)
@pytest.mark.parametrize("epi", [0, 3])
def test_whole_q8_mma_route_equals_plain_cut_or_not(cuda, case, blk, epi,
                                                     monkeypatch):
    """K10c's mma route = its plain version = K3, bit for bit, with each
    reference block's rows whole and cut across CTAs; one launch on each
    counter."""
    args = _q8_args(case, cuda, **EPILOGUES[epi])
    assert k3.route_whole(args["x_q"], args["w_q"]) == "mma"
    plain = k3.conv2d_q8_whole_plain(**args, **blk)
    for split in (False, True):
        monkeypatch.setattr(k3, "whole_split", lambda **kw: split)
        before = (k3.launches_whole, k3.launches_whole_mma, k3.launches)
        out = k3.conv2d_q8_whole(**args, **blk)
        torch.cuda.synchronize()
        assert (k3.launches_whole, k3.launches_whole_mma, k3.launches) == \
            (before[0] + 1, before[1] + 1, before[2])
        assert torch.equal(out, plain)
    assert torch.equal(plain, k3.conv2d_q8(**args))


def test_whole_q8_simt_route_for_c_off_16(cuda):
    """C 8 and 24 take the __dp4a kernel: counted by launches_whole only."""
    for case in ((2, 9, 9, 8, 16, 3, 1, 1), (1, 10, 10, 24, 8, 3, 2, 1)):
        args = _q8_args(case, cuda, bias=True, relu=True)
        blk = dict(rb_p=4, k_blk=8)
        assert k3.route_whole(args["x_q"], args["w_q"]) == "simt"
        before = (k3.launches_whole, k3.launches_whole_mma)
        out = k3.conv2d_q8_whole(**args, **blk)
        torch.cuda.synchronize()
        assert (k3.launches_whole, k3.launches_whole_mma) == \
            (before[0] + 1, before[1])
        assert torch.equal(out, k3.conv2d_q8_whole_plain(**args, **blk))


def test_whole_q8_mma_kernel_refuses_what_its_route_excludes(cuda):
    """The C function itself refuses a C off the multiples of 16, a k_blk
    off the multiples of 8 and a pass wider than 128 pixels."""
    fn = k3._kernel_fn_whole_mma()
    xp = torch.zeros((1, 10, 10, 16), dtype=torch.int8, device=cuda)
    wt = torch.zeros((3, 3, 4, 16), dtype=torch.int32, device=cuda)
    sc = torch.ones(16, device=cuda)
    out = torch.empty((1, 8, 8, 16), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream

    def call(c, k_blk, rows_pass, cols):
        return fn(xp.data_ptr(), wt.data_ptr(), sc.data_ptr(), sc.data_ptr(),
                  None, None, None, None, out.data_ptr(), 1, 10, 10, c, 16, 3,
                  3, 1, 8, 8, 8, k_blk, 8, rows_pass, cols, 10, 10, 32, 3,
                  96 * 1024, 0, stream)
    assert call(16, 16, 8, 8) == 0
    torch.cuda.synchronize()
    assert call(8, 16, 8, 8) != 0
    assert call(16, 12, 8, 8) != 0
    assert call(16, 16, 8, 8 + 9) != 0


STREAM_MMA_CASES = [c for c in STREAM_CASES
                    if c[3] % 4 == c[4] % 4 == c[9] % 4 == c[10] % 4 == 0]


@pytest.mark.parametrize("case", STREAM_MMA_CASES)
@pytest.mark.parametrize("order", ["nkpc", "npkc"])
def test_streams_mma_route_matches_plain(cuda, case, order):
    """K4's mma route within 1e-5 of the plain replay, the same bits twice
    and on shuffled runs; one launch on each counter."""
    args = _stream_args(case, cuda, order)
    assert k4.route(args["x"], args["w"], args["c_blk"],
                    args["k_blk"]) == "mma"
    before = (k4.launches, k4.launches_mma)
    out = k4.conv2d_streams(**args)
    torch.cuda.synchronize()
    assert (k4.launches, k4.launches_mma) == (before[0] + 1, before[1] + 1)
    assert _rel_err(out, k4.conv2d_streams_plain(**args)) <= 1e-5
    assert torch.equal(out, k4.conv2d_streams(**args))
    runs = len(streams.run_starts(args["schedule"]))
    perm = torch.randperm(runs, generator=torch.Generator().manual_seed(2))
    shuf = streams.permute_runs(args["schedule"], perm.tolist())
    assert torch.equal(out, k4.conv2d_streams(**{**args, "schedule": shuf}))


@pytest.mark.parametrize("tile", sorted(k4.MMA_TILES))
def test_streams_mma_every_tile(cuda, tile, monkeypatch):
    """Each CTA tile of the mma route, forced, on a P tail with ragged
    c_blk (36: a stage of 32 channels and one of 4) and k_blk edges, and
    at each stage depth (c_blk 8, 16 and 32)."""
    monkeypatch.setattr(k4, "mma_tile_config", lambda **kw: (tile, 1.0))
    for case in ((1, 10, 10, 72, 24, 3, 1, 1, 3, 12, 36), STREAM_CASES[7],
                 STREAM_CASES[0], (1, 10, 10, 48, 24, 3, 1, 1, 3, 12, 16)):
        args = _stream_args(case, cuda)
        out = k4.conv2d_streams(**args)
        torch.cuda.synchronize()
        assert _rel_err(out, k4.conv2d_streams_plain(**args)) <= 1e-5


def test_streams_simt_route_keeps_ragged_blocks(cuda):
    """c_blk 6 and k_blk 10 take the SIMT kernel: counted by launches only."""
    args = _stream_args(STREAM_CASES[6], cuda)
    assert k4.route(args["x"], args["w"], 6, 10) == "simt"
    before = (k4.launches, k4.launches_mma)
    out = k4.conv2d_streams(**args)
    torch.cuda.synchronize()
    assert (k4.launches, k4.launches_mma) == (before[0] + 1, before[1])
    assert _rel_err(out, k4.conv2d_streams_plain(**args)) <= 1e-5
