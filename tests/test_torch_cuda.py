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
    """Each CTA tile of the kernel's switch, forced, on a case with a P
    tail and ragged k_blk and c_blk edges."""
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l", [(8, 1), (2, 600)])
def test_moe_layer_on_the_card_matches_the_cpu(cuda, dtype, b, l):
    """The smoke MoE layer (4 experts, top-2; a share of 2) on the card:
    3 K9 launches, no host synchronisation, the same bits twice, and the
    CPU's output (f32 within 1e-5, bf16 within 2e-2 of max |out|)."""
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
    before = k9.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, _ = moe.apply(dev, cfg, x_dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert k9.launches == before + 3
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
