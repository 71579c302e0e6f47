"""K3: int8 direct-convolution forward with an f32 dequant epilogue (§II-K).

Replaces ``repro/kernels/conv2d_q8.py:conv2d_q8`` (the Pallas
``_kernel_q8_tiled``, ``pallas_call`` at :204).  From x_q (N,H,W,C) int8 and
w_q (R,S,C,K) int8 it accumulates the exact int32 conv, then computes
``out = relu?((f32(acc) * deq) * scale + shift + bias + residual)`` in f32,
with ``deq = x_scale * w_scale`` premultiplied in f32 once per K channel.

Two versions live here:

* ``conv2d_q8_plain`` repeats the kernel's arithmetic in PyTorch: pad, then
  one strided slice and one (pixels, C) x (C, K) product per (r, s) in
  float64, which is exact for |acc| < 2**31 < 2**53, then int32, then the
  same f32 epilogue operations in the same order.  One code path serves the
  CPU and the card (PyTorch has no int32 matmul on CUDA).
* the CUDA C++ kernel ``csrc/conv2d_q8.cu``, built for sm_90a: K1's
  implicit GEMM with the products on the tensor cores
  (``mma.sync.m16n8k32.s32.s8.s8.s32``).

int32 sums are associative and the epilogue rounds in the same places, so
the two versions agree bit for bit.  ``conv2d_q8`` takes the plain version
for a CPU tensor and launches the kernel for a CUDA tensor; there is no
fallback between them.  ``launches`` counts the kernel's launches.

K10c, the same function by the reference's legacy whole-plane strategy
(``repro/kernels/conv2d_q8.py:_conv2d_q8_whole_plane``, ``pallas_call`` at
:246), lives here too: ``conv2d_q8_whole``, its plain version
``conv2d_q8_whole_plain`` and the kernel ``csrc/conv2d_q8_whole.cu``
(K10a's structure with ``__dp4a`` products), counted by ``launches_whole``.
The reference requires it to equal the tiled kernel bit for bit; here the
int32 sums are exact in any order and the epilogue rounds as K3's, so
K10c, K3 and both plain versions agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_direct import (FuseSpec, _aligned, _check,
                                               _check_whole_blocking,
                                               _epilogue, _out_hw, pad_input,
                                               whole_plan,
                                               whole_plane_products)

# Launches of the CUDA kernel since the last reset (set it to 0 to reset).
launches = 0
_fn = None
# Launches of the whole-plane kernel K10c since the last reset.
launches_whole = 0
_fn_whole = None


def _check_overflow(r: int, s: int, c: int) -> None:
    """The §II-K chain-length discipline: the longest int32 sum,
    R*S*C products of at most 127*127, must stay below 2**31."""
    if r * s * c * 127 * 127 >= 2 ** 31:
        raise ValueError(f"int32 accumulator overflow: R*S*C = {r * s * c} "
                         f"products of up to 127*127 reach 2**31")


def _deq(x_scale, w_scale):
    """Premultiplied dequant scales, (K,) f32: one f32 multiply each."""
    return x_scale.reshape(()).to(torch.float32) * w_scale.to(torch.float32)


def conv2d_q8_plain(x_q, w_q, *, x_scale, w_scale, stride: int = 1,
                    padding: int = 0, bias=None, scale=None, shift=None,
                    residual=None, relu: bool = False):
    """The kernel's arithmetic in plain PyTorch (int8 operands)."""
    n, h, wd, c = x_q.shape
    r, s, _, k = w_q.shape
    p, q = _out_hw(h, wd, r, s, stride, padding)
    fuse = FuseSpec(bias=bias is not None, bn=scale is not None,
                    residual=residual is not None, relu=relu)
    xp = F.pad(x_q.to(torch.float64), (0, 0, padding, padding, padding,
                                       padding))
    wf = w_q.to(torch.float64)
    acc = torch.zeros((n * p * q, k), dtype=torch.float64, device=x_q.device)
    for rr in range(r):
        for ss in range(s):
            xs = xp[:, rr:rr + (p - 1) * stride + 1:stride,
                    ss:ss + (q - 1) * stride + 1:stride, :]
            acc += xs.reshape(n * p * q, c) @ wf[rr, ss]
    acc = acc.to(torch.int32).reshape(n, p, q, k)
    out = acc.to(torch.float32) * _deq(x_scale, w_scale)
    return _epilogue(out, fuse, bias, scale, shift, residual)


def conv2d_q8_whole_plain(x_q, w_q, *, x_scale, w_scale, stride: int = 1,
                          padding: int = 0, bias=None, scale=None,
                          shift=None, residual=None, relu: bool = False,
                          rb_p: int, k_blk: int):
    """K10c's arithmetic in plain PyTorch, as the reference's whole-plane
    kernel does it: pad as ``pad_input``, then for each block of rb_p rows
    and the full row Q one (pixels, C) x (C, K) product per (r, s) in
    float64 (exact, as in ``conv2d_q8_plain``), rows past P dropped, then
    int32 and K3's f32 dequant and epilogue."""
    h, wd = x_q.shape[1:3]
    r, s, _, k = w_q.shape
    p, q = _out_hw(h, wd, r, s, stride, padding)
    _check_whole_blocking(k, rb_p, k_blk)
    rb_p = min(rb_p, p)
    fuse = FuseSpec(bias=bias is not None, bn=scale is not None,
                    residual=residual is not None, relu=relu)
    xp = pad_input(x_q.to(torch.float64), padding=padding, stride=stride,
                   rb_p=rb_p, r=r, p=p)
    acc = whole_plane_products(xp, w_q.to(torch.float64), rb_p=rb_p, p=p,
                               q=q, stride=stride).to(torch.int32)
    out = acc.to(torch.float32) * _deq(x_scale, w_scale)
    return _epilogue(out, fuse, bias, scale, shift, residual)


def _check_q8(x_q, w_q, x_scale, w_scale, bias, scale, shift, residual,
              stride, padding):
    """Shapes and types every path needs; returns (P, Q)."""
    p, q = _check(x_q, w_q, bias, scale, shift, residual, stride, padding)
    for name, v in (("x_q", x_q), ("w_q", w_q)):
        if v.dtype != torch.int8:
            raise ValueError(f"{name} must be int8, got {v.dtype}")
    r, s, c, k = w_q.shape
    _check_overflow(r, s, c)
    if x_scale.numel() != 1:
        raise ValueError(f"x_scale must hold one value, got "
                         f"{tuple(x_scale.shape)}")
    if tuple(w_scale.shape) != (k,):
        raise ValueError(f"w_scale must be ({k},), got "
                         f"{tuple(w_scale.shape)}")
    return p, q


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load("conv2d_q8").repro_conv2d_q8
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def conv2d_q8(x_q, w_q, *, x_scale, w_scale, stride: int = 1,
              padding: int = 0, bias=None, scale=None, shift=None,
              residual=None, relu: bool = False):
    """Quantized direct conv fwd.  x_q: (N,H,W,C) int8; w_q: (R,S,C,K) int8;
    x_scale: one f32 (per-tensor activation scale); w_scale: (K,) f32 (per
    output channel) -> (N,P,Q,K) f32.  The optional bias / folded-BN
    scale+shift / residual / relu epilogue is applied in f32 after
    dequantization.  A CPU tensor takes ``conv2d_q8_plain``; a CUDA tensor
    launches the sm_90a kernel on the current stream or raises."""
    global launches
    p, q = _check_q8(x_q, w_q, x_scale, w_scale, bias, scale, shift,
                     residual, stride, padding)
    kw = dict(x_scale=x_scale, w_scale=w_scale, stride=stride,
              padding=padding, bias=bias, scale=scale, shift=shift,
              residual=residual, relu=relu)
    if x_q.device.type == "cpu":
        return conv2d_q8_plain(x_q, w_q, **kw)
    if x_q.device.type != "cuda":
        raise ValueError(f"conv2d_q8 runs on cpu or cuda, not {x_q.device}")
    f32 = [("x_scale", x_scale), ("w_scale", w_scale)] + [
        ("epilogue operand", v) for v in (bias, scale, shift, residual)
        if v is not None]
    for name, v in (("x_q", x_q), ("w_q", w_q), *f32):
        if v.device != x_q.device:
            raise ValueError(f"{name} on {v.device}, x_q on {x_q.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, v in f32:
        if v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {v.dtype}")
    n, h, wd, c = x_q.shape
    r, s, _, k = w_q.shape
    out = torch.empty((n, p, q, k), dtype=torch.float32, device=x_q.device)
    if out.numel() == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = _kernel_fn()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream(x_q.device).cuda_stream
        launches += 1
        err = fn(x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
                 w_scale.data_ptr(), ptr(scale), ptr(shift), ptr(bias),
                 ptr(residual), out.data_ptr(), n, h, wd, c, k, r, s, stride,
                 padding, int(relu), stream)
    if err != 0:
        raise RuntimeError(f"conv2d_q8 kernel launch failed: CUDA error "
                           f"{err} (x_q {tuple(x_q.shape)}, w_q "
                           f"{tuple(w_q.shape)})")
    return out


def _kernel_fn_whole():
    global _fn_whole
    if _fn_whole is None:
        fn = _build.load("conv2d_q8_whole").repro_conv2d_q8_whole
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 17 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_whole = fn
    return _fn_whole


def conv2d_q8_whole(x_q, w_q, *, x_scale, w_scale, stride: int = 1,
                    padding: int = 0, bias=None, scale=None, shift=None,
                    residual=None, relu: bool = False, rb_p: int,
                    k_blk: int):
    """K10c: the quantized direct conv of ``conv2d_q8`` by the whole-plane
    strategy, with the reference's blocking (``rb_p`` output rows by the
    full row Q, ``k_blk`` output channels per block).  A CPU tensor takes
    ``conv2d_q8_whole_plain``; a CUDA tensor launches the sm_90a kernel on
    the current stream or raises."""
    global launches_whole
    p, q = _check_q8(x_q, w_q, x_scale, w_scale, bias, scale, shift,
                     residual, stride, padding)
    k = w_q.shape[3]
    _check_whole_blocking(k, rb_p, k_blk)
    kw = dict(x_scale=x_scale, w_scale=w_scale, stride=stride,
              padding=padding, bias=bias, scale=scale, shift=shift,
              residual=residual, relu=relu)
    if x_q.device.type == "cpu":
        return conv2d_q8_whole_plain(x_q, w_q, rb_p=rb_p, k_blk=k_blk, **kw)
    if x_q.device.type != "cuda":
        raise ValueError(f"conv2d_q8_whole runs on cpu or cuda, not "
                         f"{x_q.device}")
    f32 = [("x_scale", x_scale), ("w_scale", w_scale)] + [
        ("epilogue operand", v) for v in (bias, scale, shift, residual)
        if v is not None]
    for name, v in (("x_q", x_q), ("w_q", w_q), *f32):
        if v.device != x_q.device:
            raise ValueError(f"{name} on {v.device}, x_q on {x_q.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, v in f32:
        if v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {v.dtype}")
    n, h, wd, c = x_q.shape
    r, s = w_q.shape[:2]
    if c % 8:
        raise ValueError(f"C={c}: the whole-plane kernel stages input "
                         f"channels 8 at a time")
    rb_p = min(rb_p, p)
    xp = pad_input(x_q, padding=padding, stride=stride, rb_p=rb_p, r=r, p=p)
    hp, wp = xp.shape[1], xp.shape[2]
    plan = whole_plan(p=p, q=q, k_blk=k_blk, rb_p=rb_p, r=r, s=s,
                      stride=stride, wp=wp, slice_bytes=32)
    out = torch.empty((n, p, q, k), dtype=torch.float32, device=x_q.device)
    if out.numel() == 0:
        return out
    # words of 4 input channels of one output channel: (R, S, C/4, K, 4)
    wt = w_q.reshape(r, s, c // 4, 4, k).permute(0, 1, 2, 4, 3).contiguous()
    residual = _aligned(residual)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = _kernel_fn_whole()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream(x_q.device).cuda_stream
        launches_whole += 1
        err = fn(xp.data_ptr(), wt.data_ptr(), x_scale.data_ptr(),
                 w_scale.data_ptr(), ptr(scale), ptr(shift), ptr(bias),
                 ptr(residual), out.data_ptr(), n, hp, wp, c, k, r, s,
                 stride, p, q, rb_p, k_blk, plan.rows_pass, plan.bn, plan.tm,
                 plan.smem, int(relu), stream)
    if err != 0:
        raise RuntimeError(f"conv2d_q8_whole kernel launch failed: CUDA "
                           f"error {err} (x_q {tuple(x_q.shape)}, w_q "
                           f"{tuple(w_q.shape)}, {plan})")
    return out


def quantize_conv_inputs(x, w):
    """Symmetric per-tensor activation scale and per-K-channel weight
    scales (the standard inference calibration): returns
    (x_q, w_q, x_scale, w_scale) with x_scale a 0-d f32 tensor."""
    x_scale = x.abs().max().to(torch.float32) / 127.0 + 1e-12
    x_q = torch.clamp(torch.round(x / x_scale), -127, 127).to(torch.int8)
    w_scale = w.abs().amax(dim=(0, 1, 2)).to(torch.float32) / 127.0 + 1e-12
    w_q = torch.clamp(torch.round(w / w_scale), -127, 127).to(torch.int8)
    return x_q, w_q, x_scale, w_scale
