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
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_direct import (FuseSpec, _check, _epilogue,
                                               _out_hw)

# Launches of the CUDA kernel since the last reset (set it to 0 to reset).
launches = 0
_fn = None


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


def quantize_conv_inputs(x, w):
    """Symmetric per-tensor activation scale and per-K-channel weight
    scales (the standard inference calibration): returns
    (x_q, w_q, x_scale, w_scale) with x_scale a 0-d f32 tensor."""
    x_scale = x.abs().max().to(torch.float32) / 127.0 + 1e-12
    x_q = torch.clamp(torch.round(x / x_scale), -127, 127).to(torch.int8)
    w_scale = w.abs().amax(dim=(0, 1, 2)).to(torch.float32) / 127.0 + 1e-12
    w_q = torch.clamp(torch.round(w / w_scale), -127, 127).to(torch.int8)
    return x_q, w_q, x_scale, w_scale
