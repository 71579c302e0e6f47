"""K1: direct-convolution forward with the fused §II-G epilogue.

Replaces ``repro/kernels/conv2d_direct.py:conv2d_direct`` (the Pallas
``_kernel_tiled``, ``pallas_call`` at :295).  It computes
``out = relu?(scale*conv(x, w) + shift + bias + residual)`` with x (N,H,W,C),
w (R,S,C,K) and out (N,P,Q,K), accumulating in f32.

Two versions live here:

* ``conv2d_direct_plain`` repeats the kernel's arithmetic in PyTorch: pad,
  then one strided slice and one (pixels, C) x (C, K) matmul per (r, s),
  summed in f32, then the epilogue.  The CPU tests run it, and
  ``chip_smoke.py`` holds the kernel against it on the card.
* the CUDA C++ kernel ``csrc/conv2d_direct.cu``, built for sm_90a.

``conv2d_direct`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; there is no fallback between them.  ``launches``
counts the kernel's launches.

What bounds it on an H100: at ResNet-50's batch-16 shapes nearly every conv
does more than 20 FLOP per byte it must move, above the f32 ridge of
67 TFLOP/s over 3.35 TB/s, so the bound is the SIMT cores' f32 FMA rate.
The design answers with the paper's register blocking: each thread keeps an
8x8 (or 8x4, 4x4 on small planes) tile of outputs in registers and reuses
every staged input and weight value 8 (or 4) times, from a double-buffered
shared-memory slice of one (r, s) and 8 input channels.  Tensor cores
(TF32, bf16) would raise the ceiling but break the f32 parity the
reference holds; they are later work.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

# Launches of the CUDA kernel since the last reset (set it to 0 to reset).
launches = 0
_fn = None


@dataclasses.dataclass(frozen=True)
class FuseSpec:
    """Static description of the fused epilogue (paper §II-G L() operators)."""
    bias: bool = False
    bn: bool = False          # folded inference BN: scale * y + shift
    residual: bool = False
    relu: bool = False


def _out_hw(h, w, r, s, stride, padding):
    return ((h + 2 * padding - r) // stride + 1,
            (w + 2 * padding - s) // stride + 1)


def _epilogue(acc, fuse: FuseSpec, bias, scale, shift, residual):
    """The §II-G L() chain in the reference's order: scale, shift, bias,
    residual, relu."""
    if fuse.bn:
        acc = acc * scale
        acc = acc + shift
    if fuse.bias:
        acc = acc + bias
    if fuse.residual:
        acc = acc + residual
    if fuse.relu:
        acc = torch.clamp_min(acc, 0)
    return acc


def conv2d_direct_plain(x, w, *, stride: int = 1, padding: int = 0,
                        bias=None, scale=None, shift=None, residual=None,
                        relu: bool = False):
    """The kernel's arithmetic in plain PyTorch (f32 operands)."""
    n, h, wd, c = x.shape
    r, s, _, k = w.shape
    p, q = _out_hw(h, wd, r, s, stride, padding)
    fuse = FuseSpec(bias=bias is not None, bn=scale is not None,
                    residual=residual is not None, relu=relu)
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    acc = torch.zeros((n * p * q, k), dtype=torch.float32, device=x.device)
    for rr in range(r):
        for ss in range(s):
            xs = xp[:, rr:rr + (p - 1) * stride + 1:stride,
                    ss:ss + (q - 1) * stride + 1:stride, :]
            acc += xs.reshape(n * p * q, c) @ w[rr, ss]
    out = acc.reshape(n, p, q, k)
    return _epilogue(out, fuse, bias, scale, shift, residual)


def _check(x, w, bias, scale, shift, residual, stride, padding):
    """Shapes every path needs; returns (P, Q)."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x must be (N,H,W,C) and w (R,S,C,K); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, h, wd, c = x.shape
    r, s, wc, k = w.shape
    if wc != c:
        raise ValueError(f"w has C={wc}, x has C={c}")
    if stride < 1 or padding < 0:
        raise ValueError(f"stride {stride}, padding {padding}")
    p, q = _out_hw(h, wd, r, s, stride, padding)
    if p < 1 or q < 1:
        raise ValueError(f"empty output plane {p}x{q}")
    if (scale is None) != (shift is None):
        raise ValueError("folded BN needs both scale and shift")
    for name, v in (("bias", bias), ("scale", scale), ("shift", shift)):
        if v is not None and tuple(v.shape) != (k,):
            raise ValueError(f"{name} must be ({k},), got {tuple(v.shape)}")
    if residual is not None and tuple(residual.shape) != (n, p, q, k):
        raise ValueError(f"residual must be {(n, p, q, k)}, got "
                         f"{tuple(residual.shape)}")
    return p, q


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load("conv2d_direct").repro_conv2d_direct_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def conv2d_direct(x, w, *, stride: int = 1, padding: int = 0, bias=None,
                  scale=None, shift=None, residual=None, relu: bool = False):
    """Direct conv fwd + fused epilogue.  x: (N,H,W,C), w: (R,S,C,K) ->
    (N,P,Q,K).  A CPU tensor takes ``conv2d_direct_plain``; a CUDA tensor
    launches the sm_90a kernel on the current stream or raises."""
    global launches
    p, q = _check(x, w, bias, scale, shift, residual, stride, padding)
    if x.device.type == "cpu":
        return conv2d_direct_plain(x, w, stride=stride, padding=padding,
                                   bias=bias, scale=scale, shift=shift,
                                   residual=residual, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_direct runs on cpu or cuda, not {x.device}")
    extras = [v for v in (bias, scale, shift, residual) if v is not None]
    for name, v in (("x", x), ("w", w), *(("epilogue operand", e)
                                           for e in extras)):
        if v.device != x.device:
            raise ValueError(f"{name} on {v.device}, x on {x.device}")
        if v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {v.dtype}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, h, wd, c = x.shape
    r, s, _, k = w.shape
    out = torch.empty((n, p, q, k), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launches += 1
        err = fn(x.data_ptr(), w.data_ptr(), ptr(scale), ptr(shift),
                 ptr(bias), ptr(residual), out.data_ptr(), n, h, wd, c, k, r,
                 s, stride, padding, int(relu), stream)
    if err != 0:
        raise RuntimeError(f"conv2d_direct kernel launch failed: CUDA error "
                           f"{err} (x {tuple(x.shape)}, w {tuple(w.shape)})")
    return out
