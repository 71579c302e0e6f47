"""K5: NHWC max pooling, the paper's ResNet stem pool (§II-G: pooling is
one of the bandwidth-bound L() operators).

Replaces ``repro/kernels/pool2d.py:maxpool2d`` (the Pallas ``_kernel``,
``pallas_call`` at :46).  x (N,H,W,C) -> (N,P,Q,C): each output is the max
over its window x window input pixels, positions outside the plane
counting as -inf, taken in f32 and cast back to the input's type.

Two versions live here:

* ``maxpool2d_plain`` repeats the kernel's arithmetic in PyTorch: pad with
  -inf, then ``torch.maximum`` over the window² strided slices, in f32.
  The CPU tests run it, and ``chip_smoke.py`` holds the kernel against it
  on the card.
* the CUDA C++ kernel ``csrc/pool2d.cu``, built for sm_90a: one pass,
  16-byte vectors of channels per thread, the padding handled in the
  kernel (no padded copy).

``maxpool2d`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; there is no fallback between them.  ``launches``
counts the kernel's launches.  ``F.max_pool2d`` is the library yardstick
and a test oracle, not the plain version; the executor's max-pool stays
``F.max_pool2d``, as the reference's stays ``lax.reduce_window``.  The
reference kernel's ``rb_p`` blocks rows for the TPU grid; this kernel has
no such parameter.

What bounds it on an H100: bytes, one read of x and one write of out at
3.35 TB/s (64.2 MB at the batch-16 stem pool: 0.0192 ms).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

# Launches of the CUDA kernel since the last reset (set it to 0 to reset).
launches = 0
_fn = None

DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _out_hw(h, w, window, stride, padding):
    return ((h + 2 * padding - window) // stride + 1,
            (w + 2 * padding - window) // stride + 1)


def maxpool2d_plain(x, *, window: int = 3, stride: int = 2,
                    padding: int = 1):
    """The kernel's arithmetic in plain PyTorch."""
    n, h, w, c = x.shape
    p, q = _out_hw(h, w, window, stride, padding)
    xp = F.pad(x.to(torch.float32), (0, 0, padding, padding, padding,
                                     padding), value=float("-inf"))
    out = torch.full((n, p, q, c), float("-inf"), dtype=torch.float32,
                     device=x.device)
    for wr in range(window):
        for wc in range(window):
            out = torch.maximum(out, xp[:, wr:wr + (p - 1) * stride + 1:stride,
                                        wc:wc + (q - 1) * stride + 1:stride])
    return out.to(x.dtype)


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load("pool2d").repro_maxpool2d
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def maxpool2d(x, *, window: int = 3, stride: int = 2, padding: int = 1):
    """x: (N,H,W,C) -> (N,P,Q,C) max pooling with -inf padding.  A CPU
    tensor takes ``maxpool2d_plain``; a CUDA tensor launches the sm_90a
    kernel on the current stream or raises."""
    global launches
    if x.dim() != 4:
        raise ValueError(f"x must be (N,H,W,C), got {tuple(x.shape)}")
    if window < 1 or stride < 1 or padding < 0:
        raise ValueError(f"window {window}, stride {stride}, padding "
                         f"{padding}")
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be float32, float16 or bfloat16, got "
                         f"{x.dtype}")
    n, h, w, c = x.shape
    p, q = _out_hw(h, w, window, stride, padding)
    if p < 1 or q < 1:
        raise ValueError(f"empty output plane {p}x{q}")
    kw = dict(window=window, stride=stride, padding=padding)
    if x.device.type == "cpu":
        return maxpool2d_plain(x, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"maxpool2d runs on cpu or cuda, not {x.device}")
    _build.no_grad_inputs("maxpool2d (K5)", x)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    out = torch.empty((n, p, q, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launches += 1
        err = fn(x.data_ptr(), out.data_ptr(), n, h, w, c, window, stride,
                 padding, DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"maxpool2d kernel launch failed: CUDA error "
                           f"{err} (x {tuple(x.shape)}, {kw})")
    return out
