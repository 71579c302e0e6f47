"""K8: depthwise causal conv1d, the Mamba mixer's short convolution.

Replaces ``repro/kernels/conv1d_causal.py:conv1d_causal`` (the Pallas
``_kernel``, ``pallas_call`` at :43).  It computes
``act(bias + sum_i x[:, l - KW + 1 + i] * w[i])`` for x (B,L,D), w (KW,D)
and bias (D,): each channel convolved with its own KW taps over the current
and the KW - 1 earlier tokens, zero before the first, accumulated in f32;
act is silu or none.  The output has x's dtype (f32 or bf16).

Two versions live here:

* ``conv1d_causal_plain``: ``ref.conv1d_causal`` (left pad KW - 1, the f32
  sum of KW shifted products, bias, act).  The CPU tests and the CPU path
  run it; ``chip_smoke.py`` holds the kernel against it.
* the CUDA C++ kernel ``csrc/conv1d_causal.cu``, built for sm_90a.

``conv1d_causal`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; there is no fallback between them.  ``launches``
counts the kernel's launches.  The kernel masks the causal edge and its D
and L tails, so it takes any D and any L >= 1; the reference's fallback to
its oracle when D % 8 != 0 exists only because a Pallas block must divide
the array.  x may have strided rows (the Mamba mixer passes its half of
the input projection without a copy); its channels must be contiguous.

What bounds it on an H100: KW multiply-adds per output against one read
of x and one write of y, so HBM bandwidth, 2 * B*L*D * bytes / 3.35 TB/s.
The kernel walks each channel's tokens in one thread with the last KW - 1
inputs in registers, so it reads x once, 16 bytes a thread along D.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

# Launches of the CUDA kernel since the last reset (set it to 0 to reset).
launches = 0
_fn = None

ACTS = {"none": 0, "silu": 1}
MAX_TAPS = 8                # the kernel's instances: KW = 1 .. 8
THREADS = 128               # threads per block, along D
TARGET_BLOCKS = 2048        # about 16 blocks of 128 threads per SM
MAX_RUN, MIN_RUN = 64, 8    # tokens one thread walks
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, w, bias, act):
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"x must be (B,L,D) and w (KW,D); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if act not in ACTS:
        raise ValueError(f"act {act!r}; valid: {', '.join(ACTS)}")
    if bias is not None and tuple(bias.shape) != (x.shape[2],):
        raise ValueError(f"bias must be ({x.shape[2]},), got "
                         f"{tuple(bias.shape)}")


def conv1d_causal_plain(x, w, *, bias=None, act: str = "silu"):
    """The kernel's function in plain PyTorch: ``ref.conv1d_causal``."""
    _check(x, w, bias, act)
    return ref.conv1d_causal(x, w, bias=bias, act=act)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def run_length(b: int, l: int, d: int, vec: int) -> int:
    """Tokens one thread walks: MAX_RUN, halved down to MIN_RUN while the
    grid has fewer than TARGET_BLOCKS blocks (short prompts, small
    batches), so the card stays full."""
    blocks_d = _cdiv(_cdiv(d, vec), THREADS)
    run = MAX_RUN
    while run > MIN_RUN and blocks_d * b * _cdiv(l, run) < TARGET_BLOCKS:
        run //= 2
    return run


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load("conv1d_causal").repro_conv1d_causal
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 \
            + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def conv1d_causal(x, w, *, bias=None, act: str = "silu"):
    """x: (B,L,D), w: (KW,D), bias: (D,) or None -> (B,L,D) in x's dtype.
    A CPU tensor takes ``conv1d_causal_plain``; a CUDA tensor launches the
    sm_90a kernel on the current stream or raises."""
    global launches
    _check(x, w, bias, act)
    if x.device.type == "cpu":
        return conv1d_causal_plain(x, w, bias=bias, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"conv1d_causal runs on cpu or cuda, not "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    kw = w.shape[0]
    if not 1 <= kw <= MAX_TAPS:
        raise ValueError(f"the kernel takes 1 to {MAX_TAPS} taps, got {kw}")
    for name, t in (("w", w), ("bias", bias)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype}, x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.stride(2) != 1:
        raise ValueError("x's channels must be contiguous (stride 1)")
    b, l, d = x.shape
    y = torch.empty((b, l, d), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    run = run_length(b, l, d, 16 // x.element_size())
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launches += 1
        err = fn(x.data_ptr(), w.data_ptr(),
                 None if bias is None else bias.data_ptr(), y.data_ptr(),
                 x.stride(0), x.stride(1), b, l, d, kw, run, ACTS[act],
                 _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"conv1d_causal kernel launch failed: CUDA error "
                           f"{err} (x {tuple(x.shape)}, stride "
                           f"{tuple(x.stride())}, {kw} taps, {x.dtype})")
    return y
