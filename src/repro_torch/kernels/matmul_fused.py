"""K6: matmul with a fused bias / residual / activation epilogue.

Replaces ``repro/kernels/matmul_fused.py:matmul_fused`` (the Pallas
``_kernel``, ``pallas_call`` at :85).  It computes
``act(a @ b + bias [+ residual])`` for a (M,K), b (K,N), bias (N,) and
residual (M,N), accumulating in f32; act is one of none, relu, gelu (the
tanh form, ``jax.nn.gelu``'s default) or silu (x * sigmoid(x)).  The output
has a's dtype (f32 or bf16).

Two versions live here:

* ``matmul_fused_plain``: the f32 matmul and the epilogue in plain
  PyTorch, in the kernel's order (bias, then residual, then act).  The CPU
  tests and the CPU path run it; ``chip_smoke.py`` holds the kernel
  against it.
* the CUDA C++ kernel ``csrc/matmul_fused.cu``, built for sm_90a.

``matmul_fused`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; there is no fallback between them.  ``launches``
counts the kernel's launches.  The kernel masks its M, N and K tails and
takes any shape: the reference's divisibility fallback in ``ops.matmul``
exists only because Pallas blocks must divide the array.

What bounds it on an H100: at the LM's projection shapes (M = 4096 tokens,
K and N of 256 to 8960) a matmul does hundreds of FLOP per byte it must
move, above the ridge in f32 and bf16, so the bound is the arithmetic
rate.  The kernel is a register-tiled SIMT f32 GEMM (the tiling of
``csrc/conv2d_direct.cu``): each thread keeps an 8x8 (or 4x4) tile of
outputs in registers and reuses every staged value 8 (or 4) times from a
double-buffered shared-memory slice of 8 k-steps.  bf16 inputs are widened
on load, so in bf16 it is far from the tensor-core bound; ``wgmma`` is
later work.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

# Launches of the CUDA kernel since the last reset (set it to 0 to reset).
launches = 0
_fn = None

ACTS = ("none", "relu", "gelu", "silu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(a, b, bias, act, residual):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a must be (M,K) and b (K,N); got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if act not in ACTS:
        raise ValueError(f"act {act!r}; valid: {', '.join(ACTS)}")
    m, n = a.shape[0], b.shape[1]
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias must be ({n},), got {tuple(bias.shape)}")
    if residual is not None and tuple(residual.shape) != (m, n):
        raise ValueError(f"residual must be {(m, n)}, got "
                         f"{tuple(residual.shape)}")


def matmul_fused_plain(a, b, *, bias=None, act: str = "none",
                       residual=None):
    """The kernel's function in plain PyTorch: f32 product, then bias,
    residual and act in f32, cast to a's dtype."""
    _check(a, b, bias, act, residual)
    return ref.matmul_fused(a, b, bias=bias, act=act, residual=residual)


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load("matmul_fused").repro_matmul_fused
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def matmul_fused(a, b, *, bias=None, act: str = "none", residual=None):
    """act(a @ b + bias [+ residual]).  a: (M,K), b: (K,N) -> (M,N) in a's
    dtype.  A CPU tensor takes ``matmul_fused_plain``; a CUDA tensor
    launches the sm_90a kernel on the current stream or raises."""
    global launches
    _check(a, b, bias, act, residual)
    if a.device.type == "cpu":
        return matmul_fused_plain(a, b, bias=bias, act=act, residual=residual)
    if a.device.type != "cuda":
        raise ValueError(f"matmul_fused runs on cpu or cuda, not {a.device}")
    if a.dtype not in _DTYPES:
        raise ValueError(f"a must be float32 or bfloat16, got {a.dtype}")
    for name, t in (("a", a), ("b", b), ("bias", bias),
                    ("residual", residual)):
        if t is None:
            continue
        if t.device != a.device:
            raise ValueError(f"{name} on {t.device}, a on {a.device}")
        if t.dtype != a.dtype:
            raise ValueError(f"{name} is {t.dtype}, a is {a.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = _kernel_fn()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        launches += 1
        err = fn(a.data_ptr(), b.data_ptr(), ptr(bias), ptr(residual),
                 out.data_ptr(), m, n, k, ACTS.index(act), _DTYPES[a.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"matmul_fused kernel launch failed: CUDA error "
                           f"{err} (a {tuple(a.shape)}, b {tuple(b.shape)}, "
                           f"{a.dtype})")
    return out
