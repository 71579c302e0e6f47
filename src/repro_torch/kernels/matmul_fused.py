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
* the CUDA C++ kernels of ``csrc/matmul_fused.cu``, built for sm_90a, one
  per route (``route``, by shape): ``"wgmma"`` for bf16 with K and N
  positive multiples of 8 and a, b 16-byte aligned (TMA needs 16-byte row
  strides and bases), a Hopper kernel on the bf16 tensor cores (TMA loads
  into a 3-stage ring of shared memory, ``wgmma`` bf16 -> f32 on two
  consumer warpgroups, b read MN-major as it lies); ``"simt"`` for f32,
  which is held to 1e-5 and so stays off TF32, and for bf16 off that rule,
  a register-tiled f32 GEMM on the SIMT cores (each thread keeps an 8x8
  or 4x4 tile of outputs and reuses every staged value 8 or 4 times).

``matmul_fused`` takes the plain version for a CPU tensor and launches the
route's kernel for a CUDA tensor; there is no fallback between them, nor
between the routes: a launch that fails raises.  ``launches`` counts the
launches of both kernels, ``launches_wgmma`` those of the wgmma route.
Both kernels mask their M, N and K tails and take any shape of their
route: the reference's divisibility fallback in ``ops.matmul`` exists
only because Pallas blocks must divide the array.

What bounds it on an H100: at the LM's projection shapes (M = 4096
tokens, K and N of 256 to 8960) a matmul does hundreds of FLOP per byte
it must move, above the ridge in f32 and bf16, so the bound is the
arithmetic rate: 989 TFLOP/s on the bf16 tensor cores, 67 TFLOP/s f32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

# Launches of the CUDA kernels since the last reset (set it to 0 to reset):
# both routes, and the wgmma route's alone.
launches = 0
launches_wgmma = 0
_fn = None
_fn_wgmma = None

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


def route(a, b) -> str:
    """Which kernel a CUDA call of ``matmul_fused(a, b)`` launches, by
    shape, dtype and alignment alone: "wgmma" for bf16 a and b with K and
    N positive multiples of 8 and both 16-byte aligned (TMA's row strides
    and bases; the output the wrapper allocates always is), else "simt".
    A dispatch by shape, not a fallback: each route raises on failure."""
    k, n = b.shape
    if (a.dtype == b.dtype == torch.bfloat16 and k > 0 and k % 8 == 0
            and n % 8 == 0 and a.data_ptr() % 16 == 0
            and b.data_ptr() % 16 == 0):
        return "wgmma"
    return "simt"


def _kernel_fn_wgmma():
    global _fn_wgmma
    if _fn_wgmma is None:
        fn = _build.load("matmul_fused").repro_matmul_fused_wgmma
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_wgmma = fn
    return _fn_wgmma


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
    launches the sm_90a kernel of its ``route`` on the current stream or
    raises."""
    global launches, launches_wgmma
    _check(a, b, bias, act, residual)
    if a.device.type == "cpu":
        return matmul_fused_plain(a, b, bias=bias, act=act, residual=residual)
    if a.device.type != "cuda":
        raise ValueError(f"matmul_fused runs on cpu or cuda, not {a.device}")
    _build.no_grad_inputs("matmul_fused (K6)", a, b, bias, residual)
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
    path = route(a, b)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        args = (a.data_ptr(), b.data_ptr(), ptr(bias), ptr(residual),
                out.data_ptr(), m, n, k, ACTS.index(act))
        if path == "wgmma":
            fn = _kernel_fn_wgmma()
            launches += 1
            launches_wgmma += 1
            err = fn(*args, stream)
        else:
            fn = _kernel_fn()
            launches += 1
            err = fn(*args, _DTYPES[a.dtype], stream)
    if err != 0:
        raise RuntimeError(f"matmul_fused kernel launch failed ({path} "
                           f"route): CUDA error {err} (a {tuple(a.shape)}, "
                           f"b {tuple(b.shape)}, {a.dtype})")
    return out
