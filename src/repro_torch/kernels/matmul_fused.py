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

Each route takes a plan (``MatmulPlan``, from the tuner's kind "matmul":
``tune.autotune_matmul``): on the wgmma route the n-width of the block's
output tile (128 or 256) and the ring's stage count (2, 3 or 4); on the
SIMT route the block's BM x BN tile (64 or 128 each).  ``plan=None`` is the
kernel's default (``default_matmul_plan``: 128 x 128 with 3 stages on
wgmma; on SIMT 128 x 128 where those tiles give every SM a block, else 64
x 64), launched exactly as before plans existed.  A plan changes only
which block computes an output, not the order of its sums, so every plan
gives the same bits.  ``check_matmul_plan`` refuses a plan the route
cannot run, on both devices.

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
import dataclasses

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
ROUTES = ("wgmma", "simt")
# the plans each route's .cu file instantiates
WGMMA_BM = 128
WGMMA_BN = (128, 256)
WGMMA_STAGES = (2, 3, 4)
SIMT_TILES = (64, 128)
SIMT_STAGES = 2            # the SIMT kernel's slices are double buffered
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """A K6 launch's plan: its ``route``, the block's ``bm`` x ``bn`` output
    tile and the stages of its ring of staged k-slices (fixed at 2 on the
    SIMT route)."""
    route: str
    bm: int
    bn: int
    stages: int


def default_matmul_plan(route_: str, m: int, n: int, *,
                        sms: int = H100_SMS) -> MatmulPlan:
    """The plan a launch takes without one: on "wgmma" 128 x 128 with 3
    stages; on "simt" 128 x 128 where those tiles give each of ``sms``
    SMs a block, else 64 x 64 (the kernel's own rule, which reads the
    card's SM count)."""
    if route_ == "wgmma":
        return MatmulPlan("wgmma", WGMMA_BM, 128, 3)
    if route_ != "simt":
        raise ValueError(f"route {route_!r}; valid: {', '.join(ROUTES)}")
    big = -(-m // 128) * -(-n // 128) >= sms
    tile = 128 if big else 64
    return MatmulPlan("simt", tile, tile, SIMT_STAGES)


def check_matmul_plan(plan, *, route_: str, m: int, n: int, k: int) -> None:
    """Raises ``ValueError`` unless ``plan`` is a ``MatmulPlan`` that the
    kernel of ``route_`` runs on an (m, k) x (k, n) product: on "wgmma" bm
    128, bn 128 or 256, 2 to 4 stages; on "simt" bm and bn 64 or 128, 2
    stages and at most 65535 row tiles."""
    if not isinstance(plan, MatmulPlan):
        raise ValueError(f"a K6 plan is a MatmulPlan, not {plan!r}")
    if plan.route != route_:
        raise ValueError(f"plan for route {plan.route!r} given to a "
                         f"{route_!r} launch")
    if route_ == "wgmma":
        ok = (plan.bm == WGMMA_BM and plan.bn in WGMMA_BN
              and plan.stages in WGMMA_STAGES)
    else:
        ok = (plan.bm in SIMT_TILES and plan.bn in SIMT_TILES
              and plan.stages == SIMT_STAGES
              and -(-m // plan.bm) <= 65535)
    if not ok:
        raise ValueError(f"K6's {route_} route cannot run {plan} on "
                         f"m={m}, n={n}, k={k}")


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
    if (a.dtype == b.dtype == torch.bfloat16
            and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0):
        return route_for(k, n, 2)
    return "simt"


def route_for(k: int, n: int, dtype_bytes: int) -> str:
    """``route`` by shape and element bytes alone, for operands on 16-byte
    boundaries (as every fresh tensor is): "wgmma" for bf16 (2 bytes) with
    K and N positive multiples of 8, else "simt"."""
    if dtype_bytes == 2 and k > 0 and k % 8 == 0 and n % 8 == 0:
        return "wgmma"
    return "simt"


def _kernel_fn_wgmma():
    global _fn_wgmma
    if _fn_wgmma is None:
        fn = _build.load("matmul_fused").repro_matmul_fused_wgmma
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_wgmma = fn
    return _fn_wgmma


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load("matmul_fused").repro_matmul_fused
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def matmul_fused(a, b, *, bias=None, act: str = "none", residual=None,
                 plan: MatmulPlan | None = None):
    """act(a @ b + bias [+ residual]).  a: (M,K), b: (K,N) -> (M,N) in a's
    dtype.  A CPU tensor takes ``matmul_fused_plain``; a CUDA tensor
    launches the sm_90a kernel of its ``route`` on the current stream or
    raises.  ``plan``: None for the kernel's default, else a
    ``MatmulPlan`` of the call's route (``check_matmul_plan`` refuses any
    other, on either device)."""
    global launches, launches_wgmma
    _check(a, b, bias, act, residual)
    if plan is not None:
        check_matmul_plan(plan, route_=route(a, b), m=a.shape[0],
                          n=b.shape[1], k=a.shape[1])
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
            err = fn(*args, *((plan.bn, plan.stages) if plan else (0, 0)),
                     stream)
        else:
            fn = _kernel_fn()
            launches += 1
            err = fn(*args, _DTYPES[a.dtype],
                     *((plan.bm, plan.bn) if plan else (0, 0)), stream)
    if err != 0:
        raise RuntimeError(f"matmul_fused kernel launch failed ({path} "
                           f"route, plan {plan}): CUDA error {err} (a "
                           f"{tuple(a.shape)}, b {tuple(b.shape)}, "
                           f"{a.dtype})")
    return out
