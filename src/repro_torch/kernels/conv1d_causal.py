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
kernel for a CUDA tensor; there is no fallback between them.  The kernel
has two routes, picked by ``route``: ``"tile"`` (``conv1d_causal_kernel_tile``)
where x's rows, w and bias start on 16-byte boundaries, a block streaming a
(run + KW - 1)-row tile through a cp.async ring in shared memory with
packed bf16 conversions and a fast SiLU (``tile_plan``); ``"thread"``, the
first kernel, for the rest (D % 8 != 0 in bf16, the one-channel instance).
``launches`` counts the kernel's launches on either route,
``launches_tile`` the tile route's.  The kernel masks the causal edge and its D
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
import dataclasses
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.launch import roofline

# Launches of the CUDA kernel since the last reset (set it to 0 to reset):
# both routes, and the tile route's alone.
launches = 0
launches_tile = 0
_fn = None
_fn_tile = None

ACTS = {"none": 0, "silu": 1}
MAX_TAPS = 8                # the kernel's instances: KW = 1 .. 8
THREADS = 128               # threads per block, along D
TARGET_BLOCKS = 2048        # about 16 blocks of 128 threads per SM
MAX_RUN, MIN_RUN = 64, 8    # tokens one thread walks
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The tile route: block widths it tries (threads along D, widest first),
# the grid it wants (blocks per SM), the rows of one ring stage and the
# stages (the kernel's kTileRows and kTileStages), and the most a halo
# may be of the rows a block reads.
TILE_THREADS = (128, 64, 32)
TILE_BLOCKS_PER_SM = 2
TILE_ROWS, TILE_STAGES = 8, 3
TILE_HALO_SHARE = 1 / 16


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


def route(x, w=None, bias=None) -> str:
    """Which kernel a CUDA call of ``conv1d_causal(x, w, bias=bias)``
    launches: "tile" for f32 or bf16 when every row of x starts on a
    16-byte boundary (D and both row strides multiples of 16 bytes, x's
    data and, where given, w's and bias's 16-byte aligned, channels
    contiguous), else "thread".  A dispatch by shape, dtype and alignment,
    not a fallback: each route raises on what it cannot take."""
    if x.dtype not in _DTYPES or x.dim() != 3:
        return "thread"
    vec = 16 // x.element_size()
    if (x.stride(2) == 1 and x.shape[2] % vec == 0
            and x.stride(0) % vec == 0 and x.stride(1) % vec == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, w, bias)
                    if t is not None)):
        return "tile"
    return "thread"


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How the tile route runs one call: ``threads`` along D a block (16
    bytes of channels each), ``run`` tokens a block, a ring of ``stages``
    x ``rows`` rows a thread in ``smem`` bytes of shared memory, and the
    grid's ``blocks``."""
    threads: int
    run: int
    rows: int
    stages: int
    smem: int
    blocks: int


@functools.lru_cache(maxsize=512)
def tile_plan(b: int, l: int, d: int, kw: int, vec: int) -> TilePlan:
    """A pure function of the shape.  The run is the fewest whole ring
    stages of rows with at least 15 (KW - 1) of them, so the KW - 1 halo
    rows are at most TILE_HALO_SHARE of the rows a block reads; the block
    is the widest of TILE_THREADS whose grid reaches TILE_BLOCKS_PER_SM
    blocks per SM, else the narrowest."""
    least = round((kw - 1) * (1 - TILE_HALO_SHARE) / TILE_HALO_SHARE)
    run = max(TILE_ROWS, -(-least // TILE_ROWS) * TILE_ROWS)
    for threads in TILE_THREADS:
        blocks = _cdiv(_cdiv(d, vec), threads) * _cdiv(l, run) * b
        if blocks >= TILE_BLOCKS_PER_SM * roofline.SMS:
            break
    return TilePlan(threads=threads, run=run, rows=TILE_ROWS,
                    stages=TILE_STAGES,
                    smem=TILE_STAGES * TILE_ROWS * threads * 16,
                    blocks=blocks)


def _kernel_fn_tile():
    global _fn_tile
    if _fn_tile is None:
        fn = _build.load("conv1d_causal").repro_conv1d_causal_tile
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 \
            + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_tile = fn
    return _fn_tile


def _launch_tile(x, w, bias, y, act):
    """K8's tile route into ``y`` (checked by ``conv1d_causal``)."""
    global launches, launches_tile
    b, l, d = x.shape
    kw = w.shape[0]
    plan = tile_plan(b, l, d, kw, 16 // x.element_size())
    fn = _kernel_fn_tile()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launches += 1
        launches_tile += 1
        err = fn(x.data_ptr(), w.data_ptr(),
                 None if bias is None else bias.data_ptr(), y.data_ptr(),
                 x.stride(0), x.stride(1), b, l, d, kw, plan.run,
                 plan.threads, ACTS[act], _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"conv1d_causal kernel launch failed (tile "
                           f"route): CUDA error {err} (x {tuple(x.shape)}, "
                           f"stride {tuple(x.stride())}, {kw} taps, "
                           f"{x.dtype}, {plan})")
    return y


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
    sm_90a kernel of ``route`` on the current stream or raises."""
    global launches
    _check(x, w, bias, act)
    if x.device.type == "cpu":
        return conv1d_causal_plain(x, w, bias=bias, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"conv1d_causal runs on cpu or cuda, not "
                         f"{x.device}")
    _build.no_grad_inputs("conv1d_causal (K8)", x, w, bias)
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
    if route(x, w, bias) == "tile":
        return _launch_tile(x, w, bias, y, act)
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
