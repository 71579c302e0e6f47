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

Its gradient, K8'.  The reference's Pallas kernel has no ``custom_vjp``:
its training step differentiates ``ref.conv1d_causal`` with XLA's
autodiff.  On the CPU autograd differentiates the plain version the same
way.  On the card, where x, w or bias requires grad under grad mode,
``conv1d_causal`` runs the forward kernel inside ``_Conv1dCausal``, a
``torch.autograd.Function`` that saves x (as given: the mixer's strided
half of its input projection, no copy), w and bias, and whose backward is
``conv1d_causal_bwd`` (``csrc/conv1d_causal_bwd.cu``): it recomputes the
pre-activation z from x, forms dz = dy * silu'(z), and writes dx, dw and
db, every sum in f32 and each output rounded once (dx in x's dtype, dw and
db in w's).  ``route_bwd`` picks its kernel by shape, dtype and
alignment: ``"tile"`` where every row of x, w, bias and dy starts on a
16-byte boundary (the forward's tile rule), a block of 32 threads along D
(16 bytes of channels each) by ``warps`` warps along L, each warp walking
its own sub-run with the x and dy rows streamed through a ``cp.async``
ring in shared memory, the warps' dw and db sums added in shared memory in
warp order (``bwd_tile_plan``); ``"vec"``, four channels a thread walking
its run from registers (D and x's strides multiples of 4, every operand
aligned to 4 elements); else ``"thread"``, one channel a thread.  The f32
partials of dw and db (a row a block and run) are summed by a second
kernel in a fixed order: no atomics, the same bits on every call.
``conv1d_causal_bwd_plain`` is the same backward in plain f32 PyTorch,
written out; the tests and ``chip_smoke.py`` hold the kernel against it.
``launches_bwd`` counts the backward's calls, ``launches_bwd_vec`` and
``launches_bwd_tile`` those on their routes.  It is bound by bytes too: a
read of x and of dy and a write of dx, 3 * B*L*D * bytes / 3.35 TB/s.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.launch import roofline

# Launches of the CUDA kernels since the last reset (set it to 0 to reset):
# the forward on both routes and on the tile route alone; the backward's
# calls on every route and on the vec and tile routes alone.
launches = 0
launches_tile = 0
launches_bwd = 0
launches_bwd_vec = 0
launches_bwd_tile = 0
_fn = None
_fn_tile = None
_fn_bwd = None
_fn_bwd_tile = None

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
# The backward: channels a thread on the vec route, and the tokens a thread
# walks, BWD_MAX_RUN halved down to BWD_MIN_RUN while the grid has fewer
# than BWD_TARGET_BLOCKS blocks of THREADS threads.
BWD_VEC = 4
BWD_MAX_RUN, BWD_MIN_RUN = 64, 16
BWD_TARGET_BLOCKS = 1024
# The backward's tile route (csrc/conv1d_causal_bwd.cu): threads along D a
# block (one warp), the rows of a ring stage and the stages (kBwdTile*),
# the least tokens a warp walks, the warps a block may have along L (most
# first) and the blocks per SM its grid should reach.  At the Jamba
# training cut's shape (bf16, KW 4: 226 registers a thread, two blocks of
# 4 warps an SM) walks of 64 tokens fill an H100 in one wave; walks of 32
# took two and 20 % more time, rings of 8 rows or 4 stages no less.
BWD_TILE_THREADS = 32
BWD_TILE_ROWS, BWD_TILE_STAGES = 4, 3
BWD_TILE_SUB = 64
BWD_TILE_WARPS = (8, 4, 2, 1)
BWD_TILE_BLOCKS_PER_SM = 1


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


def _check_cuda(x, w, bias):
    """What the CUDA kernels of both directions take: x on a CUDA device,
    f32 or bf16, channels contiguous; w and bias on its device, of its
    dtype, contiguous; 1 to MAX_TAPS taps."""
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


class _Conv1dCausal(torch.autograd.Function):
    """K8 forward with K8' as its gradient: the forward saves x (as given,
    strided rows and all), w and bias, and the backward launches
    ``conv1d_causal_bwd``, which recomputes the pre-activation.  Under
    ``cfg.remat`` the forward that ``torch.utils.checkpoint`` runs again
    saves them again."""

    @staticmethod
    def forward(ctx, x, w, bias, act):
        ctx.save_for_backward(x, w, bias)
        ctx.act = act
        return _launch_forward(x, w, bias, act)

    @staticmethod
    def backward(ctx, dy):
        x, w, bias = ctx.saved_tensors
        dx, dw, db = conv1d_causal_bwd(x, w, dy.contiguous(), bias=bias,
                                       act=ctx.act)
        return dx, dw, db, None


def conv1d_causal(x, w, *, bias=None, act: str = "silu"):
    """x: (B,L,D), w: (KW,D), bias: (D,) or None -> (B,L,D) in x's dtype.
    A CPU tensor takes ``conv1d_causal_plain`` (autograd differentiates
    it); a CUDA tensor launches the sm_90a kernel of ``route`` on the
    current stream or raises.  On the card, with grad enabled and x, w or
    bias requiring grad, the output's gradient is K8'
    (``conv1d_causal_bwd``)."""
    _check(x, w, bias, act)
    if x.device.type == "cpu":
        return conv1d_causal_plain(x, w, bias=bias, act=act)
    _check_cuda(x, w, bias)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias)):
        return _Conv1dCausal.apply(x, w, bias, act)
    return _launch_forward(x, w, bias, act)


def _launch_forward(x, w, bias, act):
    """The forward kernel of ``route`` on x's device and current stream;
    the checks are the caller's."""
    global launches
    kw = w.shape[0]
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


def conv1d_causal_bwd_plain(x, w, dy, *, bias=None, act: str = "silu"):
    """K8' in plain PyTorch: (dx, dw, db) of ``conv1d_causal`` given dy,
    written out in f32 (z recomputed as the forward sums it, dz = dy *
    silu'(z) or dy, dx[t] = sum_i w[i] dz[t + KW - 1 - i], dw[i] =
    sum_{b,t} x[t - KW + 1 + i] dz[t], db = sum_{b,t} dz[t]), each rounded
    once: dx to x's dtype, dw and db to w's; db is None without a bias."""
    _check(x, w, bias, act)
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"dy must be {tuple(x.shape)}, got "
                         f"{tuple(dy.shape)}")
    kw, l = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x.float(), (0, 0, kw - 1, 0))
    wf = w.float()
    z = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(kw):
        z = z + xp[:, i:i + l] * wf[i]
    if bias is not None:
        z = z + bias.float()
    dz = dy.float()
    if act == "silu":
        sg = torch.sigmoid(z)
        dz = dz * (sg * (1 + z * (1 - sg)))
    dzp = torch.nn.functional.pad(dz, (0, 0, 0, kw - 1))
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(kw):
        dx = dx + wf[i] * dzp[:, kw - 1 - i:kw - 1 - i + l]
    dw = torch.stack([(xp[:, i:i + l] * dz).sum(dim=(0, 1))
                      for i in range(kw)])
    db = None if bias is None else dz.sum(dim=(0, 1)).to(bias.dtype)
    return dx.to(x.dtype), dw.to(w.dtype), db


def route_bwd(x, w=None, bias=None, dy=None) -> str:
    """Which kernel a CUDA call of ``conv1d_causal_bwd`` launches: "tile"
    for f32 or bf16 when every row of x and dy starts on a 16-byte boundary
    (D and both of x's row strides multiples of 16 bytes, x's channels
    contiguous, every given operand's data 16-byte aligned: the forward's
    tile rule); else "vec" (BWD_VEC channels a thread) when D and both of
    x's row strides are multiples of BWD_VEC and every given operand's data
    is aligned to BWD_VEC elements (in f32 the tile rule takes all of
    these); else "thread" (one channel a thread: an odd D, unaligned rows).
    A pure function of shape, dtype and alignment; a dispatch, not a
    fallback: each raises on what it cannot take."""
    if x.dtype not in _DTYPES or x.dim() != 3:
        return "thread"
    vec = 16 // x.element_size()
    if (x.stride(2) == 1 and x.shape[2] % vec == 0
            and x.stride(0) % vec == 0 and x.stride(1) % vec == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, w, bias, dy)
                    if t is not None)):
        return "tile"
    align = BWD_VEC * x.element_size()
    if (x.stride(2) == 1 and x.shape[2] % BWD_VEC == 0
            and x.stride(0) % BWD_VEC == 0 and x.stride(1) % BWD_VEC == 0
            and all(t.data_ptr() % align == 0 for t in (x, w, bias, dy)
                    if t is not None)):
        return "vec"
    return "thread"


def bwd_run_length(b: int, l: int, d: int, vec: int) -> int:
    """Tokens a thread of the backward walks: BWD_MAX_RUN, halved down to
    BWD_MIN_RUN while the grid has fewer than BWD_TARGET_BLOCKS blocks, so
    the card stays full (each run adds KW - 1 halo rows and a partial)."""
    blocks_d = _cdiv(_cdiv(d, vec), THREADS)
    run = BWD_MAX_RUN
    while run > BWD_MIN_RUN and blocks_d * b * _cdiv(l, run) \
            < BWD_TARGET_BLOCKS:
        run //= 2
    return run


@dataclasses.dataclass(frozen=True)
class BwdTilePlan:
    """How the backward's tile route runs one call: blocks of ``threads``
    = BWD_TILE_THREADS along D x ``warps`` warps along L, each warp walking
    ``sub`` tokens, so a block's ``run`` is warps x sub tokens; a ring of
    ``stages`` x ``rows`` rows of x and of dy a thread; ``smem`` bytes of
    shared memory a block (the ring, or the warps' sums where larger); the
    grid's ``blocks`` and the partial's ``parts`` rows."""
    threads: int
    warps: int
    sub: int
    run: int
    rows: int
    stages: int
    smem: int
    blocks: int
    parts: int


@functools.lru_cache(maxsize=512)
def bwd_tile_plan(b: int, l: int, d: int, kw: int, vec: int) -> BwdTilePlan:
    """A pure function of the shape.  A warp walks ``sub`` tokens: the
    fewest whole ring stages of rows with at least BWD_TILE_SUB and 16 (KW
    - 1) of them, so its 3 (KW - 1) halo rows of x and dy stay under a
    tenth of what it reads.  The block takes the most of BWD_TILE_WARPS
    warps whose grid still reaches BWD_TILE_BLOCKS_PER_SM blocks per SM,
    else one: more warps a block make fewer partial rows (one a block and
    run) for the second pass to read."""
    least = max(BWD_TILE_SUB, 16 * (kw - 1))
    sub = -(-least // BWD_TILE_ROWS) * BWD_TILE_ROWS
    blocks_d = _cdiv(_cdiv(d, vec), BWD_TILE_THREADS)
    for warps in BWD_TILE_WARPS:
        blocks = blocks_d * _cdiv(l, warps * sub) * b
        if blocks >= BWD_TILE_BLOCKS_PER_SM * roofline.SMS:
            break
    threads = BWD_TILE_THREADS * warps
    ring = BWD_TILE_STAGES * BWD_TILE_ROWS * 2 * threads * 16
    sums = warps * (kw + 1) * BWD_TILE_THREADS * vec * 4
    return BwdTilePlan(threads=threads, warps=warps, sub=sub,
                       run=warps * sub, rows=BWD_TILE_ROWS,
                       stages=BWD_TILE_STAGES, smem=max(ring, sums),
                       blocks=blocks, parts=b * _cdiv(l, warps * sub))


def _kernel_fn_bwd_tile():
    global _fn_bwd_tile
    if _fn_bwd_tile is None:
        fn = _build.load("conv1d_causal_bwd").repro_conv1d_causal_bwd_tile
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2 \
            + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_bwd_tile = fn
    return _fn_bwd_tile


def _kernel_fn_bwd():
    global _fn_bwd
    if _fn_bwd is None:
        fn = _build.load("conv1d_causal_bwd").repro_conv1d_causal_bwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2 \
            + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_bwd = fn
    return _fn_bwd


def conv1d_causal_bwd(x, w, dy, *, bias=None, act: str = "silu"):
    """K8' on the card: x (B,L,D) as the forward took it, w (KW,D), bias
    (D,) or None, dy (B,L,D) contiguous -> (dx (B,L,D) in x's dtype, dw
    (KW,D) and db (D,) in w's, db None without a bias), on the current
    stream, or raises.  A CPU tensor takes ``conv1d_causal_bwd_plain``."""
    global launches_bwd, launches_bwd_vec, launches_bwd_tile
    _check(x, w, bias, act)
    if x.device.type == "cpu":
        return conv1d_causal_bwd_plain(x, w, dy, bias=bias, act=act)
    _check_cuda(x, w, bias)
    if tuple(dy.shape) != tuple(x.shape) or dy.dtype != x.dtype \
            or dy.device != x.device or not dy.is_contiguous():
        raise ValueError(f"dy must be a contiguous {tuple(x.shape)} "
                         f"{x.dtype} tensor on {x.device}, got "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    b, l, d = x.shape
    kw = w.shape[0]
    dx = torch.empty((b, l, d), dtype=x.dtype, device=x.device)
    dw = torch.empty_like(w)
    db = None if bias is None else torch.empty_like(bias)
    if dx.numel() == 0:
        dw.zero_()
        if db is not None:
            db.zero_()
        return dx, dw, db
    path = route_bwd(x, w, bias, dy)
    if path == "tile":
        plan = bwd_tile_plan(b, l, d, kw, 16 // x.element_size())
        parts = plan.parts
    else:
        run = bwd_run_length(b, l, d, BWD_VEC if path == "vec" else 1)
        parts = b * _cdiv(l, run)
    part = torch.empty((parts, kw + 1, d), dtype=torch.float32,
                       device=x.device)
    args = (x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), dw.data_ptr(),
            None if db is None else db.data_ptr(), part.data_ptr(),
            x.stride(0), x.stride(1), b, l, d, kw)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if path == "tile":
            fn = _kernel_fn_bwd_tile()
            launches_bwd += 1
            launches_bwd_tile += 1
            err = fn(*args, plan.sub, plan.warps, ACTS[act],
                     _DTYPES[x.dtype], stream)
        else:
            fn = _kernel_fn_bwd()
            launches_bwd += 1
            launches_bwd_vec += int(path == "vec")
            err = fn(*args, run, ACTS[act], int(path == "vec"),
                     _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"conv1d_causal_bwd kernel launch failed ({path} "
                           f"route): CUDA error {err} (x {tuple(x.shape)}, "
                           f"stride {tuple(x.stride())}, {kw} taps, "
                           f"{x.dtype})")
    return dx, dw, db
