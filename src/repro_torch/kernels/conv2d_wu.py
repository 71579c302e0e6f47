"""K2: the weight-gradient ("update pass") convolution, paper §II-J.

Replaces ``repro/kernels/conv2d_wu.py:conv2d_wu`` (the Pallas
``_kernel_tiled``, ``pallas_call`` at :159).  It computes

    dW[r,s,c,k] = sum_{n,p,q} x[n, p*st+r-pad, q*st+s-pad, c] * dO[n,p,q,k]

from x (N,H,W,C) and dO (N,P,Q,K) to dW (R,S,C,K), accumulating in f32.

Two versions live here:

* ``conv2d_wu_plain`` repeats the kernel's arithmetic in PyTorch: pad,
  then per (r, s) one strided slice and one (pixels, C)^T x (pixels, K)
  matmul, in f32.  The CPU tests run it, and ``chip_smoke.py`` holds the
  kernel against it on the card.
* the CUDA C++ kernels of ``csrc/conv2d_wu.cu``, built for sm_90a: a
  split-K GEMM per (r, s) over the N*P*Q pixels, whose f32 partial tiles a
  second pass sums in a fixed order (deterministic, no atomics), on one of
  two routes (``route``): ``"mma"``, the f32 products on the tensor cores
  by the 3xTF32 split (each value v = hi + lo, hi = tf32(v), lo =
  tf32(v - hi); lo*hi + hi*lo + hi*hi by ``mma.sync`` m16n8k8 tf32 with
  f32 sums), for C and K multiples of 4 and 16-byte aligned operands,
  which is every ResNet-50 signature; ``"simt"``, f32 FMAs on the SIMT
  cores, for the rest.

``conv2d_wu`` takes the plain version for a CPU tensor and launches the
kernel of its route for a CUDA tensor; there is no fallback between them,
nor between the routes: a launch that fails raises.  ``launches`` counts
the wrapper's kernel launches on either route (one per call, the
reduction pass included), ``launches_mma`` those of the mma route.

K10b, the same function by the reference's legacy whole-plane strategy
(``repro/kernels/conv2d_wu.py:_conv2d_wu_whole``, ``pallas_call`` at
:200), lives here too: ``conv2d_wu_whole``, its plain version
``conv2d_wu_whole_plain`` and the kernel ``csrc/conv2d_wu_whole.cu``,
counted by ``launches_whole`` (one per call, the sum pass included).  Each
block keeps its dW tile in registers across a run of the reference's
(n, p_b) steps, b_p rows of dO at a time (b_p must divide P, as in the
reference); ``plan_whole`` cuts the step sequence into runs of whole steps
so that the grid fills the card, and a second pass sums the runs' partial
tiles in a fixed order: the same bits on every run.

What bounds it on an H100: FLOPs, 2*N*P*Q*K*C*R*S at 67 TFLOP/s f32 on
the SIMT route, for every ResNet-50 weight gradient but the 56x56 1x1
64->64 one, which moves more bytes (x + dO + dW once each, at 3.35 TB/s)
than its FLOPs take; on the mma route three TF32 products per f32 one at
the TF32 tensor-core rate (``launch/roofline.TF32_PEAK_FLOPS``), or the
bytes where those take longer.
The TPU kernel carries one dW tile across a sequential pixel sweep; on
the card blocks run in parallel, and the dW tile is small against a long
reduction, so the pixels are split across blocks (``plan``; for K10b
``plan_whole``, in runs of whole (n, p_b) steps) to give every SM work.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_direct import pad_input
from repro_torch.launch import roofline

# Launches of the CUDA kernels since the last reset (set it to 0 to reset):
# both routes, and the mma route's alone.
launches = 0
launches_mma = 0
_fn = None
_fn_mma = None
# Launches of the whole-plane kernel K10b since the last reset.
launches_whole = 0
_fn_whole = None

# C x K block tiles of csrc/conv2d_wu.cu, by the code its C function takes.
TILES = {0: (128, 128), 1: (128, 64), 2: (64, 64)}
# C x K block tiles of csrc/conv2d_wu_whole.cu; the K extent holds k_blk.
WHOLE_TILES = {0: (128, 128), 1: (128, 64), 2: (64, 128), 3: (64, 64)}
PIX_STEP = 8             # pixels per reduction step (kPix in the source)
TARGET_BLOCKS = 264      # about two blocks per SM on a 132-SM H100
MAX_CHUNK = 4096         # most pixels one thread sums in sequence
MIN_CHUNK = 256          # fewest pixels worth a block of their own
MAX_GRID_Z = 65535       # splits * R * S share the grid's z dimension
# The mma route (3xTF32 on the tensor cores): C x K block tiles by code, the
# blocks of each an SM holds at once (registers and shared memory), the
# pixels of one ring stage (a multiple of mma.sync's k of 8), and the
# fewest and most pixels one block's f32 accumulator sums.  Inside a stage
# the products of its 32 pixels add up in the tensor cores' accumulator,
# which is then added to the block's f32 sums on the SIMT cores: each
# tensor-core run holds 12 products, whatever the chunk.
MMA_TILES = {0: (128, 128), 1: (128, 64), 2: (64, 128), 3: (64, 64)}
MMA_BLOCKS_PER_SM = {0: 1, 1: 2, 2: 2, 3: 3}
MMA_PIX_STEP = 32
MMA_MIN_CHUNK = 384
MMA_MAX_CHUNK = 2048
ROUTES = ("mma", "simt")


@dataclasses.dataclass(frozen=True)
class WuPlan:
    """How the kernel cuts one weight-gradient: the block tile (code into
    ``TILES``), the number of pixel chunks and the pixels in each."""
    tile: int
    splits: int
    chunk: int
    route: str = "simt"


def plan(*, n: int, p: int, q: int, c: int, k: int, r: int, s: int,
         route: str = "simt") -> WuPlan:
    """A pure function of the shape and the route.

    SIMT route: the tile (a code into ``TILES``) is 128x128 when C and K
    are both at least 128, 128x64 when only C is, else 64x64; ``splits``
    gives the grid about ``TARGET_BLOCKS`` blocks, keeps every chunk at
    most ``MAX_CHUNK`` pixels and, where that allows, at least
    ``MIN_CHUNK``; every chunk is a multiple of ``PIX_STEP``.

    mma route (``_mma_plan``): each of C and K takes 128 when it is at
    least 128, else 64 (a code into ``MMA_TILES``); the split is the one
    whose rounds of blocks over the card (132 SMs x ``MMA_BLOCKS_PER_SM``)
    take the fewest pixel steps, with chunks of whole ``MMA_PIX_STEP``
    stages, at most ``MMA_MAX_CHUNK`` pixels and at most ceil(N*P*Q /
    ``MMA_MIN_CHUNK``) splits.

    No chunk is empty, and splits x R x S stays within ``MAX_GRID_Z``."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    m = n * p * q
    if route == "mma":
        tile = (0 if k >= 128 else 1) if c >= 128 else (2 if k >= 128 else 3)
        splits, chunk = _mma_plan(m, mma_tiles(c=c, k=k, r=r, s=s,
                                               tile=tile),
                                  roofline.SMS * MMA_BLOCKS_PER_SM[tile])
    else:
        tile = 0 if c >= 128 and k >= 128 else 1 if c >= 128 else 2
        bm, bn = TILES[tile]
        tiles = -(-c // bm) * -(-k // bn) * r * s
        splits = -(-TARGET_BLOCKS // tiles)
        splits = min(splits, -(-m // MIN_CHUNK))
        splits = max(splits, -(-m // MAX_CHUNK), 1)
        chunk = -(-m // splits)
        chunk = -(-chunk // PIX_STEP) * PIX_STEP
        splits = -(-m // chunk)
    if splits * r * s > MAX_GRID_Z:
        raise ValueError(f"{splits} splits x {r}x{s} filter taps exceed the "
                         f"grid's z limit {MAX_GRID_Z}")
    return WuPlan(tile=tile, splits=splits, chunk=chunk, route=route)


_default_plan = plan     # conv2d_wu's ``plan`` argument shadows the name


def mma_tiles(*, c: int, k: int, r: int, s: int, tile: int) -> int:
    """Output tiles of the mma route's grid under a tile code: C x K tiles
    of each filter tap."""
    bm, bn = MMA_TILES[tile]
    return -(-c // bm) * -(-k // bn) * r * s


def mma_cost(plan: WuPlan, *, n: int, p: int, q: int, c: int, k: int,
             r: int, s: int) -> float:
    """Seconds a plan takes by the first-order model ``plan`` ranks splits
    with, made comparable across tiles: its rounds of blocks over the card
    (ceil(tiles x splits / (SMS x MMA_BLOCKS_PER_SM))) times its chunk, a
    round costing the products of the blocks an SM holds (3 TF32 products
    of 2 FLOPs a pixel and output) at the SM's share of the TF32 rate; a
    split adds its partials' bytes (written, then read with dW written) at
    the HBM rate.  A ranking of plans, not a prediction of the time."""
    bm, bn = MMA_TILES[plan.tile]
    per_sm = MMA_BLOCKS_PER_SM[plan.tile]
    tiles = mma_tiles(c=c, k=k, r=r, s=s, tile=plan.tile)
    rounds = -(-tiles * plan.splits // (roofline.SMS * per_sm))
    flops = rounds * plan.chunk * per_sm * bm * bn * 6
    rate = roofline.TF32_PEAK_FLOPS / roofline.SMS
    traffic = 0 if plan.splits == 1 else \
        (2 * plan.splits + 1) * r * s * c * k * 4
    return flops / rate + traffic / roofline.HBM_BYTES_PER_S


def check_wu_plan(plan, *, n: int, p: int, q: int, c: int, k: int, r: int,
                  s: int) -> None:
    """Raises ``ValueError`` unless the mma route can run ``plan`` on this
    shape: a ``WuPlan`` of route "mma" (a plan applies to that route
    only), a tile code of ``MMA_TILES``, chunks of whole ``MMA_PIX_STEP``
    stages that cover the N*P*Q pixels and leave none empty, and splits x
    R x S within ``MAX_GRID_Z``."""
    _check_wu_plan(plan, n * p * q, r * s)


@functools.lru_cache(maxsize=2048)
def _check_wu_plan(plan, m: int, taps: int) -> None:
    if not isinstance(plan, WuPlan):
        raise ValueError(f"K2's mma route takes a WuPlan, not {plan!r}")
    if plan.route != "mma":
        raise ValueError(f"a plan applies to K2's mma route only, not "
                         f"{plan.route!r}")
    if plan.tile not in MMA_TILES:
        raise ValueError(f"tile code {plan.tile} is not one of MMA_TILES "
                         f"{sorted(MMA_TILES)}")
    if plan.chunk < MMA_PIX_STEP or plan.chunk % MMA_PIX_STEP:
        raise ValueError(f"chunk {plan.chunk}: the route sums whole stages "
                         f"of {MMA_PIX_STEP} pixels")
    if plan.splits < 1 or plan.splits * taps > MAX_GRID_Z:
        raise ValueError(f"{plan.splits} splits x {taps} filter taps: the "
                         f"grid's z dimension takes 1 to {MAX_GRID_Z}")
    if plan.splits * plan.chunk < m:
        raise ValueError(f"{plan.splits} chunks of {plan.chunk} pixels do "
                         f"not cover the {m} pixels")
    if (plan.splits - 1) * plan.chunk >= m:
        raise ValueError(f"{plan.splits} chunks of {plan.chunk} pixels leave "
                         f"the last of the {m} pixels' splits empty")


@functools.lru_cache(maxsize=256)
def _mma_plan(m: int, tiles: int, slots: int) -> tuple[int, int]:
    """(splits, chunk) of m pixels over ``tiles`` output tiles on a card
    that holds ``slots`` blocks at once: the split whose ceil(tiles x
    splits / slots) rounds times its chunk is least, the fewest splits on
    a tie (a round's blocks run side by side, so a round costs its chunk;
    a split more costs a partial tile written and summed).  Cached: the
    wrapper plans every launch."""
    lo = max(1, -(-m // MMA_MAX_CHUNK))
    hi = max(lo, -(-m // MMA_MIN_CHUNK))
    best = None
    for splits in range(lo, hi + 1):
        chunk = -(-(-(-m // splits)) // MMA_PIX_STEP) * MMA_PIX_STEP
        if -(-m // chunk) != splits:
            continue
        cost = -(-tiles * splits // slots) * chunk
        if best is None or cost < best[0]:
            best = (cost, splits, chunk)
    return best[1], best[2]


def route(x, do) -> str:
    """Which kernel a CUDA call of ``conv2d_wu(x, do, ...)`` launches, by
    channels and alignment alone: "mma" (3xTF32 on the tensor cores) when
    C and K are multiples of 4 and x and dO start on 16-byte boundaries
    (every row of 16-byte copies then lies on one), else "simt".  A
    dispatch by shape, not a fallback: each route raises on failure."""
    if (x.shape[-1] % 4 == 0 and do.shape[-1] % 4 == 0
            and x.data_ptr() % 16 == 0 and do.data_ptr() % 16 == 0):
        return "mma"
    return "simt"


def _out_hw(h, w, r, s, stride, padding):
    return ((h + 2 * padding - r) // stride + 1,
            (w + 2 * padding - s) // stride + 1)


def conv2d_wu_plain(x, do, *, stride: int = 1, padding: int = 0, filter_rs):
    """The kernel's arithmetic in plain PyTorch (f32 operands)."""
    n, h, wd, c = x.shape
    _, p, q, k = do.shape
    r, s = filter_rs
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    g = do.reshape(n * p * q, k)
    dw = torch.empty((r, s, c, k), dtype=torch.float32, device=x.device)
    for rr in range(r):
        for ss in range(s):
            xs = xp[:, rr:rr + (p - 1) * stride + 1:stride,
                    ss:ss + (q - 1) * stride + 1:stride, :]
            dw[rr, ss] = xs.reshape(n * p * q, c).t() @ g
    return dw


@dataclasses.dataclass(frozen=True)
class WholeWuPlan:
    """How K10b cuts one weight-gradient: the block tile (code into
    ``WHOLE_TILES``), the number of runs the (n, p_b) step sequence is cut
    into, the steps of each run (the last may hold fewer), the pixels of
    one run and the blocks of the first kernel's grid."""
    tile: int
    splits: int
    run: int
    pixels: int
    blocks: int


def plan_whole(*, n: int, p: int, q: int, c: int, k: int, r: int, s: int,
               b_p: int, k_blk: int) -> WholeWuPlan:
    """A pure function of the shape and the reference's blocking.  The
    N * P/b_p steps of the sweep are cut into ``splits`` contiguous runs of
    whole steps, as few as give the grid (C tiles x K/k_blk x R*S x
    splits) about ``TARGET_BLOCKS`` blocks, with splits * R * S at most
    ``MAX_GRID_Z`` and no run empty."""
    _check_wu_blocking(p, k, b_p, k_blk)
    if n < 1 or q < 1 or c < 1 or r < 1 or s < 1:
        raise ValueError(f"empty weight gradient: N={n}, Q={q}, C={c}, "
                         f"filter {r}x{s}")
    tile = whole_tile(c, k_blk)
    tiles = -(-c // WHOLE_TILES[tile][0]) * (k // k_blk) * r * s
    steps = n * (p // b_p)
    splits = max(1, min(steps, -(-TARGET_BLOCKS // tiles),
                        MAX_GRID_Z // (r * s)))
    run = -(-steps // splits)
    splits = -(-steps // run)
    return WholeWuPlan(tile=tile, splits=splits, run=run,
                       pixels=run * b_p * q, blocks=tiles * splits)


def whole_tile(c: int, k_blk: int) -> int:
    """K10b's tile code: 128 channels of C when C is at least 128, else 64;
    128 of K when k_blk exceeds 64, else 64 (k_blk itself is held)."""
    return (0 if c >= 128 else 2) + (0 if k_blk > 64 else 1)


def conv2d_wu_whole_plain(x, do, *, stride: int = 1, padding: int = 0,
                          filter_rs, b_p: int, k_blk: int):
    """K10b's arithmetic in plain PyTorch, as the reference's whole-plane
    kernel does it: pad as ``pad_input``, then for each image and each
    block of b_p rows of dO, per (r, s), dW[r,s] += (pixels, C)^T x
    (pixels, K), summed into the f32 dW in sweep order."""
    n, h, wd, c = x.shape
    _, p, q, k = do.shape
    r, s = filter_rs
    _check_wu_blocking(p, k, b_p, k_blk)
    xp = pad_input(x, padding=padding, stride=stride, rb_p=b_p, r=r, p=p)
    dw = torch.zeros((r, s, c, k), dtype=torch.float32, device=x.device)
    for nn in range(n):
        for pb in range(p // b_p):
            g = do[nn, pb * b_p:(pb + 1) * b_p].reshape(b_p * q, k)
            row0 = pb * b_p * stride
            for rr in range(r):
                for ss in range(s):
                    xs = xp[nn, row0 + rr:row0 + rr + (b_p - 1) * stride + 1:
                            stride, ss:ss + (q - 1) * stride + 1:stride, :]
                    dw[rr, ss] += xs.reshape(b_p * q, c).t() @ g
    return dw


def _check_wu_blocking(p: int, k: int, b_p: int, k_blk: int) -> None:
    """The reference's contract (``repro/kernels/conv2d_wu.py:190``): the
    whole-plane update pass needs b_p | P; k_blk must divide K."""
    if b_p < 1 or p % b_p:
        raise ValueError(f"b_p={b_p} does not divide P={p}: the whole-plane "
                         f"update pass needs b_p | P")
    if k_blk < 1 or k % k_blk:
        raise ValueError(f"k_blk={k_blk} does not divide K={k}")


def _check(x, do, stride, padding, filter_rs):
    """Shapes every path needs; returns (R, S)."""
    if x.dim() != 4 or do.dim() != 4:
        raise ValueError(f"x must be (N,H,W,C) and dO (N,P,Q,K); got "
                         f"{tuple(x.shape)} and {tuple(do.shape)}")
    if stride < 1 or padding < 0:
        raise ValueError(f"stride {stride}, padding {padding}")
    r, s = filter_rs
    if r < 1 or s < 1:
        raise ValueError(f"filter {r}x{s}")
    n, h, wd, _ = x.shape
    p, q = _out_hw(h, wd, r, s, stride, padding)
    if p < 1 or q < 1:
        raise ValueError(f"empty output plane {p}x{q}")
    if tuple(do.shape[:3]) != (n, p, q):
        raise ValueError(f"dO must be {(n, p, q)} x K for x {tuple(x.shape)}, "
                         f"a {r}x{s} filter, stride {stride} and padding "
                         f"{padding}; got {tuple(do.shape)}")
    return r, s


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load("conv2d_wu").repro_conv2d_wu_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _kernel_fn_mma():
    global _fn_mma
    if _fn_mma is None:
        fn = _build.load("conv2d_wu").repro_conv2d_wu_mma
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_mma = fn
    return _fn_mma


def conv2d_wu(x, do, *, stride: int = 1, padding: int = 0, filter_rs,
              plan: WuPlan | None = None):
    """dW (R,S,C,K) from x (N,H,W,C) and dO (N,P,Q,K).  A CPU tensor takes
    ``conv2d_wu_plain``; a CUDA tensor launches the sm_90a kernel of its
    ``route`` on the current stream or raises.

    ``plan`` (a ``WuPlan`` of route "mma", e.g. a tuned one) replaces
    ``plan(..., route="mma")``'s on the mma route; None keeps it.  A plan
    the mma route cannot run on this shape, or any plan for a call
    ``route`` sends to the SIMT route, raises ``ValueError`` on either
    device."""
    global launches, launches_mma
    r, s = _check(x, do, stride, padding, filter_rs)
    if plan is not None:
        if route(x, do) != "mma":
            raise ValueError("a plan applies to K2's mma route only; this "
                             "call takes the simt route")
        check_wu_plan(plan, n=x.shape[0], p=do.shape[1], q=do.shape[2],
                      c=x.shape[3], k=do.shape[3], r=r, s=s)
    if x.device.type == "cpu":
        return conv2d_wu_plain(x, do, stride=stride, padding=padding,
                               filter_rs=filter_rs)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_wu runs on cpu or cuda, not {x.device}")
    for name, v in (("x", x), ("dO", do)):
        if v.device != x.device:
            raise ValueError(f"{name} on {v.device}, x on {x.device}")
        if v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {v.dtype}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, h, wd, c = x.shape
    _, p, q, k = do.shape
    if n * p * q >= 2 ** 31:
        raise ValueError(f"N*P*Q = {n * p * q} pixels: the kernel indexes "
                         f"pixels in 32 bits")
    dw = torch.empty((r, s, c, k), dtype=torch.float32, device=x.device)
    if dw.numel() == 0:
        return dw
    if n == 0:
        return dw.zero_()
    path = route(x, do)
    pl = plan or _default_plan(n=n, p=p, q=q, c=c, k=k, r=r, s=s,
                               route=path)
    part = dw if pl.splits == 1 else torch.empty(
        (pl.splits, r, s, c, k), dtype=torch.float32, device=x.device)
    fn = _kernel_fn_mma() if path == "mma" else _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launches += 1
        if path == "mma":
            launches_mma += 1
        err = fn(x.data_ptr(), do.data_ptr(), part.data_ptr(), dw.data_ptr(),
                 n, h, wd, c, k, r, s, stride, padding, pl.tile, pl.splits,
                 pl.chunk, stream)
    if err != 0:
        raise RuntimeError(f"conv2d_wu kernel launch failed ({path} route): "
                           f"CUDA error {err} (x {tuple(x.shape)}, dO "
                           f"{tuple(do.shape)}, {pl})")
    return dw


def _kernel_fn_whole():
    global _fn_whole
    if _fn_whole is None:
        fn = _build.load("conv2d_wu_whole").repro_conv2d_wu_whole_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 15 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_whole = fn
    return _fn_whole


def conv2d_wu_whole(x, do, *, stride: int = 1, padding: int = 0, filter_rs,
                    b_p: int, k_blk: int):
    """K10b: dW (R,S,C,K) from x (N,H,W,C) and dO (N,P,Q,K) by the
    whole-plane strategy, with the reference's blocking (``b_p`` rows of dO
    per step, which must divide P; ``k_blk`` output channels per block).
    A CPU tensor takes ``conv2d_wu_whole_plain``; a CUDA tensor launches
    the sm_90a kernel on the current stream or raises."""
    global launches_whole
    r, s = _check(x, do, stride, padding, filter_rs)
    n, h, wd, c = x.shape
    _, p, q, k = do.shape
    _check_wu_blocking(p, k, b_p, k_blk)
    kw = dict(stride=stride, padding=padding, filter_rs=filter_rs, b_p=b_p,
              k_blk=k_blk)
    if x.device.type == "cpu":
        return conv2d_wu_whole_plain(x, do, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_wu_whole runs on cpu or cuda, not "
                         f"{x.device}")
    for name, v in (("x", x), ("dO", do)):
        if v.device != x.device:
            raise ValueError(f"{name} on {v.device}, x on {x.device}")
        if v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {v.dtype}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k_blk > 128:
        raise ValueError(f"k_blk={k_blk}: the whole-plane update pass holds "
                         f"at most 128 output channels per block")
    xp = pad_input(x, padding=padding, stride=stride, rb_p=b_p, r=r, p=p)
    hp, wp = xp.shape[1], xp.shape[2]
    if n * hp * wp >= 2 ** 31 or n * p >= 2 ** 31:
        raise ValueError(f"N*HP*WP = {n * hp * wp} padded pixels: the kernel "
                         f"indexes rows in 32 bits")
    dw = torch.empty((r, s, c, k), dtype=torch.float32, device=x.device)
    if dw.numel() == 0:
        return dw
    pl = plan_whole(n=n, p=p, q=q, c=c, k=k, r=r, s=s, b_p=b_p, k_blk=k_blk)
    part = dw if pl.splits == 1 else torch.empty(
        (pl.splits, r, s, c, k), dtype=torch.float32, device=x.device)
    fn = _kernel_fn_whole()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launches_whole += 1
        err = fn(xp.data_ptr(), do.data_ptr(), part.data_ptr(), dw.data_ptr(),
                 n, hp, wp, c, k, r, s, stride, p, q, b_p, k_blk, pl.tile,
                 pl.splits, pl.run, stream)
    if err != 0:
        raise RuntimeError(f"conv2d_wu_whole kernel launch failed: CUDA error "
                           f"{err} (x {tuple(x.shape)}, dO {tuple(do.shape)}, "
                           f"b_p {b_p}, k_blk {k_blk}, {pl})")
    return dw
