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
* the CUDA C++ kernel ``csrc/conv2d_wu.cu``, built for sm_90a: a split-K
  GEMM per (r, s) over the N*P*Q pixels, whose f32 partial tiles a second
  pass sums in a fixed order (deterministic, no atomics).

``conv2d_wu`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; there is no fallback between them.  ``launches``
counts the wrapper's kernel launches (one per call, the reduction pass
included).

K10b, the same function by the reference's legacy whole-plane strategy
(``repro/kernels/conv2d_wu.py:_conv2d_wu_whole``, ``pallas_call`` at
:200), lives here too: ``conv2d_wu_whole``, its plain version
``conv2d_wu_whole_plain`` and the kernel ``csrc/conv2d_wu_whole.cu``,
counted by ``launches_whole``.  Each block keeps its dW tile in registers
across the whole (n, p_b) sweep, b_p rows of dO at a time (b_p must divide
P, as in the reference): no pixel split, no second pass, the same bits on
every run.

What bounds it on an H100: FLOPs, 2*N*P*Q*K*C*R*S at 67 TFLOP/s f32, for
every ResNet-50 weight gradient but the 56x56 1x1 64->64 one, which moves
more bytes (x + dO + dW once each, at 3.35 TB/s) than its FLOPs take.
The TPU kernel carries one dW tile across a sequential pixel sweep; on
the card blocks run in parallel, and the dW tile is small against a long
reduction, so the pixels are split across blocks (``plan``) to give every
SM work.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_direct import pad_input

# Launches of the CUDA kernel since the last reset (set it to 0 to reset).
launches = 0
_fn = None
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


@dataclasses.dataclass(frozen=True)
class WuPlan:
    """How the kernel cuts one weight-gradient: the block tile (code into
    ``TILES``), the number of pixel chunks and the pixels in each."""
    tile: int
    splits: int
    chunk: int


def plan(*, n: int, p: int, q: int, c: int, k: int, r: int, s: int) -> WuPlan:
    """A pure function of the shape.  The tile is 128x128 when C and K are
    both at least 128, 128x64 when only C is, else 64x64.  ``splits`` gives
    the grid about ``TARGET_BLOCKS`` blocks, keeps every chunk at most
    ``MAX_CHUNK`` pixels and, where that allows, at least ``MIN_CHUNK``;
    every chunk is a multiple of ``PIX_STEP`` and none is empty."""
    m = n * p * q
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
    return WuPlan(tile=tile, splits=splits, chunk=chunk)


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


def conv2d_wu(x, do, *, stride: int = 1, padding: int = 0, filter_rs):
    """dW (R,S,C,K) from x (N,H,W,C) and dO (N,P,Q,K).  A CPU tensor takes
    ``conv2d_wu_plain``; a CUDA tensor launches the sm_90a kernel on the
    current stream or raises."""
    global launches
    r, s = _check(x, do, stride, padding, filter_rs)
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
    pl = plan(n=n, p=p, q=q, c=c, k=k, r=r, s=s)
    part = dw if pl.splits == 1 else torch.empty(
        (pl.splits, r, s, c, k), dtype=torch.float32, device=x.device)
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launches += 1
        err = fn(x.data_ptr(), do.data_ptr(), part.data_ptr(), dw.data_ptr(),
                 n, h, wd, c, k, r, s, stride, padding, pl.tile, pl.splits,
                 pl.chunk, stream)
    if err != 0:
        raise RuntimeError(f"conv2d_wu kernel launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)}, dO {tuple(do.shape)}, "
                           f"{pl})")
    return dw


def _kernel_fn_whole():
    global _fn_whole
    if _fn_whole is None:
        fn = _build.load("conv2d_wu_whole").repro_conv2d_wu_whole_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 \
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
    tile = whole_tile(c, k_blk)
    fn = _kernel_fn_whole()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launches_whole += 1
        err = fn(xp.data_ptr(), do.data_ptr(), dw.data_ptr(), n, hp, wp, c, k,
                 r, s, stride, p, q, b_p, k_blk, tile, stream)
    if err != 0:
        raise RuntimeError(f"conv2d_wu_whole kernel launch failed: CUDA error "
                           f"{err} (x {tuple(x.shape)}, dO {tuple(do.shape)}, "
                           f"b_p {b_p}, k_blk {k_blk}, tile {tile})")
    return dw
