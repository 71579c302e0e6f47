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
* the CUDA C++ kernels of ``csrc/conv2d_direct.cu``, built for sm_90a: an
  implicit GEMM over the N*P*Q output pixels, on one of two routes
  (``route``): ``"mma"``, the f32 products on the tensor cores by the
  3xTF32 split of ``csrc/conv_tf32.cuh`` (each value v = hi + lo, hi =
  tf32(v), lo = tf32(v - hi); lo*hi + hi*lo + hi*hi by ``mma.sync``
  m16n8k8 tf32, each 32-channel stage summed in a zeroed run accumulator
  that then joins f32 sums), for C and K multiples of 4 and 16-byte
  aligned operands, which is every lane-aligned conv and every dual
  sub-filter; ``"simt"``, f32 FMAs on the SIMT cores, for the rest.
  ``mma_plan`` picks the mma route's block tile and, where no tile gives
  every SM a block, a split of the (r, s, c) reduction whose f32 partials
  a second pass sums in a fixed order before the epilogue.

``conv2d_direct`` takes the plain version for a CPU tensor and launches the
kernel of its route for a CUDA tensor; there is no fallback between them,
nor between the routes.  ``launches`` counts the kernel's launches on
either route (one per call, a split's sum pass included), ``launches_mma``
those of the mma route.

K10a, the same function by the reference's legacy whole-plane strategy
(``repro/kernels/conv2d_direct.py:_conv2d_whole_plane``, ``pallas_call`` at
:338), lives here too: ``conv2d_direct_whole`` and its plain version
``conv2d_direct_whole_plain``, over the padded plane ``pad_input`` makes,
with the kernels of ``csrc/conv2d_direct_whole.cu``, counted by
``launches_whole`` (either route) and ``launches_whole_mma``.  One block
computes one output block, an image, k_blk channels and rb_p rows by the
full row Q (or, where ``whole_split`` takes it, a slice of its rows), and
runs over all of C itself.  The TPU keeps the plane resident in VMEM; on
the card the plane stays in L2 (a ResNet-50 plane is at most 3.4 MB of its
50 MB), and the block stages the input rows it reads, slice by slice of C,
in shared memory.  Its routes follow ``route_whole``: 3xTF32 on the tensor
cores (32-channel slices, ``whole_mma_plan``) or f32 SIMT (8-channel
slices, ``whole_plan``).

What bounds it on an H100: at ResNet-50's batch-16 shapes nearly every conv
does more than 20 FLOP per byte it must move, so operations: on the SIMT
route 67 TFLOP/s of f32 FMA; on the mma route three TF32 products per f32
one at the TF32 tensor-core rate (``launch/roofline.TF32_PEAK_FLOPS``), or
the bytes where those take longer.  The SIMT route answers with the
paper's register blocking (an 8x8, 8x4 or 4x4 tile of outputs a thread,
from a double-buffered slice of one (r, s) and 8 input channels); the mma
route with m16n8k8 tensor-core tiles fed from a ring of 32-channel stages.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.launch import roofline

# Launches of the CUDA kernels since the last reset (set it to 0 to reset):
# both routes, and the mma route's alone.
launches = 0
launches_mma = 0
_fn = None
_fn_mma = None
# Launches of the whole-plane kernel K10a since the last reset: both routes,
# and the mma route's alone.
launches_whole = 0
launches_whole_mma = 0
_fn_whole = None
_fn_whole_mma = None

SMEM_LIMIT = 232448         # bytes of shared memory one block may claim (H100)
WHOLE_THREADS = 256         # threads per block of the whole-plane kernels
WHOLE_BN = (32, 64, 128)    # output channels a block holds: k_blk rounded up
WHOLE_TM = (4, 8, 12)       # output pixels per thread in one pass
WHOLE_TN = 8                # output channels per thread
ROUTES = ("mma", "simt")
# K1's mma route: pixels x output channels block tiles by code, the blocks
# of each an SM holds at once (registers and shared memory), the input
# channels of one ring stage, and the fewest stages a split's chunk holds.
MMA_TILES = {0: (128, 128), 1: (128, 64), 2: (64, 128), 3: (64, 64)}
MMA_BLOCKS_PER_SM = {0: 1, 1: 2, 2: 2, 3: 3}
MMA_STAGE_C = 32
MMA_MIN_CHUNK = 8
MAX_GRID_Z = 65535          # splits share the grid's z dimension
# K10a's mma route: output pixels of a pass at most (4 warps x 32), floats
# of a staged band pixel (32 channels + 4) and past a staged weight row of
# BN, and the ring stages of weights and of the band.
WHOLE_MMA_PASS = 128
WHOLE_MMA_PIXEL_FLOATS = 36
WHOLE_MMA_WPAD = 8
WHOLE_MMA_WSTAGES = 3
WHOLE_MMA_BSTAGES = 2

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


def route(x, w) -> str:
    """Which kernel a CUDA call of ``conv2d_direct(x, w, ...)`` launches, by
    channels and alignment alone: "mma" (3xTF32 on the tensor cores) when
    C and K are multiples of 4 and x and w start on 16-byte boundaries
    (every 4-channel group of a pixel row or weight row then lies on one),
    else "simt".  A dispatch by shape, not a fallback: each route raises on
    failure."""
    if (x.shape[-1] % 4 == 0 and w.shape[-1] % 4 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "mma"
    return "simt"


@dataclasses.dataclass(frozen=True)
class MmaPlan:
    """How the mma route cuts one conv: the block tile (code into
    ``MMA_TILES``), the number of blocks sharing each tile's reduction
    steps (one step: one (r, s) and ``MMA_STAGE_C`` input channels), the
    steps of each, and the blocks of the grid."""
    tile: int
    splits: int
    chunk: int
    blocks: int


def mma_plan(*, n: int, p: int, q: int, c: int, k: int, r: int,
             s: int) -> MmaPlan:
    """A pure function of the shape: the block tile and the split of the
    R*S*ceil(C/32) reduction steps across blocks (chunks of at least
    ``MMA_MIN_CHUNK`` whole steps, none empty; their f32 partials a second
    pass sums in split order) whose estimated time is least
    (``_mma_cost``); on a tie the fewer splits, then the larger tile."""
    return _mma_plan(n * p * q, k, mma_steps(c=c, r=r, s=s))


def _mma_cost(m: int, k: int, tile: int, splits: int, chunk: int) -> float:
    """Seconds a plan takes by a first-order model of the card: the SM that
    runs the most blocks (ceil(blocks / SMs)) does their products at its
    share of the TF32 rate, 3 x 2 x 32 FLOPs a pixel, channel and step, at
    half that share while it holds fewer than 8 warps (one 64x64 block);
    a split adds its partials' bytes (written, read, and the output) at the
    HBM rate.  Not a prediction of the kernel's time: a ranking of plans
    with the waste of a partial round in it."""
    bm, bn = MMA_TILES[tile]
    blocks = -(-m // bm) * -(-k // bn) * splits
    busiest = -(-blocks // roofline.SMS)
    warps = min(busiest, MMA_BLOCKS_PER_SM[tile]) * (bm * bn // 2048)
    flops = busiest * bm * bn * chunk * MMA_STAGE_C * 6
    rate = roofline.TF32_PEAK_FLOPS / roofline.SMS * min(1.0, warps / 8)
    traffic = 0 if splits == 1 else (2 * splits + 1) * m * k * 4
    return flops / rate + traffic / roofline.HBM_BYTES_PER_S


def mma_steps(*, c: int, r: int, s: int) -> int:
    """The mma route's reduction steps: one (r, s) and ``MMA_STAGE_C``
    input channels each."""
    return r * s * -(-c // MMA_STAGE_C)


def make_mma_plan(*, n: int, p: int, q: int, k: int, tile: int,
                  splits: int, chunk: int) -> MmaPlan:
    """The plan of a tile and a split, with its grid's blocks."""
    bm, bn = MMA_TILES[tile]
    return MmaPlan(tile=tile, splits=splits, chunk=chunk,
                   blocks=-(-(n * p * q) // bm) * -(-k // bn) * splits)


def check_mma_plan(plan, *, n: int, p: int, q: int, c: int, k: int, r: int,
                   s: int) -> None:
    """Raises ``ValueError`` unless the mma route can run ``plan`` on this
    shape: a tile code of ``MMA_TILES``, 1 to ``MAX_GRID_Z`` splits whose
    chunks of whole steps cover the reduction and leave none empty, and
    the grid's blocks counted right."""
    _check_mma_plan(plan, n * p * q, k, mma_steps(c=c, r=r, s=s))


@functools.lru_cache(maxsize=2048)
def _check_mma_plan(plan, m: int, k: int, steps: int) -> None:
    if not isinstance(plan, MmaPlan):
        raise ValueError(f"K1's mma route takes an MmaPlan, not {plan!r}")
    if plan.tile not in MMA_TILES:
        raise ValueError(f"tile code {plan.tile} is not one of MMA_TILES "
                         f"{sorted(MMA_TILES)}")
    if not 1 <= plan.splits <= MAX_GRID_Z:
        raise ValueError(f"{plan.splits} splits: the route takes 1 to "
                         f"{MAX_GRID_Z}")
    if plan.chunk < 1 or plan.splits * plan.chunk < steps:
        raise ValueError(f"{plan.splits} chunks of {plan.chunk} steps do not "
                         f"cover the {steps} reduction steps")
    if (plan.splits - 1) * plan.chunk >= steps:
        raise ValueError(f"{plan.splits} chunks of {plan.chunk} steps leave "
                         f"the last of the {steps} steps' splits empty")
    bm, bn = MMA_TILES[plan.tile]
    blocks = -(-m // bm) * -(-k // bn) * plan.splits
    if plan.blocks != blocks:
        raise ValueError(f"plan says {plan.blocks} blocks, its tile and "
                         f"splits make {blocks}")


@functools.lru_cache(maxsize=512)
def _mma_plan(m: int, k: int, steps: int) -> MmaPlan:
    most = min(max(1, steps // MMA_MIN_CHUNK), MAX_GRID_Z)
    best = None
    for code in MMA_TILES:
        bm, bn = MMA_TILES[code]
        for splits in range(1, most + 1):
            chunk = -(-steps // splits)
            if -(-steps // chunk) != splits:
                continue
            key = (_mma_cost(m, k, code, splits, chunk), splits, code)
            if best is None or key < best[0]:
                best = (key, MmaPlan(
                    tile=code, splits=splits, chunk=chunk,
                    blocks=-(-m // bm) * -(-k // bn) * splits))
    return best[1]


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


def pad_input(x, *, padding: int, stride: int, rb_p: int, r: int, p: int):
    """The reference's ``pad_input`` for the whole-plane kernels: x
    (N,H,W,C) padded by ``padding`` on every side but the bottom, which
    gets exactly the rows the ceil-div grid's last rb_p-row block reads
    (for stride > 1 often fewer than ``padding``)."""
    h = x.shape[1]
    rows_needed = (-(-p // rb_p) * rb_p - 1) * stride + r
    pad_bottom = max(rows_needed - (h + padding), 0)
    return F.pad(x, (0, 0, padding, padding, padding, pad_bottom))


@dataclasses.dataclass(frozen=True)
class WholePlan:
    """How a whole-plane kernel (K10a, K10c) runs one conv: ``bn`` output
    channels per block (k_blk rounded up to an instance of the source),
    ``tm`` output pixels per thread, ``rows_pass`` output rows per pass
    over C (the whole block when its rb_p x Q pixels fit the threads' tiles,
    else as many rows as do), and the dynamic shared memory of the two
    staging buffers."""
    bn: int
    tm: int
    rows_pass: int
    smem: int


def whole_plan(*, p: int, q: int, k_blk: int, rb_p: int, r: int, s: int,
               stride: int, wp: int, slice_bytes: int) -> WholePlan:
    """A pure function of the shape.  ``slice_bytes`` is what one staged
    slice of C holds per input pixel and per (tap, output channel) pair:
    8 f32 channels (K10a) or 32 int8 channels (K10c), 32 bytes either way.
    Raises ``ValueError`` when a row of Q pixels exceeds the threads'
    tiles or the two buffers exceed ``SMEM_LIMIT``."""
    bn = next((b for b in WHOLE_BN if b >= k_blk), None)
    if bn is None or k_blk % WHOLE_TN:
        raise ValueError(f"k_blk {k_blk}: the whole-plane kernels take "
                         f"multiples of {WHOLE_TN} up to {WHOLE_BN[-1]}")
    slots = WHOLE_THREADS // (bn // WHOLE_TN)   # thread rows along pixels
    rows = min(rb_p, p)
    tm = next((t for t in WHOLE_TM if slots * t >= rows * q), None)
    if tm is None:
        tm = WHOLE_TM[-1]
        rows = slots * tm // q
        if rows == 0:
            raise ValueError(f"a row of Q={q} pixels exceeds the "
                             f"{slots * tm} a block's threads hold")
    band = ((rows - 1) * stride + r) * wp * slice_bytes
    smem = 2 * (band + r * s * bn * slice_bytes)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the whole-plane staging needs {smem} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    return WholePlan(bn=bn, tm=tm, rows_pass=rows, smem=smem)


def route_whole(x, w) -> str:
    """Which kernel a CUDA call of ``conv2d_direct_whole(x, w, ...)``
    launches, by the rule of ``route``: "mma" when C and K are multiples of
    4 and x and w start on 16-byte boundaries, else "simt".  The wrapper
    raises on a C off the multiples of 8 before either route."""
    return route(x, w)


@dataclasses.dataclass(frozen=True)
class WholeMmaPlan:
    """How K10a's mma route runs one conv: ``bn`` output channels per block
    (k_blk rounded up as ``whole_plan`` does), ``rows_cta`` rows of a
    reference block per block (rb_p itself when unsplit), passes over C of
    ``rows_pass`` rows by ``cols`` output columns (the full row Q when Q <=
    WHOLE_MMA_PASS), the ``band_rows`` x ``band_cols`` window of the padded
    plane a pass's band takes, and the dynamic shared memory of the band
    and weight rings."""
    bn: int
    rows_cta: int
    rows_pass: int
    cols: int
    band_rows: int
    band_cols: int
    smem: int


def whole_mma_plan(*, p: int, q: int, k_blk: int, rb_p: int, r: int, s: int,
                   stride: int, rows_cta: int) -> WholeMmaPlan:
    """A pure function of the shape.  A pass takes as many whole rows of
    the block's ``rows_cta`` as fit WHOLE_MMA_PASS pixels and the shared
    memory; a Q over WHOLE_MMA_PASS goes in row segments of WHOLE_MMA_PASS
    columns, halved while one row's band exceeds the shared memory.
    Raises ``ValueError`` for a k_blk off the multiples of 8 up to 128, or
    when the band of one output pixel exceeds ``SMEM_LIMIT``."""
    bn = next((b for b in WHOLE_BN if b >= k_blk), None)
    if bn is None or k_blk % WHOLE_TN:
        raise ValueError(f"k_blk {k_blk}: the whole-plane kernels take "
                         f"multiples of {WHOLE_TN} up to {WHOLE_BN[-1]}")
    rows_cta = max(1, min(rows_cta, rb_p, p))

    def smem(rows, cols):
        band = ((rows - 1) * stride + r) * ((cols - 1) * stride + s)
        return 4 * (WHOLE_MMA_WSTAGES * MMA_STAGE_C * (bn + WHOLE_MMA_WPAD)
                    + WHOLE_MMA_BSTAGES * band * WHOLE_MMA_PIXEL_FLOATS)
    cols = min(q, WHOLE_MMA_PASS)
    rows = min(rows_cta, WHOLE_MMA_PASS // cols)
    while rows > 1 and smem(rows, cols) > SMEM_LIMIT:
        rows -= 1
    while cols > 1 and smem(rows, cols) > SMEM_LIMIT:
        cols = -(-cols // 2)
    if smem(rows, cols) > SMEM_LIMIT:
        raise ValueError(f"the whole-plane mma staging needs "
                         f"{smem(rows, cols)} bytes of shared memory, more "
                         f"than {SMEM_LIMIT}")
    return WholeMmaPlan(bn=bn, rows_cta=rows_cta, rows_pass=rows, cols=cols,
                        band_rows=(rows - 1) * stride + r,
                        band_cols=(cols - 1) * stride + s,
                        smem=smem(rows, cols))


def whole_slices(*, n: int, p: int, k: int, rb_p: int, k_blk: int) -> int:
    """Row slices per reference block that fill the card's SMs: the fewest
    whose CTAs (blocks x slices) reach ``roofline.SMS``, at most one row a
    slice.  1 when the reference's grid fills the card already."""
    rows = min(rb_p, p)
    blocks = n * (k // k_blk) * -(-p // rows)
    slices = min(rows, -(-roofline.SMS // blocks))
    return -(-rows // -(-rows // slices))


def whole_split(*, n: int, p: int, q: int, k: int, rb_p: int,
                k_blk: int) -> bool:
    """Whether K10a's mma route cuts each reference block's rows into
    ``whole_slices`` slices, one block each (each pixel's sum stays in one
    block, in the same order: the cut changes no bit).  Only where the
    reference block takes more than one pass of WHOLE_MMA_PASS pixels and
    its grid fills at most half the card's SMs: on an H100 the cut then ran
    2.5x faster (the 14x14 signatures with 10-row blocks at batch 16: 64
    blocks of a 126- and a 14-pixel pass), and lost or drew everywhere
    else (``chip_smoke.py`` phase 22; phase 26 times the training step
    both ways)."""
    rows = min(rb_p, p)
    blocks = n * (k // k_blk) * -(-p // rows)
    return rows * q > WHOLE_MMA_PASS and 2 * blocks <= roofline.SMS


def whole_rows_cta(*, n: int, p: int, q: int, k: int, rb_p: int,
                   k_blk: int) -> int:
    """The rows of a reference block one block of K10a's mma route takes."""
    rows = min(rb_p, p)
    if not whole_split(n=n, p=p, q=q, k=k, rb_p=rb_p, k_blk=k_blk):
        return rows
    return -(-rows // whole_slices(n=n, p=p, k=k, rb_p=rb_p, k_blk=k_blk))


def conv2d_direct_whole_plain(x, w, *, stride: int = 1, padding: int = 0,
                              bias=None, scale=None, shift=None,
                              residual=None, relu: bool = False, rb_p: int,
                              k_blk: int):
    """K10a's arithmetic in plain PyTorch, as the reference's whole-plane
    kernel does it: pad as ``pad_input``, then for each block of rb_p rows
    and the full row Q one (pixels, C) x (C, K) matmul per (r, s), summed
    in f32 (each output column is its own k_blk block's), rows past P
    dropped, then the epilogue in the reference's order."""
    h, wd = x.shape[1:3]
    r, s, _, k = w.shape
    p, q = _out_hw(h, wd, r, s, stride, padding)
    _check_whole_blocking(k, rb_p, k_blk)
    rb_p = min(rb_p, p)
    fuse = FuseSpec(bias=bias is not None, bn=scale is not None,
                    residual=residual is not None, relu=relu)
    xp = pad_input(x, padding=padding, stride=stride, rb_p=rb_p, r=r, p=p)
    out = whole_plane_products(xp, w, rb_p=rb_p, p=p, q=q,
                               stride=stride).contiguous()
    return _epilogue(out, fuse, bias, scale, shift, residual)


def whole_plane_products(xp, w, *, rb_p: int, p: int, q: int, stride: int):
    """The whole-plane kernels' products over the padded plane ``xp``: for
    each block of rb_p rows and the full row Q, one (pixels, C) x (C, K)
    matmul per (r, s), summed in the dtype of ``xp`` and ``w``; the rows
    the last block computes past P are dropped.  -> (N, P, Q, K)."""
    n, c = xp.shape[0], xp.shape[3]
    r, s, _, k = w.shape
    blocks = []
    for pb in range(-(-p // rb_p)):
        row0 = pb * rb_p * stride
        acc = torch.zeros((n * rb_p * q, k), dtype=xp.dtype, device=xp.device)
        for rr in range(r):
            for ss in range(s):
                xs = xp[:, row0 + rr:row0 + rr + (rb_p - 1) * stride + 1:stride,
                        ss:ss + (q - 1) * stride + 1:stride, :]
                acc += xs.reshape(n * rb_p * q, c) @ w[rr, ss]
        blocks.append(acc.reshape(n, rb_p, q, k))
    return torch.cat(blocks, dim=1)[:, :p]


def _check_whole_blocking(k: int, rb_p: int, k_blk: int) -> None:
    if rb_p < 1 or k_blk < 1 or k % k_blk:
        raise ValueError(f"whole-plane blocking rb_p {rb_p}, k_blk {k_blk} "
                         f"for K={k}: k_blk must divide K")


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
                  scale=None, shift=None, residual=None, relu: bool = False,
                  plan: MmaPlan | None = None):
    """Direct conv fwd + fused epilogue.  x: (N,H,W,C), w: (R,S,C,K) ->
    (N,P,Q,K).  A CPU tensor takes ``conv2d_direct_plain``; a CUDA tensor
    launches the sm_90a kernel on the current stream or raises.

    ``plan`` (an ``MmaPlan``, e.g. a tuned one) replaces ``mma_plan``'s on
    the mma route; None keeps ``mma_plan``'s.  A plan the mma route cannot
    run on this shape, or any plan for a call ``route`` sends to the SIMT
    route, raises ``ValueError`` on either device."""
    global launches
    p, q = _check(x, w, bias, scale, shift, residual, stride, padding)
    if plan is not None:
        if route(x, w) != "mma":
            raise ValueError("a plan applies to K1's mma route only; this "
                             "call takes the simt route")
        check_mma_plan(plan, n=x.shape[0], p=p, q=q, c=x.shape[3],
                       k=w.shape[3], r=w.shape[0], s=w.shape[1])
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
    if route(x, w) == "mma":
        return _launch_mma(x, w, out, scale, shift, bias, residual, relu,
                           stride, padding, plan)
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


def _kernel_fn_mma():
    global _fn_mma
    if _fn_mma is None:
        fn = _build.load("conv2d_direct").repro_conv2d_direct_mma
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 13 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_mma = fn
    return _fn_mma


def _launch_mma(x, w, out, scale, shift, bias, residual, relu, stride,
                padding, plan=None):
    """The mma route's launch into ``out`` (checked by ``conv2d_direct``),
    with ``mma_plan``'s plan unless ``plan`` gives another."""
    global launches, launches_mma
    n, h, wd, c = x.shape
    r, s, _, k = w.shape
    _, p, q, _ = out.shape
    pl = plan or mma_plan(n=n, p=p, q=q, c=c, k=k, r=r, s=s)
    residual = _aligned(residual)
    part = None if pl.splits == 1 else torch.empty(
        (pl.splits, n * p * q, k), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = _kernel_fn_mma()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launches += 1
        launches_mma += 1
        err = fn(x.data_ptr(), w.data_ptr(), ptr(scale), ptr(shift),
                 ptr(bias), ptr(residual), out.data_ptr(), ptr(part), n, h,
                 wd, c, k, r, s, stride, padding, int(relu), pl.tile,
                 pl.splits, pl.chunk, stream)
    if err != 0:
        raise RuntimeError(f"conv2d_direct kernel launch failed (mma route): "
                           f"CUDA error {err} (x {tuple(x.shape)}, w "
                           f"{tuple(w.shape)}, {pl})")
    return out


def _kernel_fn_whole():
    global _fn_whole
    if _fn_whole is None:
        fn = _build.load("conv2d_direct_whole").repro_conv2d_direct_whole_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 17 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_whole = fn
    return _fn_whole


def _aligned(t):
    """``t`` itself when its data is 16-byte aligned, else an aligned copy
    (the kernels read 16 bytes at a time)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def conv2d_direct_whole(x, w, *, stride: int = 1, padding: int = 0,
                        bias=None, scale=None, shift=None, residual=None,
                        relu: bool = False, rb_p: int, k_blk: int):
    """K10a: direct conv fwd + fused epilogue by the whole-plane strategy,
    with the reference's blocking (``rb_p`` output rows by the full row Q,
    ``k_blk`` output channels per block).  x: (N,H,W,C), w: (R,S,C,K) ->
    (N,P,Q,K).  A CPU tensor takes ``conv2d_direct_whole_plain``; a CUDA
    tensor launches the sm_90a kernel on the current stream or raises."""
    global launches_whole
    p, q = _check(x, w, bias, scale, shift, residual, stride, padding)
    k = w.shape[3]
    _check_whole_blocking(k, rb_p, k_blk)
    kw = dict(stride=stride, padding=padding, bias=bias, scale=scale,
              shift=shift, residual=residual, relu=relu)
    if x.device.type == "cpu":
        return conv2d_direct_whole_plain(x, w, rb_p=rb_p, k_blk=k_blk, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_direct_whole runs on cpu or cuda, not "
                         f"{x.device}")
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
    r, s = w.shape[:2]
    if c % 8:
        raise ValueError(f"C={c}: the whole-plane kernel stages 8 input "
                         f"channels at a time")
    rb_p = min(rb_p, p)
    xp = pad_input(x, padding=padding, stride=stride, rb_p=rb_p, r=r, p=p)
    if route_whole(x, w) == "mma":
        rows = whole_rows_cta(n=n, p=p, q=q, k=k, rb_p=rb_p, k_blk=k_blk)
        return _launch_whole_mma(xp, w, p=p, q=q, rb_p=rb_p, k_blk=k_blk,
                                 rows_cta=rows, scale=scale, shift=shift,
                                 bias=bias, residual=residual, relu=relu,
                                 stride=stride)
    hp, wp = xp.shape[1], xp.shape[2]
    plan = whole_plan(p=p, q=q, k_blk=k_blk, rb_p=rb_p, r=r, s=s,
                      stride=stride, wp=wp, slice_bytes=32)
    out = torch.empty((n, p, q, k), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    w, residual = _aligned(w), _aligned(residual)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = _kernel_fn_whole()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launches_whole += 1
        err = fn(xp.data_ptr(), w.data_ptr(), ptr(scale), ptr(shift),
                 ptr(bias), ptr(residual), out.data_ptr(), n, hp, wp, c, k,
                 r, s, stride, p, q, rb_p, k_blk, plan.rows_pass, plan.bn,
                 plan.tm, plan.smem, int(relu), stream)
    if err != 0:
        raise RuntimeError(f"conv2d_direct_whole kernel launch failed: CUDA "
                           f"error {err} (x {tuple(x.shape)}, w "
                           f"{tuple(w.shape)}, {plan})")
    return out


def _kernel_fn_whole_mma():
    global _fn_whole_mma
    if _fn_whole_mma is None:
        fn = _build.load("conv2d_direct_whole").repro_conv2d_direct_whole_mma
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 20 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_whole_mma = fn
    return _fn_whole_mma


def _launch_whole_mma(xp, w, *, p, q, rb_p, k_blk, rows_cta, scale, shift,
                      bias, residual, relu, stride):
    """K10a's mma route on the padded plane ``xp`` (checked and padded by
    ``conv2d_direct_whole``), ``rows_cta`` rows of each reference block a
    block."""
    global launches_whole, launches_whole_mma
    n, hp, wp, c = xp.shape
    r, s, _, k = w.shape
    plan = whole_mma_plan(p=p, q=q, k_blk=k_blk, rb_p=rb_p, r=r, s=s,
                          stride=stride, rows_cta=rows_cta)
    out = torch.empty((n, p, q, k), dtype=torch.float32, device=xp.device)
    if out.numel() == 0:
        return out
    residual = _aligned(residual)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = _kernel_fn_whole_mma()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        launches_whole += 1
        launches_whole_mma += 1
        err = fn(xp.data_ptr(), w.data_ptr(), ptr(scale), ptr(shift),
                 ptr(bias), ptr(residual), out.data_ptr(), n, hp, wp, c, k,
                 r, s, stride, p, q, rb_p, k_blk, plan.rows_cta,
                 plan.rows_pass, plan.cols, plan.band_rows, plan.band_cols,
                 plan.bn, plan.smem, int(relu), stream)
    if err != 0:
        raise RuntimeError(f"conv2d_direct_whole kernel launch failed (mma "
                           f"route): CUDA error {err} (xp {tuple(xp.shape)}, "
                           f"w {tuple(w.shape)}, {plan})")
    return out
