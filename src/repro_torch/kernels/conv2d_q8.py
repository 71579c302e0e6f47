"""K3: int8 direct-convolution forward with an f32 dequant epilogue (§II-K).

Replaces ``repro/kernels/conv2d_q8.py:conv2d_q8`` (the Pallas
``_kernel_q8_tiled``, ``pallas_call`` at :204).  From x_q (N,H,W,C) int8 and
w_q (R,S,C,K) int8 it accumulates the exact int32 conv, then computes
``out = relu?((f32(acc) * deq) * scale + shift + bias + residual)`` in f32,
with ``deq = x_scale * w_scale`` premultiplied in f32 once per K channel.

Two versions live here:

* ``conv2d_q8_plain`` repeats the kernel's arithmetic in PyTorch: pad, then
  one strided slice and one (pixels, C) x (C, K) product per (r, s) in
  float64, which is exact for |acc| < 2**31 < 2**53, then int32, then the
  same f32 epilogue operations in the same order.  One code path serves the
  CPU and the card (PyTorch has no int32 matmul on CUDA).
* the CUDA C++ kernel ``csrc/conv2d_q8.cu``, built for sm_90a: K1's
  implicit GEMM with the products on the tensor cores
  (``mma.sync.m16n8k32.s32.s8.s8.s32``).

The kernel has two routes, picked by ``route`` from the shapes: ``"ring"``
(``conv2d_q8_kernel_ring``) for C % 16 == 0 and K % 8 == 0, which covers
every ResNet-50 and Inception-v3 int8 conv, reads the weights laid out once
as (R, S, K, C) (``weight_words``, cached across calls), stages (r, s) x 64
or 128 channels a barrier through a cp.async ring and splits the reduction
across CTAs where the tiles leave the card under-filled (``ring_plan``);
``"sync"``, the first kernel (one 32-channel step a barrier through
registers), for the other shapes.

int32 sums are associative and the epilogue rounds in the same places, so
the versions agree bit for bit.  ``conv2d_q8`` takes the plain version
for a CPU tensor and launches the kernel for a CUDA tensor; there is no
fallback between them.  ``launches`` counts the kernel's launches on
either route, ``launches_ring`` the ring route's.

K10c, the same function by the reference's legacy whole-plane strategy
(``repro/kernels/conv2d_q8.py:_conv2d_q8_whole_plane``, ``pallas_call`` at
:246), lives here too: ``conv2d_q8_whole``, its plain version
``conv2d_q8_whole_plain`` and the kernels of ``csrc/conv2d_q8_whole.cu``,
counted by ``launches_whole`` (either route) and ``launches_whole_mma``.
Its routes follow ``route_whole``: ``"mma"``, K3's ``mma.sync`` s8 products
(``csrc/q8_mma.cuh``) on 32-channel slices of the band a pass reads, for C
a multiple of 16 (every ResNet-50 int8 conv), the reference's grid cut
across more CTAs where ``whole_split`` takes it (rows, ``whole_rows_cta``,
and output channels, ``whole_k_cta``; ``whole_mma_plan`` plans passes and
the ring); ``"simt"``, ``__dp4a`` on K10a's SIMT structure
(``whole_plan``), for the other multiples of 8.  The reference requires
K10c to equal the tiled kernel bit for bit; here the int32 sums are exact
in any order, a cut keeps each pixel's sum whole in one CTA, and the
epilogue rounds as K3's, so K10c on either route, K3 and both plain
versions agree bit for bit.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_direct import (SMEM_LIMIT, WHOLE_BN, WHOLE_TN,
                                               FuseSpec, _aligned, _check,
                                               _check_whole_blocking,
                                               _epilogue, _out_hw, pad_input,
                                               whole_plan,
                                               whole_plane_products)
from repro_torch.launch import roofline

# Launches of the CUDA kernel since the last reset (set it to 0 to reset):
# both routes, and the ring route's alone.
launches = 0
launches_ring = 0
_fn = None
_fn_ring = None
# The ring route: block tiles (BM, BN) in the order ring_plan tries them,
# the 16-byte rows' padding in shared memory, the fewest (r, s, c) stages a
# split of the reduction takes, and the shared memory of one of two blocks
# an SM (the kernel's RingShape repeats these).
RING_TILES = ((128, 64), (64, 64))
RING_BK = (64, 128)         # input channels of a stage, as instantiated
MAX_GRID_Z = 65535          # splits share the grid's z dimension
RING_ROW_PAD = 16
RING_MIN_SPLIT_STEPS = 2
RING_MAX_STAGES = 4
RING_TWO_BLOCKS = 233472 // 2 - 1024
# weight_words: the most re-laid weight tensors kept across calls
WORDS_CACHE = 256
_words: collections.OrderedDict = collections.OrderedDict()
_ring_scratch: dict = {}
# Launches of the whole-plane kernel K10c since the last reset: both routes,
# and the mma route's alone.
launches_whole = 0
launches_whole_mma = 0
_fn_whole = None
_fn_whole_mma = None
# K10c's mma route: output pixels of a pass at most (4 warps x 32), 32-bit
# words of a staged band pixel (8 words of 4 channels + 4) and past a staged
# weight row of BN, the ring depths the kernel is built for (one 32-channel
# slice of a pass a stage), and the shared memory of one of two blocks on
# an SM (228 KB less 1 KB a block, halved).
WHOLE_MMA_PASS = 128
WHOLE_MMA_PIXEL_WORDS = 12
WHOLE_MMA_WPAD = 8
WHOLE_MMA_STAGES = (2, 3, 4, 6, 8)
WHOLE_MMA_TWO_BLOCKS = 233472 // 2 - 1024


def _check_overflow(r: int, s: int, c: int) -> None:
    """The §II-K chain-length discipline: the longest int32 sum,
    R*S*C products of at most 127*127, must stay below 2**31."""
    if r * s * c * 127 * 127 >= 2 ** 31:
        raise ValueError(f"int32 accumulator overflow: R*S*C = {r * s * c} "
                         f"products of up to 127*127 reach 2**31")


def _deq(x_scale, w_scale):
    """Premultiplied dequant scales, (K,) f32: one f32 multiply each."""
    return x_scale.reshape(()).to(torch.float32) * w_scale.to(torch.float32)


def conv2d_q8_plain(x_q, w_q, *, x_scale, w_scale, stride: int = 1,
                    padding: int = 0, bias=None, scale=None, shift=None,
                    residual=None, relu: bool = False):
    """The kernel's arithmetic in plain PyTorch (int8 operands)."""
    n, h, wd, c = x_q.shape
    r, s, _, k = w_q.shape
    p, q = _out_hw(h, wd, r, s, stride, padding)
    fuse = FuseSpec(bias=bias is not None, bn=scale is not None,
                    residual=residual is not None, relu=relu)
    xp = F.pad(x_q.to(torch.float64), (0, 0, padding, padding, padding,
                                       padding))
    wf = w_q.to(torch.float64)
    acc = torch.zeros((n * p * q, k), dtype=torch.float64, device=x_q.device)
    for rr in range(r):
        for ss in range(s):
            xs = xp[:, rr:rr + (p - 1) * stride + 1:stride,
                    ss:ss + (q - 1) * stride + 1:stride, :]
            acc += xs.reshape(n * p * q, c) @ wf[rr, ss]
    acc = acc.to(torch.int32).reshape(n, p, q, k)
    out = acc.to(torch.float32) * _deq(x_scale, w_scale)
    return _epilogue(out, fuse, bias, scale, shift, residual)


def conv2d_q8_whole_plain(x_q, w_q, *, x_scale, w_scale, stride: int = 1,
                          padding: int = 0, bias=None, scale=None,
                          shift=None, residual=None, relu: bool = False,
                          rb_p: int, k_blk: int):
    """K10c's arithmetic in plain PyTorch, as the reference's whole-plane
    kernel does it: pad as ``pad_input``, then for each block of rb_p rows
    and the full row Q one (pixels, C) x (C, K) product per (r, s) in
    float64 (exact, as in ``conv2d_q8_plain``), rows past P dropped, then
    int32 and K3's f32 dequant and epilogue."""
    h, wd = x_q.shape[1:3]
    r, s, _, k = w_q.shape
    p, q = _out_hw(h, wd, r, s, stride, padding)
    _check_whole_blocking(k, rb_p, k_blk)
    rb_p = min(rb_p, p)
    fuse = FuseSpec(bias=bias is not None, bn=scale is not None,
                    residual=residual is not None, relu=relu)
    xp = pad_input(x_q.to(torch.float64), padding=padding, stride=stride,
                   rb_p=rb_p, r=r, p=p)
    acc = whole_plane_products(xp, w_q.to(torch.float64), rb_p=rb_p, p=p,
                               q=q, stride=stride).to(torch.int32)
    out = acc.to(torch.float32) * _deq(x_scale, w_scale)
    return _epilogue(out, fuse, bias, scale, shift, residual)


def _check_q8(x_q, w_q, x_scale, w_scale, bias, scale, shift, residual,
              stride, padding):
    """Shapes and types every path needs; returns (P, Q)."""
    p, q = _check(x_q, w_q, bias, scale, shift, residual, stride, padding)
    for name, v in (("x_q", x_q), ("w_q", w_q)):
        if v.dtype != torch.int8:
            raise ValueError(f"{name} must be int8, got {v.dtype}")
    r, s, c, k = w_q.shape
    _check_overflow(r, s, c)
    if x_scale.numel() != 1:
        raise ValueError(f"x_scale must hold one value, got "
                         f"{tuple(x_scale.shape)}")
    if tuple(w_scale.shape) != (k,):
        raise ValueError(f"w_scale must be ({k},), got "
                         f"{tuple(w_scale.shape)}")
    return p, q


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load("conv2d_q8").repro_conv2d_q8
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def route(x_q, w_q) -> str:
    """Which kernel a CUDA call of ``conv2d_q8(x_q, w_q, ...)`` launches,
    by channels alone: "ring" (``conv2d_q8_kernel_ring``) for C % 16 == 0
    and K % 8 == 0, "sync" (the first kernel) for the rest.  A dispatch by
    shape, not a fallback: each route raises on what it cannot take."""
    c, k = x_q.shape[-1], w_q.shape[-1]
    return "ring" if c % 16 == 0 and k % 8 == 0 else "sync"


def weight_words(w_q, layout: str):
    """The int8 weights (R, S, C, K) re-laid for a kernel: "ring", (R, S,
    K, C) with each output channel's C channels contiguous (K3's ring
    route); "whole", (R, S, C/4, K, 4), words of 4 input channels of one
    output channel (K10c).  Kept across calls in one LRU of at most
    WORDS_CACHE entries, keyed by the tensor itself (held by its entry, so
    its id is not reused), its version counter, its device and the layout:
    an in-place edit or another tensor makes a fresh entry.  An inference
    tensor has no version counter, so its words are made anew each call."""
    r, s, c, k = w_q.shape
    if layout == "ring":
        make = lambda: w_q.permute(0, 1, 3, 2).contiguous()  # noqa: E731
    elif layout == "whole":
        if c % 4:
            raise ValueError(f"C={c}: the whole layout takes words of 4 "
                             f"input channels")
        make = lambda: (w_q.reshape(r, s, c // 4, 4, k)  # noqa: E731
                        .permute(0, 1, 2, 4, 3).contiguous())
    else:
        raise ValueError(f"layout {layout!r}; valid: ring, whole")
    if w_q.is_inference():
        return make()
    key = (id(w_q), w_q._version, w_q.device, layout)
    hit = _words.get(key)
    if hit is not None and hit[0] is w_q:
        _words.move_to_end(key)
        return hit[1]
    words = make()
    _words[key] = (w_q, words)
    while len(_words) > WORDS_CACHE:
        _words.popitem(last=False)
    return words


@dataclasses.dataclass(frozen=True)
class RingPlan:
    """How the ring route runs one conv: a ``bm`` x ``bn`` output tile per
    CTA, ring stages of one (r, s) and ``bk`` input channels, ``steps`` of
    them over the whole reduction, ``stages`` deep, the reduction split
    across ``splits`` CTAs of each tile, ``tiles`` output tiles, ``ctas``
    = tiles x splits, and the dynamic shared memory ``smem``."""
    bm: int
    bn: int
    bk: int
    stages: int
    splits: int
    steps: int
    tiles: int
    ctas: int
    smem: int


def _ring_shape(bm: int, bn: int, bk: int, steps: int) -> tuple[int, int]:
    """(stages, shared memory) of one kernel instance for a split of
    ``steps`` steps, as its RingShape computes them: the most stages up to
    RING_MAX_STAGES that leave room for two blocks an SM, and at least 3,
    of which a split of fewer steps claims only as many; after the
    mainloop the same memory holds the int32 tile (rows of bn + 8 words)
    and four f32 factors a column."""
    stage = (bm + bn) * (bk + RING_ROW_PAD)
    stages = RING_MAX_STAGES
    while stages > 3 and stages * stage > RING_TWO_BLOCKS:
        stages -= 1
    return stages, max(min(stages, steps) * stage,
                       bm * (bn + 8) * 4 + 4 * bn * 4)


@functools.lru_cache(maxsize=1024)
def ring_plan(n: int, p: int, q: int, c: int, k: int, r: int, s: int,
              stride: int) -> RingPlan:
    """A pure function of the shape.  A stage takes 128 input channels
    where C >= 128, else 64.  The tile is the first of RING_TILES
    whose grid reaches ``roofline.SMS`` CTAs; where
    none does, the smallest, with the reduction's steps split across as
    many CTAs as bring the grid to SMS, each split keeping at least
    RING_MIN_SPLIT_STEPS steps.  So the grid reaches SMS CTAs wherever
    tiles x (steps // RING_MIN_SPLIT_STEPS) allows it.  ``stride`` is part
    of the key (the shape it names) and enters through P and Q."""
    del stride
    if c % 16 or k % 8:
        raise ValueError(f"the ring route takes C % 16 == 0 and K % 8 == 0, "
                         f"got C={c}, K={k}")
    bk = 128 if c >= 128 else 64
    steps = r * s * -(-c // bk)
    m = n * p * q
    for bm, bn in RING_TILES:
        tiles = -(-m // bm) * -(-k // bn)
        if tiles >= roofline.SMS:
            break
    splits = 1
    if tiles < roofline.SMS:
        splits = max(1, min(steps // RING_MIN_SPLIT_STEPS,
                            -(-roofline.SMS // tiles)))
    stages, smem = _ring_shape(bm, bn, bk, -(-steps // splits))
    return RingPlan(bm=bm, bn=bn, bk=bk, stages=stages, splits=splits,
                    steps=steps, tiles=tiles, ctas=tiles * splits, smem=smem)


def make_ring_plan(*, n: int, p: int, q: int, c: int, k: int, r: int,
                   s: int, bm: int, bn: int, bk: int,
                   splits: int) -> RingPlan:
    """The plan of a tile, a stage depth and a split, with its steps, tiles,
    CTAs, stages and shared memory as the kernel's RingShape derives
    them."""
    steps = r * s * -(-c // bk)
    tiles = -(-(n * p * q) // bm) * -(-k // bn)
    stages, smem = _ring_shape(bm, bn, bk, -(-steps // splits))
    return RingPlan(bm=bm, bn=bn, bk=bk, stages=stages, splits=splits,
                    steps=steps, tiles=tiles, ctas=tiles * splits, smem=smem)


def ring_cost(plan: RingPlan) -> float:
    """Seconds a ring plan takes by a first-order model of the card: the
    SM that runs the most CTAs (ceil(ctas / SMS)) does their s8 products,
    2 x bm x bn x bk ops a step over ceil(steps / splits) steps, at its
    share of the int8 rate, at half that share while it holds one CTA of
    8 warps (two fit an SM); a split adds its int32 partials' bytes
    (written, then read by the last CTA of each tile) at the HBM rate.  A
    ranking of plans, not a prediction of the time."""
    busiest = -(-plan.ctas // roofline.SMS)
    ops = busiest * 2 * plan.bm * plan.bn * plan.bk \
        * -(-plan.steps // plan.splits)
    rate = roofline.INT8_PEAK_OPS / roofline.SMS * min(1.0, busiest / 2)
    traffic = 0 if plan.splits == 1 else \
        2 * plan.ctas * plan.bm * plan.bn * 4
    return ops / rate + traffic / roofline.HBM_BYTES_PER_S


def check_ring_plan(plan, *, n: int, p: int, q: int, c: int, k: int, r: int,
                    s: int) -> None:
    """Raises ``ValueError`` unless the ring route can run ``plan`` on this
    shape: a (bm, bn) of ``RING_TILES`` and a bk of ``RING_BK`` (the
    instances ``csrc/conv2d_q8.cu`` builds), a bk of 128 only where C
    reaches 128, 1 to min(steps, ``MAX_GRID_Z``) splits (none empty), and
    steps, tiles, CTAs, stages and shared memory as ``make_ring_plan``
    derives them, within ``SMEM_LIMIT``."""
    _check_ring_plan(plan, n * p * q, c, k, r * s)


@functools.lru_cache(maxsize=2048)
def _check_ring_plan(plan, m: int, c: int, k: int, taps: int) -> None:
    if not isinstance(plan, RingPlan):
        raise ValueError(f"K3's ring route takes a RingPlan, not {plan!r}")
    if (plan.bm, plan.bn) not in RING_TILES:
        raise ValueError(f"tile {plan.bm}x{plan.bn} is not one of "
                         f"RING_TILES {RING_TILES}")
    if plan.bk not in RING_BK:
        raise ValueError(f"stage of {plan.bk} channels: the ring stages "
                         f"{RING_BK}")
    if plan.bk > c and plan.bk > min(RING_BK):
        raise ValueError(f"stage of {plan.bk} channels over C={c}: the "
                         f"stage's rows would hold zeros past C")
    steps = taps * -(-c // plan.bk)
    if not 1 <= plan.splits <= min(steps, MAX_GRID_Z):
        raise ValueError(f"{plan.splits} splits of {steps} steps: the route "
                         f"takes 1 to {min(steps, MAX_GRID_Z)}")
    want = dict(steps=steps, tiles=-(-m // plan.bm) * -(-k // plan.bn))
    want["ctas"] = want["tiles"] * plan.splits
    want["stages"], want["smem"] = _ring_shape(plan.bm, plan.bn, plan.bk,
                                               -(-steps // plan.splits))
    for field, value in want.items():
        if getattr(plan, field) != value:
            raise ValueError(f"plan has {field}={getattr(plan, field)}, the "
                             f"shape and its tile make {value}")
    if plan.smem > SMEM_LIMIT:
        raise ValueError(f"{plan.smem} bytes of shared memory exceed "
                         f"{SMEM_LIMIT}")


def split_steps(steps: int, splits: int) -> list[tuple[int, int]]:
    """The [begin, end) reduction steps of each split, as the kernel cuts
    them: split z takes steps * z // splits up to steps * (z + 1) //
    splits."""
    return [(steps * z // splits, steps * (z + 1) // splits)
            for z in range(splits)]


def _scratch(device, stream: int, partial: int, tiles: int):
    """The ring route's int32 partials (at least ``partial`` values) and
    per-tile counters (at least ``tiles``, zero between launches), kept per
    device and stream and grown on demand: a launch's last CTA of each
    tile resets its counter, and launches on one stream run in order."""
    key = (device, stream)
    got = _ring_scratch.get(key)
    if got is None or got[0].numel() < partial or got[1].numel() < tiles:
        old = (0, 0) if got is None else (got[0].numel(), got[1].numel())
        got = (torch.empty(max(partial, old[0]), dtype=torch.int32,
                           device=device),
               torch.zeros(max(tiles, old[1]), dtype=torch.int32,
                           device=device))
        _ring_scratch[key] = got
    return got


def _kernel_fn_ring():
    global _fn_ring
    if _fn_ring is None:
        fn = _build.load("conv2d_q8").repro_conv2d_q8_ring
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 16 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_ring = fn
    return _fn_ring


def _launch_ring(x_q, w_q, x_scale, w_scale, out, *, stride, padding, scale,
                 shift, bias, residual, relu, plan=None):
    """K3's ring route into ``out`` (checked by ``conv2d_q8``), with
    ``ring_plan``'s plan unless ``plan`` gives another."""
    global launches, launches_ring
    n, h, wd, c = x_q.shape
    r, s, _, k = w_q.shape
    p, q = out.shape[1:3]
    if x_q.data_ptr() % 16:
        raise ValueError("the ring route reads x_q 16 bytes at a time: its "
                         "data must start on a 16-byte boundary")
    plan = plan or ring_plan(n, p, q, c, k, r, s, stride)
    words = weight_words(w_q, "ring")
    residual = _aligned(residual)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = _kernel_fn_ring()
    device = x_q.device
    stream = torch.cuda.current_stream(device).cuda_stream
    partial = counters = None
    if plan.splits > 1:
        partial, counters = _scratch(device, stream,
                                     plan.ctas * plan.bm * plan.bn,
                                     plan.tiles)
    args = (x_q.data_ptr(), words.data_ptr(), x_scale.data_ptr(),
            w_scale.data_ptr(), ptr(scale), ptr(shift), ptr(bias),
            ptr(residual), out.data_ptr(), ptr(partial), ptr(counters), n, h,
            wd, c, k, r, s, stride, padding, int(relu), plan.bm, plan.bn,
            plan.bk, plan.stages, plan.splits, plan.smem, stream)
    launches += 1
    launches_ring += 1
    # the kernel launches on the current device: switch only when x_q lies
    # on another (the switch costs host time on every call of a forward)
    if device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"conv2d_q8 kernel launch failed (ring route): "
                           f"CUDA error {err} (x_q {tuple(x_q.shape)}, w_q "
                           f"{tuple(w_q.shape)}, {plan})")
    return out


def conv2d_q8(x_q, w_q, *, x_scale, w_scale, stride: int = 1,
              padding: int = 0, bias=None, scale=None, shift=None,
              residual=None, relu: bool = False,
              plan: RingPlan | None = None):
    """Quantized direct conv fwd.  x_q: (N,H,W,C) int8; w_q: (R,S,C,K) int8;
    x_scale: one f32 (per-tensor activation scale); w_scale: (K,) f32 (per
    output channel) -> (N,P,Q,K) f32.  The optional bias / folded-BN
    scale+shift / residual / relu epilogue is applied in f32 after
    dequantization.  A CPU tensor takes ``conv2d_q8_plain``; a CUDA tensor
    launches the sm_90a kernel of ``route`` on the current stream or
    raises.

    ``plan`` (a ``RingPlan``, e.g. a tuned one) replaces ``ring_plan``'s on
    the ring route; None keeps it.  A plan the ring route cannot run on
    this shape, or any plan for a call ``route`` sends to "sync", raises
    ``ValueError`` on either device."""
    global launches
    p, q = _check_q8(x_q, w_q, x_scale, w_scale, bias, scale, shift,
                     residual, stride, padding)
    if plan is not None:
        if route(x_q, w_q) != "ring":
            raise ValueError("a plan applies to K3's ring route only; this "
                             "call takes the sync route")
        check_ring_plan(plan, n=x_q.shape[0], p=p, q=q, c=x_q.shape[3],
                        k=w_q.shape[3], r=w_q.shape[0], s=w_q.shape[1])
    kw = dict(x_scale=x_scale, w_scale=w_scale, stride=stride,
              padding=padding, bias=bias, scale=scale, shift=shift,
              residual=residual, relu=relu)
    if x_q.device.type == "cpu":
        return conv2d_q8_plain(x_q, w_q, **kw)
    if x_q.device.type != "cuda":
        raise ValueError(f"conv2d_q8 runs on cpu or cuda, not {x_q.device}")
    f32 = [("x_scale", x_scale), ("w_scale", w_scale)] + [
        ("epilogue operand", v) for v in (bias, scale, shift, residual)
        if v is not None]
    for name, v in (("x_q", x_q), ("w_q", w_q), *f32):
        if v.device != x_q.device:
            raise ValueError(f"{name} on {v.device}, x_q on {x_q.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, v in f32:
        if v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {v.dtype}")
    n, h, wd, c = x_q.shape
    r, s, _, k = w_q.shape
    out = torch.empty((n, p, q, k), dtype=torch.float32, device=x_q.device)
    if out.numel() == 0:
        return out
    if route(x_q, w_q) == "ring":
        return _launch_ring(x_q, w_q, x_scale, w_scale, out, stride=stride,
                            padding=padding, scale=scale, shift=shift,
                            bias=bias, residual=residual, relu=relu,
                            plan=plan)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = _kernel_fn()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream(x_q.device).cuda_stream
        launches += 1
        err = fn(x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
                 w_scale.data_ptr(), ptr(scale), ptr(shift), ptr(bias),
                 ptr(residual), out.data_ptr(), n, h, wd, c, k, r, s, stride,
                 padding, int(relu), stream)
    if err != 0:
        raise RuntimeError(f"conv2d_q8 kernel launch failed: CUDA error "
                           f"{err} (x_q {tuple(x_q.shape)}, w_q "
                           f"{tuple(w_q.shape)})")
    return out


def route_whole(x_q, w_q) -> str:
    """Which kernel a CUDA call of ``conv2d_q8_whole(x_q, w_q, ...)``
    launches, by channels: "mma" (K3's ``mma.sync`` s8 products) for C a
    multiple of 16, "simt" (``__dp4a``) for the other multiples of 8.  The
    kernels read the wrapper's padded copy of x_q and its re-laid weights,
    so the operands' own alignment does not enter.  Raises ``ValueError``
    for a C neither stages.  A dispatch by shape, not a fallback: each
    route raises on failure."""
    c = x_q.shape[-1]
    if c % 8:
        raise ValueError(f"C={c}: the whole-plane kernel stages input "
                         f"channels 8 at a time")
    return "mma" if c % 16 == 0 else "simt"


@dataclasses.dataclass(frozen=True)
class WholeMmaPlan:
    """How K10c's mma route runs one conv: ``bn`` output channels per block
    (k_blk rounded up as ``whole_plan`` does), ``rows_cta`` rows of a
    reference block per block (rb_p itself when uncut), passes over C of
    ``rows_pass`` rows by ``cols`` output columns (the full row Q when Q <=
    WHOLE_MMA_PASS), the ``band_rows`` x ``band_cols`` window of the padded
    plane a pass's band takes, the ring's ``stages`` and its dynamic shared
    memory."""
    bn: int
    rows_cta: int
    rows_pass: int
    cols: int
    band_rows: int
    band_cols: int
    stages: int
    smem: int


@functools.lru_cache(maxsize=512)
def whole_mma_plan(*, p: int, q: int, k_blk: int, rb_p: int, r: int, s: int,
                   stride: int, rows_cta: int) -> WholeMmaPlan:
    """A pure function of the shape.  A pass takes as many whole rows of
    the block's ``rows_cta`` as fit WHOLE_MMA_PASS pixels and a ring of two
    stages in the shared memory; a Q over WHOLE_MMA_PASS goes in row
    segments of WHOLE_MMA_PASS columns, halved while one row's ring exceeds
    it.  A ring stage holds a pass's band and the (R, S, 8 words, BN)
    weights of one 32-channel slice.  The ring then takes the most stages
    of WHOLE_MMA_STAGES that leave room for two blocks an SM
    (WHOLE_MMA_TWO_BLOCKS), or where two stages do not, that fit
    ``SMEM_LIMIT``: the more stages in flight, the more of each slice's
    load latency hides behind the products.  Raises ``ValueError`` for a
    k_blk off the multiples of 8 up to 128, or when a ring of two stages
    for one output pixel exceeds ``SMEM_LIMIT``."""
    bn = next((b for b in WHOLE_BN if b >= k_blk), None)
    if bn is None or k_blk % WHOLE_TN:
        raise ValueError(f"k_blk {k_blk}: the whole-plane kernels take "
                         f"multiples of {WHOLE_TN} up to {WHOLE_BN[-1]}")
    rows_cta = max(1, min(rows_cta, rb_p, p))

    def stage(rows, cols):
        band = ((rows - 1) * stride + r) * ((cols - 1) * stride + s)
        return 4 * (band * WHOLE_MMA_PIXEL_WORDS
                    + r * s * 8 * (bn + WHOLE_MMA_WPAD))
    least = WHOLE_MMA_STAGES[0]
    cols = min(q, WHOLE_MMA_PASS)
    rows = min(rows_cta, WHOLE_MMA_PASS // cols)
    while rows > 1 and least * stage(rows, cols) > SMEM_LIMIT:
        rows -= 1
    while cols > 1 and least * stage(rows, cols) > SMEM_LIMIT:
        cols = -(-cols // 2)
    if least * stage(rows, cols) > SMEM_LIMIT:
        raise ValueError(f"the whole-plane int8 mma staging needs "
                         f"{least * stage(rows, cols)} bytes of shared "
                         f"memory, more than {SMEM_LIMIT}")
    room = WHOLE_MMA_TWO_BLOCKS if least * stage(rows, cols) <= \
        WHOLE_MMA_TWO_BLOCKS else SMEM_LIMIT
    stages = max(n for n in WHOLE_MMA_STAGES if n * stage(rows, cols) <= room)
    return WholeMmaPlan(bn=bn, rows_cta=rows_cta, rows_pass=rows, cols=cols,
                        band_rows=(rows - 1) * stride + r,
                        band_cols=(cols - 1) * stride + s, stages=stages,
                        smem=stages * stage(rows, cols))


@functools.lru_cache(maxsize=512)
def whole_slices(*, n: int, p: int, k: int, rb_p: int, k_blk: int) -> int:
    """Row slices per reference block that fill the card: the fewest whose
    CTAs (blocks x slices, each slice ceil(rows / slices) rows but the
    last) reach ``roofline.SMS``; as many as the block has rows where none
    do, and 1 where the reference's grid fills the card already."""
    rows = min(rb_p, p)
    blocks = n * (k // k_blk) * -(-p // rows)
    for rows_cta in range(rows, 0, -1):
        if blocks * -(-rows // rows_cta) >= roofline.SMS:
            return -(-rows // rows_cta)
    return rows


def _k_cut(*, n: int, p: int, q: int, k: int, rb_p: int, k_blk: int) -> bool:
    """Whether a cut of K10c's reference grid halves k_blk: where the grid
    fills at most half the card, a block holds at most two passes of
    pixels, and k_blk / 2 stays a multiple of 8."""
    rows = min(rb_p, p)
    blocks = n * (k // k_blk) * -(-p // rows)
    return (2 * blocks <= roofline.SMS and rows * q <= 2 * WHOLE_MMA_PASS
            and k_blk % 16 == 0)


def whole_split(*, n: int, p: int, q: int, k: int, rb_p: int,
                k_blk: int) -> bool:
    """Whether K10c's mma route cuts its reference grid across more CTAs
    (``whole_k_cta``, ``whole_rows_cta``): where the grid has fewer blocks
    than the card has SMs, and a block holds more than half a pass of
    pixels or its k_blk is halved.  Each output channel's and pixel's int32
    sum stays whole in one CTA, so a cut changes no bit.  On an H100
    (``chip_smoke.py`` phase 24 times both sides) the cut ran 1.2x to 7x
    faster on every ResNet-50 grid of 16 to 128 blocks at batch 16; cutting
    the rows alone lost up to 1.9x on the 7x7 outputs' 49-pixel blocks,
    where a slice of 3 rows keeps one of the 4 warp rows busy and each CTA
    stages the whole weight slice again, and halving k_blk there won 1.2x
    to 1.7x."""
    rows = min(rb_p, p)
    blocks = n * (k // k_blk) * -(-p // rows)
    return blocks < roofline.SMS and (
        rows * q > WHOLE_MMA_PASS // 2
        or _k_cut(n=n, p=p, q=q, k=k, rb_p=rb_p, k_blk=k_blk))


def whole_k_cta(*, n: int, p: int, q: int, k: int, rb_p: int,
                k_blk: int) -> int:
    """The output channels of a reference block one CTA of K10c's mma
    route takes: k_blk, or half of it where ``whole_split`` cuts and the
    grid fills at most half the card with blocks of at most two passes."""
    geo = dict(n=n, p=p, q=q, k=k, rb_p=rb_p, k_blk=k_blk)
    return k_blk // 2 if whole_split(**geo) and _k_cut(**geo) else k_blk


def whole_rows_cta(*, n: int, p: int, q: int, k: int, rb_p: int,
                   k_blk: int) -> int:
    """The rows of a reference block one CTA of K10c's mma route takes:
    rb_p, or where ``whole_split`` cuts and a block holds more than half a
    pass of pixels, the ``whole_slices`` of the grid of ``whole_k_cta``
    channels a block."""
    rows = min(rb_p, p)
    if not whole_split(n=n, p=p, q=q, k=k, rb_p=rb_p, k_blk=k_blk) or \
            rows * q <= WHOLE_MMA_PASS // 2:
        return rows
    k_cta = whole_k_cta(n=n, p=p, q=q, k=k, rb_p=rb_p, k_blk=k_blk)
    return -(-rows // whole_slices(n=n, p=p, k=k, rb_p=rb_p, k_blk=k_cta))


def _kernel_fn_whole():
    global _fn_whole
    if _fn_whole is None:
        fn = _build.load("conv2d_q8_whole").repro_conv2d_q8_whole
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 17 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_whole = fn
    return _fn_whole


def conv2d_q8_whole(x_q, w_q, *, x_scale, w_scale, stride: int = 1,
                    padding: int = 0, bias=None, scale=None, shift=None,
                    residual=None, relu: bool = False, rb_p: int,
                    k_blk: int):
    """K10c: the quantized direct conv of ``conv2d_q8`` by the whole-plane
    strategy, with the reference's blocking (``rb_p`` output rows by the
    full row Q, ``k_blk`` output channels per block).  A CPU tensor takes
    ``conv2d_q8_whole_plain``; a CUDA tensor launches the sm_90a kernel on
    the current stream or raises."""
    global launches_whole
    p, q = _check_q8(x_q, w_q, x_scale, w_scale, bias, scale, shift,
                     residual, stride, padding)
    k = w_q.shape[3]
    _check_whole_blocking(k, rb_p, k_blk)
    kw = dict(x_scale=x_scale, w_scale=w_scale, stride=stride,
              padding=padding, bias=bias, scale=scale, shift=shift,
              residual=residual, relu=relu)
    if x_q.device.type == "cpu":
        return conv2d_q8_whole_plain(x_q, w_q, rb_p=rb_p, k_blk=k_blk, **kw)
    if x_q.device.type != "cuda":
        raise ValueError(f"conv2d_q8_whole runs on cpu or cuda, not "
                         f"{x_q.device}")
    f32 = [("x_scale", x_scale), ("w_scale", w_scale)] + [
        ("epilogue operand", v) for v in (bias, scale, shift, residual)
        if v is not None]
    for name, v in (("x_q", x_q), ("w_q", w_q), *f32):
        if v.device != x_q.device:
            raise ValueError(f"{name} on {v.device}, x_q on {x_q.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, v in f32:
        if v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {v.dtype}")
    n, h, wd, c = x_q.shape
    r, s = w_q.shape[:2]
    path = route_whole(x_q, w_q)
    rb_p = min(rb_p, p)
    xp = pad_input(x_q, padding=padding, stride=stride, rb_p=rb_p, r=r, p=p)
    hp, wp = xp.shape[1], xp.shape[2]
    # words of 4 input channels of one output channel: (R, S, C/4, K, 4)
    wt = weight_words(w_q, "whole")
    if path == "mma":
        geo = dict(n=n, p=p, q=q, k=k, rb_p=rb_p, k_blk=k_blk)
        return _launch_whole_mma(xp, wt, x_scale, w_scale, p=p, q=q, r=r,
                                 s=s, k=k, rb_p=rb_p,
                                 k_blk=whole_k_cta(**geo),
                                 rows_cta=whole_rows_cta(**geo), scale=scale,
                                 shift=shift, bias=bias, residual=residual,
                                 relu=relu, stride=stride)
    plan = whole_plan(p=p, q=q, k_blk=k_blk, rb_p=rb_p, r=r, s=s,
                      stride=stride, wp=wp, slice_bytes=32)
    out = torch.empty((n, p, q, k), dtype=torch.float32, device=x_q.device)
    if out.numel() == 0:
        return out
    residual = _aligned(residual)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = _kernel_fn_whole()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream(x_q.device).cuda_stream
        launches_whole += 1
        err = fn(xp.data_ptr(), wt.data_ptr(), x_scale.data_ptr(),
                 w_scale.data_ptr(), ptr(scale), ptr(shift), ptr(bias),
                 ptr(residual), out.data_ptr(), n, hp, wp, c, k, r, s,
                 stride, p, q, rb_p, k_blk, plan.rows_pass, plan.bn, plan.tm,
                 plan.smem, int(relu), stream)
    if err != 0:
        raise RuntimeError(f"conv2d_q8_whole kernel launch failed: CUDA "
                           f"error {err} (x_q {tuple(x_q.shape)}, w_q "
                           f"{tuple(w_q.shape)}, {plan})")
    return out


def _kernel_fn_whole_mma():
    global _fn_whole_mma
    if _fn_whole_mma is None:
        fn = _build.load("conv2d_q8_whole").repro_conv2d_q8_whole_mma
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 21 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_whole_mma = fn
    return _fn_whole_mma


def _launch_whole_mma(xp, wt, x_scale, w_scale, *, p, q, r, s, k, rb_p,
                      k_blk, rows_cta, scale, shift, bias, residual, relu,
                      stride):
    """K10c's mma route on the padded plane ``xp`` and the (R, S, C/4, K)
    weight words ``wt`` (checked and made by ``conv2d_q8_whole``),
    ``k_blk`` output channels and ``rows_cta`` rows of each reference block
    a CTA."""
    global launches_whole, launches_whole_mma
    n, hp, wp, c = xp.shape
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
        err = fn(xp.data_ptr(), wt.data_ptr(), x_scale.data_ptr(),
                 w_scale.data_ptr(), ptr(scale), ptr(shift), ptr(bias),
                 ptr(residual), out.data_ptr(), n, hp, wp, c, k, r, s,
                 stride, p, q, rb_p, k_blk, plan.rows_cta, plan.rows_pass,
                 plan.cols, plan.band_rows, plan.band_cols, plan.bn,
                 plan.stages, plan.smem, int(relu), stream)
    if err != 0:
        raise RuntimeError(f"conv2d_q8_whole kernel launch failed (mma "
                           f"route): CUDA error {err} (xp "
                           f"{tuple(xp.shape)}, {plan})")
    return out


def quantize_conv_inputs(x, w):
    """Symmetric per-tensor activation scale and per-K-channel weight
    scales (the standard inference calibration): returns
    (x_q, w_q, x_scale, w_scale) with x_scale a 0-d f32 tensor."""
    x_scale = x.abs().max().to(torch.float32) / 127.0 + 1e-12
    x_q = torch.clamp(torch.round(x / x_scale), -127, 127).to(torch.int8)
    w_scale = w.abs().amax(dim=(0, 1, 2)).to(torch.float32) / 127.0 + 1e-12
    w_q = torch.clamp(torch.round(w / w_scale), -127, 127).to(torch.int8)
    return x_q, w_q, x_scale, w_scale
