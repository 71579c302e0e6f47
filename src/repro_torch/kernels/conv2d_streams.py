"""K4: replay of a §II-H kernel-stream schedule (paper Algorithm 5).

Replaces ``repro/kernels/conv2d_streams.py:conv2d_streams`` (the Pallas
``_kernel``, ``pallas_call`` at :104).  A dryrun schedule
(``core.streams.build_conv_schedule``) lists one step per microkernel
invocation, ``(n, kb, pb, cb, flags)``; a step adds the (r, s) products of
one ``c_blk`` slice of C into the ``rb_p x Q x k_blk`` output tile it
names.  ``FLAG_INIT`` zeroes the tile's accumulator, ``FLAG_EPILOGUE``
adds the bias (and, with ``FLAG_RELU``, clamps at 0) and writes the tile.
x (N,H,W,C) f32 and w (R,S,C,K) give out (N,P,Q,K) f32, returned uncast.

Two versions live here:

* ``conv2d_streams_plain`` replays the schedule step by step in PyTorch:
  per step and per (r, s), a strided slice and a (pixels, c_blk) x
  (c_blk, k_blk) matmul, with init, epilogue and ReLU taken from the
  flags.  The CPU tests run it, and ``chip_smoke.py`` holds the kernel
  against it on the card.
* the CUDA C++ kernel ``csrc/conv2d_streams.cu``, built for sm_90a, which
  reads the five streams from device memory and obeys every flag it reads.

``conv2d_streams`` takes the plain version for a CPU tensor and launches the
kernel of its route for a CUDA tensor; there is no fallback between them,
nor between the routes (``route``): ``"mma"``, K1's mma route's products
(``csrc/conv_tf32.cuh``: 3xTF32 on ``mma.sync`` m16n8k8, each stage of one
(r, s) and 32 channels of the step's c-block, or 16 or 8 where c_blk is that
small (``mma_stage_c``), summed in a zeroed run accumulator that then joins
the run's f32 sums), for C, K, c_blk and k_blk
multiples of 4 and 16-byte aligned operands, which is every ResNet-50
signature under every blocking the tuner offers; ``"simt"``, K1's old
register-tiled SIMT GEMM, for the rest.  ``launches`` counts the kernel's
launches on either route, ``launches_mma`` those of the mma route.
``conv2d_streams_auto`` is dryrun plus replay, with the blocking from the
caller, the tuner or the defaults.

What bounds it on an H100: K1's FLOPs, above the f32 ridge at ResNet-50's
shapes, so operations: on the mma route three TF32 products per f32 one at
the TF32 tensor-core rate (``MMA_PEAK_FLOPS``), on the SIMT route the f32
FMA rate.  What the streams add is one read of each step's flag and c-block
per stage, and a CTA tile chosen per run (``mma_tile_config``,
``tile_config``), since a tile of ``rb_p x Q`` pixels fixes the GEMM's M
side: 56 pixels for one 56-wide row, 448 for eight.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import backend as be
from repro_torch.core.blocking import conv_blocking
from repro_torch.core.streams import (FLAG_EPILOGUE, FLAG_INIT, FLAG_RELU,
                                      ConvSchedule, build_conv_schedule,
                                      run_starts)
from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_direct import (MMA_BLOCKS_PER_SM, MMA_STAGE_C,
                                               MMA_TILES)
from repro_torch.launch.roofline import F32_PEAK_FLOPS, SMS, TF32_PEAK_FLOPS

# Launches of the CUDA kernels since the last reset (set it to 0 to reset):
# both routes, and the mma route's alone.
launches = 0
launches_mma = 0
_fn = None
_fn_mma = None

# The dryrun is made once per layer and blocking, and its streams are
# checked and copied to the card once per schedule: a replay then costs one
# launch (§II-H: record once, replay many times).  A schedule's arrays must
# not change after its first replay.
_dryrun = functools.lru_cache(maxsize=512)(build_conv_schedule)
_PREPARED_MAX = 512
_prepared: collections.OrderedDict = collections.OrderedDict()

# CTA tiles of the kernel, (BM pixels, BN channels, TM, TN): the switch in
# csrc/conv2d_streams.cu takes the index.  256 threads, each a TM x TN
# register tile.
TILES = ((128, 128, 8, 8), (128, 64, 8, 4), (64, 64, 4, 4), (128, 32, 4, 4),
         (256, 16, 4, 4))


# The mma route's CTA tiles are K1's (``conv2d_direct.MMA_TILES``, by the
# code the switch in csrc/conv2d_streams.cu takes, with the blocks of each
# an SM holds and the input channels of one ring stage); the f32 rate of
# its 3xTF32 products is a third of the TF32 rate.
MMA_PEAK_FLOPS = TF32_PEAK_FLOPS / 3
ROUTE_PEAK_FLOPS = {"mma": MMA_PEAK_FLOPS, "simt": F32_PEAK_FLOPS}


def _out_hw(h, w, r, s, stride, padding):
    return ((h + 2 * padding - r) // stride + 1,
            (w + 2 * padding - s) // stride + 1)


def tile_config(*, tile_m: int, k_blk: int, c_blk: int,
                runs: int) -> tuple[int, float]:
    """The CTA tile K4 runs a schedule with, and K4's modeled share of the
    f32 peak under it: the share of its lanes that hold real pixels,
    channels and input channels (8 per stage), times the share of the SMs
    the CTAs fill, times register reuse (TM*TN / (TM+TN), relative to the
    8 x 8 tile's 4).  The largest product wins; on a tie, the tile with
    fewer idle lanes."""
    best = (-1.0, 0.0, 0)
    for idx, (bm, bn, tm, tn) in enumerate(TILES):
        m_sub, k_sub = math.ceil(tile_m / bm), math.ceil(k_blk / bn)
        lanes = (tile_m / (m_sub * bm) * k_blk / (k_sub * bn)
                 * c_blk / (math.ceil(c_blk / 8) * 8))
        fill = min(1.0, runs * m_sub * k_sub / SMS)
        reuse = tm * tn / (tm + tn) / 4.0
        best = max(best, (round(lanes * fill * reuse, 9), lanes, -idx))
    return -best[2], best[0]


def route_of(*, c: int, k: int, c_blk: int, k_blk: int) -> str:
    """The route by channels and blocks alone, for aligned operands: "mma"
    when C, K, c_blk and k_blk are multiples of 4, else "simt".  Raises
    ``ValueError`` for blocks that do not divide the channels."""
    if c_blk < 1 or k_blk < 1 or c % c_blk or k % k_blk:
        raise ValueError(f"k_blk {k_blk} must divide K={k} and c_blk "
                         f"{c_blk} divide C={c}")
    return "mma" if c % 4 == k % 4 == c_blk % 4 == k_blk % 4 == 0 else "simt"


def route(x, w, c_blk: int, k_blk: int) -> str:
    """Which kernel a CUDA call of ``conv2d_streams(x, w, ...)`` with these
    blocks launches: "mma" (3xTF32 on the tensor cores) when C, K, c_blk
    and k_blk are multiples of 4 and x and w start on 16-byte boundaries
    (every 4-channel group of a pixel row or weight row then lies on one),
    else "simt".  Raises ``ValueError`` on blocks neither takes.  A
    dispatch by shape, not a fallback: each route raises on failure."""
    path = route_of(c=x.shape[-1], k=w.shape[-1], c_blk=c_blk, k_blk=k_blk)
    if path == "mma" and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0:
        return "mma"
    return "simt"


def mma_stage_c(c_blk: int) -> int:
    """The input channels of one stage of the mma route: 32 (``MMA_STAGE_C``),
    or 16 or 8 for a c_blk no larger, so that a step's stages hold as few
    idle channels as the mainloop's depths allow."""
    return next(depth for depth in (8, 16, MMA_STAGE_C)
                if c_blk <= depth or depth == MMA_STAGE_C)


def mma_tile_config(*, tile_m: int, k_blk: int,
                    runs: int) -> tuple[int, float]:
    """The CTA tile (a code of ``MMA_TILES``) the mma route cuts each run's
    rb_p*Q x k_blk tile into, and the route's modeled share of its peak
    under it, by K1's first-order model of the card
    (``conv2d_direct._mma_cost``): the SM that runs the most CTAs
    (ceil(CTAs / SMs)) does their products at its share of the rate, at a
    share of that while it holds fewer than 8 warps; the share is the
    useful products over that.  The largest share wins; on a tie, the
    tile with fewer idle lanes, then the larger."""
    best = None
    for code, (bm, bn) in MMA_TILES.items():
        m_sub, k_sub = math.ceil(tile_m / bm), math.ceil(k_blk / bn)
        busiest = math.ceil(runs * m_sub * k_sub / SMS)
        warps = min(busiest, MMA_BLOCKS_PER_SM[code]) * (bm * bn // 2048)
        share = (runs * tile_m * k_blk / (SMS * busiest * bm * bn)
                 * min(1.0, warps / 8))
        lanes = tile_m / (m_sub * bm) * k_blk / (k_sub * bn)
        key = (round(share, 9), round(lanes, 9), -code)
        if best is None or key > best:
            best = key
    return -best[2], best[0]


def _check(x, w, schedule, bias, stride, padding, rb_p, k_blk, c_blk):
    """Shapes, blocks and the schedule; returns (P, Q, rb_p, k_blk, c_blk)
    with rb_p clipped to P and the block defaults filled in."""
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
    if rb_p < 1:
        raise ValueError(f"rb_p {rb_p}")
    rb_p = min(rb_p, p)
    k_blk = k_blk or min(k, 128)
    c_blk = c_blk or min(c, 128)
    if k % k_blk or c % c_blk:
        raise ValueError(f"k_blk {k_blk} must divide K={k} and c_blk "
                         f"{c_blk} divide C={c}")
    if bias is not None and tuple(bias.shape) != (k,):
        raise ValueError(f"bias must be ({k},), got {tuple(bias.shape)}")
    grid = (n, k // k_blk, math.ceil(p / rb_p), c // c_blk)
    if tuple(schedule.grid) != grid:
        raise ValueError(f"schedule grid {tuple(schedule.grid)} does not fit "
                         f"this layer and blocking: {grid}")
    _prepare(schedule)
    return p, q, rb_p, k_blk, c_blk


def _prepare(schedule: ConvSchedule) -> dict:
    """The checked schedule's run starts and its streams packed per device
    (``{"starts": ..., device: tensor}``), made on its first replay."""
    key = id(schedule)
    entry = _prepared.get(key)
    if entry is not None and entry["schedule"] is schedule:
        _prepared.move_to_end(key)
        return entry
    _check_streams(schedule)
    entry = {"schedule": schedule, "starts": run_starts(schedule)}
    _prepared[key] = entry
    while len(_prepared) > _PREPARED_MAX:
        _prepared.popitem(last=False)
    return entry


def _device_streams(schedule: ConvSchedule, device) -> torch.Tensor:
    """flags, n, kb, pb, cb and the run starts back to back as one int32
    tensor on ``device``, copied once per schedule and device."""
    entry = _prepare(schedule)
    packed = entry.get(device)
    if packed is None:
        packed = torch.from_numpy(np.concatenate([
            schedule.flags, schedule.n_ids, schedule.kb_ids,
            schedule.pb_ids, schedule.cb_ids, entry["starts"]]).astype(
                np.int32)).to(device)
        entry[device] = packed
    return packed


def _check_streams(schedule: ConvSchedule) -> None:
    """Every stream entry in range, every run contiguous (one tile, from a
    FLAG_INIT step to the next FLAG_EPILOGUE step) and every output tile
    replayed by exactly one run: what the kernel's reads and writes rely
    on."""
    streams = (schedule.n_ids, schedule.kb_ids, schedule.pb_ids,
               schedule.cb_ids)
    steps = len(schedule.flags)
    if steps == 0 or any(len(a) != steps for a in streams):
        raise ValueError("the five streams must be non-empty and of one "
                         "length")
    for name, a, bound in zip(("n", "kb", "pb", "cb"), streams,
                              schedule.grid):
        if a.min() < 0 or a.max() >= bound:
            raise ValueError(f"{name} stream leaves [0, {bound})")
    flags = np.asarray(schedule.flags)
    starts = np.flatnonzero(flags & FLAG_INIT)
    ends = np.flatnonzero(flags & FLAG_EPILOGUE)
    if (len(starts) == 0 or starts[0] != 0 or len(ends) != len(starts)
            or ends[-1] != steps - 1 or np.any(ends < starts)
            or np.any(ends[:-1] >= starts[1:])):
        raise ValueError("the flags do not split the schedule into runs "
                         "from FLAG_INIT to FLAG_EPILOGUE")
    run = np.cumsum((flags & FLAG_INIT) != 0) - 1
    for a in streams[:3]:
        if np.any(a != a[starts][run]):
            raise ValueError("a run changes its output tile")
    n, k_b, p_b, _ = schedule.grid
    tiles = (streams[0][starts].astype(np.int64) * k_b
             + streams[1][starts]) * p_b + streams[2][starts]
    if len(starts) != n * k_b * p_b or len(np.unique(tiles)) != len(starts):
        raise ValueError("the runs do not cover every output tile once")


def conv2d_streams_plain(x, w, *, schedule: ConvSchedule, stride: int = 1,
                         padding: int = 0, bias=None, rb_p: int = 8,
                         k_blk: int | None = None, c_blk: int | None = None):
    """The kernel's arithmetic in plain PyTorch, step by step (f32)."""
    p, q, rb_p, k_blk, c_blk = _check(x, w, schedule, bias, stride, padding,
                                      rb_p, k_blk, c_blk)
    n, _, _, c = x.shape
    r, s, _, k = w.shape
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    out = torch.empty((n, p, q, k), dtype=torch.float32, device=x.device)
    acc = None
    for f, nn, kb, pb, cb in zip(schedule.flags.tolist(),
                                 schedule.n_ids.tolist(),
                                 schedule.kb_ids.tolist(),
                                 schedule.pb_ids.tolist(),
                                 schedule.cb_ids.tolist()):
        p0 = pb * rb_p
        rows = min(rb_p, p - p0)
        ks = slice(kb * k_blk, (kb + 1) * k_blk)
        cs = slice(cb * c_blk, (cb + 1) * c_blk)
        if f & FLAG_INIT:
            acc = torch.zeros((rows * q, k_blk), dtype=torch.float32,
                              device=x.device)
        step = torch.zeros_like(acc)
        for rr in range(r):
            for ss in range(s):
                h0 = p0 * stride + rr
                xs = xp[nn, h0:h0 + (rows - 1) * stride + 1:stride,
                        ss:ss + (q - 1) * stride + 1:stride, cs]
                step += xs.reshape(rows * q, c_blk) @ w[rr, ss, cs, ks]
        acc = acc + step
        if f & FLAG_EPILOGUE:
            y = acc if bias is None else acc + bias[ks]
            if f & FLAG_RELU:
                y = torch.clamp_min(y, 0)
            out[nn, p0:p0 + rows, :, ks] = y.reshape(rows, q, k_blk)
    return out


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load("conv2d_streams").repro_conv2d_streams_f32
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                       + [ctypes.c_void_p] + [ctypes.c_int]
                       + [ctypes.c_void_p] + [ctypes.c_int] * 13
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def conv2d_streams(x, w, *, schedule: ConvSchedule, stride: int = 1,
                   padding: int = 0, bias=None, rb_p: int = 8,
                   k_blk: int | None = None, c_blk: int | None = None):
    """Replay ``schedule`` over x (N,H,W,C), w (R,S,C,K) -> (N,P,Q,K) f32.

    A CPU tensor takes ``conv2d_streams_plain``; a CUDA tensor launches the
    sm_90a kernel of its ``route`` on the current stream, or raises.  The
    schedule is checked, and its streams copied to the card, at its first
    replay."""
    global launches, launches_mma
    p, q, rb_p, k_blk, c_blk = _check(x, w, schedule, bias, stride, padding,
                                      rb_p, k_blk, c_blk)
    if x.device.type == "cpu":
        return conv2d_streams_plain(x, w, schedule=schedule, stride=stride,
                                    padding=padding, bias=bias, rb_p=rb_p,
                                    k_blk=k_blk, c_blk=c_blk)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_streams runs on cpu or cuda, not {x.device}")
    _build.no_grad_inputs("conv2d_streams (K4)", x, w, bias)
    for name, v in (("x", x), ("w", w), ("bias", bias)):
        if v is None:
            continue
        if v.device != x.device:
            raise ValueError(f"{name} on {v.device}, x on {x.device}")
        if v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {v.dtype}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, h, wd, c = x.shape
    r, s, _, k = w.shape
    steps = len(schedule)
    packed = _device_streams(schedule, x.device)
    runs = packed.numel() - 5 * steps
    out = torch.empty((n, p, q, k), dtype=torch.float32, device=x.device)
    if route(x, w, c_blk, k_blk) == "mma":
        tile, _ = mma_tile_config(tile_m=rb_p * q, k_blk=k_blk, runs=runs)
        fn, name, extra = _kernel_fn_mma(), "mma", (mma_stage_c(c_blk),)
    else:
        tile, _ = tile_config(tile_m=rb_p * q, k_blk=k_blk, c_blk=c_blk,
                              runs=runs)
        fn, name, extra = _kernel_fn(), "simt", ()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launches += 1
        if name == "mma":
            launches_mma += 1
        err = fn(x.data_ptr(), w.data_ptr(),
                 None if bias is None else bias.data_ptr(),
                 packed.data_ptr(), steps,
                 packed.data_ptr() + 5 * steps * 4, runs,
                 out.data_ptr(), n, h, wd, c, k, r, s, stride, padding, rb_p,
                 k_blk, c_blk, tile, *extra, stream)
    if err != 0:
        raise RuntimeError(f"conv2d_streams kernel launch failed ({name} "
                           f"route, tile {tile}): CUDA error {err} (x "
                           f"{tuple(x.shape)}, w {tuple(w.shape)}, {steps} "
                           f"steps)")
    return out


def _kernel_fn_mma():
    global _fn_mma
    if _fn_mma is None:
        fn = _build.load("conv2d_streams").repro_conv2d_streams_mma
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                       + [ctypes.c_void_p] + [ctypes.c_int]
                       + [ctypes.c_void_p] + [ctypes.c_int] * 14
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn_mma = fn
    return _fn_mma


def conv2d_streams_auto(x, w, *, stride=1, padding=0, bias=None, relu=False,
                        rb_p=None, k_blk=None, c_blk=None, order=None,
                        blocking=None, autotune=None):
    """Dryrun + replay in one call (the common path).

    Knob precedence, as in the reference: explicitly passed
    rb_p/k_blk/c_blk/order always win; ``blocking`` (a
    ``core.blocking.ConvBlocking``) fills whatever the caller left unset;
    when the caller pins nothing and autotuning is on (``autotune=`` or
    ``backend.get_autotune``), the tuned "streams" blocking for this shape,
    batch and device supplies the knobs and the dryrun's loop order; the
    defaults (rb_p=8, blocks of up to 128 features, "nkpc") fill the rest.
    """
    n, h, wdt, c = x.shape
    r, s, _, k = w.shape
    p = (h + 2 * padding - r) // stride + 1
    untouched = rb_p is None and k_blk is None and c_blk is None and order is None
    if blocking is None and untouched and be.resolve_autotune(autotune) != "off":
        blocking = conv_blocking(
            h=h, w=wdt, c=c, k=k, r=r, s=s, stride=stride, padding=padding,
            dtype_bytes=x.element_size(), autotune=autotune, kind="streams",
            backend=x.device.type, minibatch=n)
    if blocking is not None:    # fills only the knobs the caller left unset
        rb_p = blocking.rb_p if rb_p is None else rb_p
        k_blk = blocking.k_blk if k_blk is None else k_blk
        c_blk = blocking.c_blk if c_blk is None else c_blk
        order = blocking.order if order is None else order
    rb_p = 8 if rb_p is None else rb_p
    order = order or "nkpc"
    rb_p_eff = min(rb_p, p)
    k_blk = k_blk or min(k, 128)
    c_blk = c_blk or min(c, 128)
    sched = _dryrun(n=n, k_b=k // k_blk, p_b=math.ceil(p / rb_p_eff),
                    c_b=c // c_blk, order=order, relu=bool(relu))
    out = conv2d_streams(x, w, schedule=sched, stride=stride, padding=padding,
                         bias=bias, rb_p=rb_p, k_blk=k_blk, c_blk=c_blk)
    return out.to(x.dtype)
