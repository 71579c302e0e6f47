"""Candidate scoring: CUDA events on the card, a cost model everywhere
else — the port's counterpart of ``repro/tune/measure.py`` for convs.

On the card (backend "cuda") the model shortlists ``measure_top``
candidates and each is timed by CUDA events over the real kernel, the
paper's empirical specialization.  On the CPU a wall clock would time
PyTorch's CPU kernels, so candidates are ranked by the model alone:

  t_model = max(flops / (peak * util), hbm_bytes / HBM_BYTES_PER_S)

with the H100's constants from ``repro_torch.launch.roofline``.

* ``flops`` and ``hbm_bytes`` come from ``conv_traffic``, the reference's
  schedule-resolved refetch model, unchanged: the same FLOPs and bytes for
  the same blocking.
* for "streams", ``util`` and the peak are those of the route K4 takes
  under the blocking (``kernels.conv2d_streams.route_of``), in place of the
  reference's 128x128 MXU tile occupancy: on the mma route
  (``mma_tile_config``: the busiest SM's share of the products, its warps,
  times the share of each stage, of ``mma_stage_c`` channels, that holds
  real channels) at
  the 3xTF32 rate, ``MMA_PEAK_FLOPS``; on the SIMT route (``tile_config``:
  the share of the CTA tile's lanes that hold real pixels and channels,
  times the share of the SMs its CTAs fill, times register reuse) at
  ``F32_PEAK_FLOPS``.  K1, K2 and K3 choose their tiles inside their
  ``.cu`` files and take no blocking, so the other kinds are priced at
  util 1 of the f32 peak, the bare roofline; there is nothing of theirs to
  time yet.
* No per-step overhead term: the TPU's grid-step pipeline fill has no
  counterpart in a kernel whose steps run in parallel CTAs.
"""
from __future__ import annotations

import math

from repro_torch.core.blocking import ConvBlocking
from repro_torch.kernels.conv2d_streams import (ROUTE_PEAK_FLOPS,
                                                conv2d_streams_auto,
                                                mma_stage_c, mma_tile_config,
                                                route_of, tile_config)
from repro_torch.launch.roofline import F32_PEAK_FLOPS, kernel_roofline
from repro_torch.tune.space import out_dim

# Kernel timings taken since the last reset (set to 0 to reset): a pass
# that should only read the cache must leave it unchanged.
measurements = 0


def _refetches(dep_positions: list[int], extents: tuple[int, ...]) -> int:
    """Times a block is (re)fetched over a nested loop: once per iteration of
    every loop at or outside the innermost dependency that varies."""
    live = [p for p in dep_positions if extents[p] > 1]
    if not live:
        return 1
    inner = max(live)
    n = 1
    for p in range(inner + 1):
        n *= extents[p]
    return n


def conv_traffic(shape: dict, blk: ConvBlocking, *, minibatch: int = 1,
                 kind: str = "fwd", whole_plane: bool = False) -> dict:
    """Schedule-resolved FLOPs and HBM traffic of one conv layer under
    blocking `blk`, the reference's model (all terms in bytes, summed over
    the launch):

      * input  — the tiled fwd/bwd/q8 kernel streams one row band per step
        (deps N, P, C_b); ``whole_plane`` ships the padded plane on every
        step; "streams" holds the plane per (N, C_b).
      * weight — one (r, s, C_blk, K_blk) block, kept across the P sweep
        where the loop order allows (§II-C).
      * output — one f32 tile per (N, K_b, P_b) visit; every extra C-block
        pass of "streams" and the tiled forward is charged as a read-back
        and rewrite (on the TPU the tile accumulates through memory; K4
        keeps it in registers, so this overcounts K4's bytes).

    ``kind="wu"`` models the update pass: an input band and a dO tile per
    step of its (K_b, C_b, N, P_b, Q_b) grid, each dW tile written once.
    """
    h, w, c, k = shape["h"], shape["w"], shape["c"], shape["k"]
    r, s = shape["r"], shape["s"]
    stride, padding = shape["stride"], shape["padding"]
    dtype_bytes = shape.get("dtype_bytes", 4)
    p = out_dim(h, r, stride, padding)
    q = out_dim(w, s, stride, padding)
    n = minibatch
    hp, wp = h + 2 * padding + r, w + 2 * padding

    if kind == "wu":
        return _wu_traffic(h=h, w=w, c=c, k=k, r=r, s=s, stride=stride,
                           p=p, q=q, hp=hp, wp=wp, n=n, blk=blk,
                           dtype_bytes=dtype_bytes, whole_plane=whole_plane)

    tiled_fwd = kind in ("fwd", "bwd", "q8") and not whole_plane
    if whole_plane:
        c_blk, rb_q = c, q
    elif kind == "streams":
        c_blk, rb_q = blk.c_blk, q
    else:
        c_blk, rb_q = blk.c_blk, (blk.rb_q or q)
    rb_p = min(blk.rb_p, p)
    rb_q = min(rb_q, q)
    p_b = math.ceil(p / rb_p)
    q_b = math.ceil(q / rb_q) if tiled_fwd else 1
    k_b = max(k // blk.k_blk, 1)
    c_b = max(c // c_blk, 1)
    extents = (n, k_b, p_b * q_b, c_b)

    order = "nkpc" if whole_plane else blk.order
    pos = {dim: i for i, dim in enumerate(order)}
    by_dim = {"n": extents[0], "k": extents[1], "p": extents[2],
              "c": extents[3]}
    ordered = tuple(by_dim[d] for d in order)
    n_steps = extents[0] * extents[1] * extents[2] * extents[3]

    flops = 2.0 * n * p * q * c * k * r * s
    if tiled_fwd:
        band_h = (rb_p - 1) * stride + r
        band_w = (rb_q - 1) * stride + s
        x_bytes = band_h * band_w * c_blk * dtype_bytes
        x_f = _refetches([pos["n"], pos["p"], pos["c"]], ordered)
    else:
        x_bytes = hp * wp * c_blk * dtype_bytes
        x_f = n_steps if whole_plane else _refetches([pos["n"], pos["c"]],
                                                     ordered)
    w_bytes = r * s * c_blk * blk.k_blk * dtype_bytes
    o_bytes = rb_p * rb_q * blk.k_blk * 4   # f32 tile (q8 output stays f32)
    w_f = _refetches([pos["k"], pos["c"]], ordered)
    o_f = _refetches([pos["n"], pos["k"], pos["p"]], ordered)
    revisit = max(extents[3], 1)
    multipass = (2 * revisit - 1) if (kind == "streams" or tiled_fwd) else 1
    o_traffic = o_bytes * o_f * multipass
    total = x_bytes * x_f + w_bytes * w_f + o_traffic
    return {
        "flops": flops,
        "x_bytes": x_bytes * x_f,
        "w_bytes": w_bytes * w_f,
        "o_bytes": o_traffic,
        "hbm_bytes": total,
        "n_steps": n_steps,
        "extents": extents,
    }


def _wu_traffic(*, h, w, c, k, r, s, stride, p, q, hp, wp, n, blk,
                dtype_bytes, whole_plane) -> dict:
    """Update-pass traffic: see ``conv_traffic``."""
    flops = 2.0 * n * p * q * c * k * r * s
    k_blk = min(blk.k_blk, k)
    if whole_plane:
        rb_p = min(blk.rb_p, p)
        p_b = math.ceil(p / rb_p)
        n_steps = (k // k_blk) * n * p_b                  # (K_b, N, P_b)
        x_traffic = hp * wp * c * dtype_bytes * (k // k_blk) * n
        do_traffic = rb_p * q * k_blk * dtype_bytes * n_steps
    else:
        rb_p = min(blk.rb_p, p)
        rb_q = min(blk.rb_q or q, q)
        c_blk = blk.c_blk or c
        band_h = (rb_p - 1) * stride + r
        band_w = (rb_q - 1) * stride + s
        p_b = math.ceil(p / rb_p)
        q_b = math.ceil(q / rb_q)
        n_steps = (k // k_blk) * (c // c_blk) * n * p_b * q_b
        x_traffic = band_h * band_w * c_blk * dtype_bytes * n_steps
        do_traffic = rb_p * rb_q * k_blk * dtype_bytes * n_steps
    dw_traffic = r * s * c * k * 4
    total = x_traffic + do_traffic + dw_traffic
    return {
        "flops": flops,
        "x_bytes": x_traffic,
        "w_bytes": do_traffic,      # the "weight slot" input is dO here
        "o_bytes": dw_traffic,
        "hbm_bytes": total,
        "n_steps": n_steps,
        "extents": (n, k // k_blk, p_b,
                    1 if whole_plane else c // (blk.c_blk or c)),
    }


def _streams_util(shape: dict, blk: ConvBlocking, *,
                  minibatch: int) -> tuple[float, float]:
    """K4's modeled share of its route's peak under `blk`, and that peak
    in FLOP/s: the model of the route K4 takes (``route_of``)."""
    p = out_dim(shape["h"], shape["r"], shape["stride"], shape["padding"])
    q = out_dim(shape["w"], shape["s"], shape["stride"], shape["padding"])
    rb_p = min(blk.rb_p, p)
    runs = minibatch * max(shape["k"] // blk.k_blk, 1) * math.ceil(p / rb_p)
    path = route_of(c=shape["c"], k=shape["k"], c_blk=blk.c_blk,
                    k_blk=blk.k_blk)
    if path == "mma":
        depth = mma_stage_c(blk.c_blk)
        stage = blk.c_blk / (math.ceil(blk.c_blk / depth) * depth)
        share = mma_tile_config(tile_m=rb_p * q, k_blk=blk.k_blk,
                                runs=runs)[1]
        return share * stage, ROUTE_PEAK_FLOPS[path]
    return tile_config(tile_m=rb_p * q, k_blk=blk.k_blk, c_blk=blk.c_blk,
                       runs=runs)[1], ROUTE_PEAK_FLOPS[path]


def conv_cost_us(shape: dict, blk: ConvBlocking, *, minibatch: int = 1,
                 kind: str = "fwd", whole_plane: bool = False) -> float:
    """Modeled microseconds for one conv of `shape` under blocking `blk` on
    an H100 (see the module docstring)."""
    t = conv_traffic(shape, blk, minibatch=minibatch, kind=kind,
                     whole_plane=whole_plane)
    util, peak = (_streams_util(shape, blk, minibatch=minibatch)
                  if kind == "streams" else (1.0, F32_PEAK_FLOPS))
    roof = kernel_roofline(flops=t["flops"], hbm_bytes=t["hbm_bytes"],
                           util=util, peak=peak)
    return roof["cost_s"] * 1e6


def can_measure(backend: str) -> bool:
    """Timings mean something only on the card: backend "cuda"."""
    return backend == "cuda"


def measure_conv_us(shape: dict, blk: ConvBlocking, *, kind: str = "fwd",
                    minibatch: int = 1, warmup: int = 2,
                    iters: int = 5) -> float:
    """Median microseconds of one launch of the real kernel under `blk`, by
    CUDA events around each of ``iters`` launches after ``warmup``, on
    inputs made on the card from seed 0.  Only "streams" (K4) takes a
    blocking in the port; the other kinds raise."""
    global measurements
    if kind != "streams":
        raise NotImplementedError(
            f"kind {kind!r}: K1, K2 and K3 choose their tiles inside their "
            f".cu files; tuning them is the tile-tuning slice's work")
    import torch

    h, w, c, k = shape["h"], shape["w"], shape["c"], shape["k"]
    r, s = shape["r"], shape["s"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((minibatch, h, w, c), generator=gen, device="cuda")
    wt = torch.randn((r, s, c, k), generator=gen, device="cuda") * 0.1

    def run():
        # blocking= pins all four knobs and skips the autotune consult:
        # re-entering the tuner here would recurse on the same key
        return conv2d_streams_auto(x, wt, stride=shape["stride"],
                                   padding=shape["padding"], blocking=blk)

    measurements += 1
    for _ in range(warmup):
        run()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        start.record()
        run()
        end.record()
    torch.cuda.synchronize()
    ts = sorted(start.elapsed_time(end) for start, end in events)
    return ts[len(ts) // 2] * 1e3


def rank_conv(shape: dict, candidates: list[ConvBlocking], *,
              kind: str = "fwd", backend: str = "cuda", minibatch: int = 1,
              measure_top: int = 8) -> list[tuple[float, ConvBlocking]]:
    """Score candidates; returns (score_us, blocking) sorted best-first.

    The model scores all; on the card the model's ``measure_top`` best are
    timed and ranked by time alone.  A candidate that fails on the card
    raises: nothing falls back to the model there."""
    scored = sorted(
        ((conv_cost_us(shape, b, minibatch=minibatch, kind=kind), b)
         for b in candidates), key=lambda t: t[0])
    if not can_measure(backend):
        return scored
    timed = [(measure_conv_us(shape, b, kind=kind, minibatch=minibatch), b)
             for _, b in scored[:measure_top]]
    timed.sort(key=lambda t: t[0])
    return timed
