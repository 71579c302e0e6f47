"""Candidate scoring: device time on the card, a cost model everywhere
else — the port's counterpart of ``repro/tune/measure.py`` for convs.

On the card (backend "cuda") the model shortlists ``measure_top``
candidates and each is timed over the real kernel, the paper's empirical
specialization.  The time is device time: ``device_us`` queues a
``torch.cuda._sleep`` busy kernel ahead of the timed launches, so the host
has queued them all before the card reaches the first, and CUDA events
around each launch then read the kernel alone, not the wrapper's host
time (about 50 us a call beside K3's 1.0 ms of device time a 52-conv
forward on an NVIDIA H100 80GB HBM3 at 700 W, ``PERF.md``: more than most
of these kernels take on the device).  It checks that the events found no gap
between launches, and lengthens the sleep where they did.  On the CPU a
wall clock would time PyTorch's CPU kernels, so candidates are ranked by
the model alone.

For "streams" (K4, which takes a ``ConvBlocking``) the model is

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
  ``F32_PEAK_FLOPS``.  ``conv_cost_us`` prices a ``ConvBlocking`` of the
  other kinds at util 1 of the f32 peak, the bare roofline: no port kernel
  runs one.
* No per-step overhead term: the TPU's grid-step pipeline fill has no
  counterpart in a kernel whose steps run in parallel CTAs.

The kinds "fwd" and "bwd" (K1), "wu" (K2) and "q8" (K3) are tuned over the
kernels' own plans (``space.plan_candidates``), and ``plan_cost_us``
scores a plan by the kernel's own model: K1's ``_mma_cost``, K2's rounds
x chunk (``conv2d_wu.mma_cost``), K3's ring estimate
(``conv2d_q8.ring_cost``).  ``rank_plans`` always times the kernel's
default plan, and keeps it unless another plan measured at least
``MIN_GAIN`` faster, there and again in turns with it.  The whole-plane kinds ("fwd_whole", "bwd_whole",
"q8_whole", "wu_whole") rank their ``ConvBlocking`` candidates the same
way: the model is ``conv_cost_us`` of the base kind with the whole plane
shipped per step (the reference's bytes of the legacy kernels), and the
card times K10a, K10c or K10b under each.
"""
from __future__ import annotations

import math

from repro_torch.core.blocking import ConvBlocking
from repro_torch.kernels import conv2d_direct as k1
from repro_torch.kernels import conv2d_q8 as k3
from repro_torch.kernels import conv2d_wu as k2
from repro_torch.kernels.conv2d_streams import (ROUTE_PEAK_FLOPS,
                                                conv2d_streams_auto,
                                                mma_stage_c, mma_tile_config,
                                                route_of, tile_config)
from repro_torch.launch.roofline import F32_PEAK_FLOPS, kernel_roofline
from repro_torch.tune.space import WHOLE_KINDS, out_dim, whole_base

# Stable keys of the ``chain_traffic`` decision dict (the reference's).
CHAIN_TRAFFIC_KEYS = ("fused", "fits_vmem", "rb", "n_bands", "vmem_bytes",
                      "flops", "x_bytes", "w_bytes", "o_bytes", "hbm_bytes",
                      "intermediate_bytes", "unfused_hbm_bytes",
                      "unfused_intermediate_bytes", "n_steps", "n_layers")
# Kernel timings taken since the last reset (set to 0 to reset): a pass
# that should only read the cache must leave it unchanged.
measurements = 0
# A tuned plan replaces the kernel's default only when it measured at
# least this share faster: closer than that, a device-time reading of the
# same kernel varies by as much from one run to the next.
MIN_GAIN = 0.02
# Events around queued launches read under this many ms apart when the
# card runs them back to back; a wider gap means the host fell behind.
_GAP_MS = 0.01
_sleep_cycles_per_ms: float | None = None


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


def chain_traffic(shapes: list, *, minibatch: int = 1,
                  vmem_budget: int | None = None) -> dict:
    """Price a depth-first conv->conv chain against its unfused run and
    decide whether to fuse it, the reference's model unchanged.

    ``shapes``: one conv shape dict per layer, producers first.  The fused
    price walks the chain's band schedule (``streams.build_chain_schedule``)
    and charges each band step the ``conv_traffic`` of that band under the
    layer's full-shape analytic blocking (at the reference's budget):
    layer 0's input bands come from memory, halo rows again for each band;
    a hand-off band (FLAG_HANDOFF) is neither written nor read back; each
    step reads its weights; only the final layer's bands are written.

    Fuse iff the chain's band fits ``vmem_budget``
    (``core.blocking.chain_blocking``; None: ``CHAIN_BUDGET``) and the
    fused bytes do not exceed the unfused sum.  On fallback the reported
    traffic is the unfused sum.  Returns ``CHAIN_TRAFFIC_KEYS`` plus
    ``parts``/``unfused_parts`` (the per-launch ``conv_traffic`` dicts,
    for ``launch.roofline.chain_roofline``)."""
    from repro_torch.core.blocking import chain_blocking, chain_layer_blocking
    from repro_torch.core.streams import FLAG_HANDOFF, build_chain_schedule

    n = minibatch
    dtype_bytes = shapes[0].get("dtype_bytes", 4)
    blks, unfused_parts, dims = [], [], []
    for sh in shapes:
        blk = chain_layer_blocking(sh, sh.get("dtype_bytes", 4))
        blks.append(blk)
        unfused_parts.append(conv_traffic(sh, blk, minibatch=n))
        dims.append((out_dim(sh["h"], sh["r"], sh["stride"], sh["padding"]),
                     out_dim(sh["w"], sh["s"], sh["stride"], sh["padding"])))
    unfused_hbm = sum(p["hbm_bytes"] for p in unfused_parts)
    # unfused, every intermediate activation is written and read back
    unfused_inter = sum(2.0 * dims[l][0] * dims[l][1] * shapes[l]["k"]
                        * shapes[l].get("dtype_bytes", 4) * n
                        for l in range(len(shapes) - 1))

    cb = chain_blocking(shapes, vmem_budget=vmem_budget,
                        dtype_bytes=dtype_bytes, blockings=blks)
    sched = build_chain_schedule(
        rs=[(sh["r"], sh["stride"], sh["padding"]) for sh in shapes],
        h_in=shapes[0]["h"], rb=cb.rb)

    fused = dict.fromkeys(("flops", "x_bytes", "w_bytes", "o_bytes",
                           "hbm_bytes", "n_steps"), 0.0)
    parts = []
    for i in range(len(sched)):
        l = int(sched.layer_ids[i])
        o0, o1 = int(sched.o0[i]), int(sched.o1[i])
        sh = shapes[l]
        # the padded band: its halo rows, W padded, no padding of its own
        band = dict(sh, h=(o1 - o0 - 1) * sh["stride"] + sh["r"],
                    w=sh["w"] + 2 * sh["padding"], padding=0)
        t = conv_traffic(band, blks[l], minibatch=n)
        handoff = bool(sched.flags[i] & FLAG_HANDOFF)
        x_hbm = t["x_bytes"] if l == 0 else 0.0
        o_hbm = 0.0 if handoff else t["o_bytes"]
        part = dict(t, x_bytes=x_hbm, o_bytes=o_hbm,
                    hbm_bytes=x_hbm + t["w_bytes"] + o_hbm)
        parts.append(part)
        for key in ("flops", "x_bytes", "w_bytes", "o_bytes", "hbm_bytes",
                    "n_steps"):
            fused[key] += part[key]

    fuse = cb.fits and fused["hbm_bytes"] <= unfused_hbm
    out = {
        "fused": fuse,
        "fits_vmem": cb.fits,
        "rb": cb.rb,
        "n_bands": cb.n_bands,
        "vmem_bytes": cb.vmem_bytes,
        "n_layers": len(shapes),
        "unfused_hbm_bytes": unfused_hbm,
        "unfused_intermediate_bytes": unfused_inter,
        "unfused_parts": unfused_parts,
    }
    if fuse:
        out.update(fused, intermediate_bytes=0.0, parts=parts)
    else:       # the chain runs layer by layer: priced as such
        for key in ("flops", "x_bytes", "w_bytes", "o_bytes", "n_steps"):
            out[key] = sum(p[key] for p in unfused_parts)
        out.update(hbm_bytes=unfused_hbm, intermediate_bytes=unfused_inter,
                   parts=unfused_parts)
    return out


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


def plan_cost_us(kind: str, shape: dict, plan, *,
                 minibatch: int = 1) -> float:
    """Modeled microseconds of one launch under a kernel plan of ``kind``:
    the kernel's own model (see the module docstring)."""
    n = minibatch
    p = out_dim(shape["h"], shape["r"], shape["stride"], shape["padding"])
    q = out_dim(shape["w"], shape["s"], shape["stride"], shape["padding"])
    c, k, r, s = shape["c"], shape["k"], shape["r"], shape["s"]
    if kind in ("fwd", "bwd"):
        sec = k1._mma_cost(n * p * q, k, plan.tile, plan.splits, plan.chunk)
    elif kind == "wu":
        sec = k2.mma_cost(plan, n=n, p=p, q=q, c=c, k=k, r=r, s=s)
    elif kind == "q8":
        sec = k3.ring_cost(plan)
    elif kind in WHOLE_KINDS:
        base = whole_base(kind)
        return conv_cost_us(dict(shape, dtype_bytes=1 if base == "q8" else 4),
                            plan, minibatch=minibatch, kind=base,
                            whole_plane=True)
    else:
        raise ValueError(f"kind {kind!r} takes no kernel plan")
    return sec * 1e6


def matmul_plan_cost_us(m: int, n: int, k: int, plan, *,
                        dtype_bytes: int = 2) -> float:
    """Modeled microseconds of one K6 launch under ``plan``: the blocks
    run in waves of (SMs x blocks an SM) and each block takes its share of
    the route's peak for its tile's FLOPs (``2 bm bn k``), bounded below by
    the bytes each block reads (its a rows and b columns) over HBM; a
    shallower ring adds a tenth per stage short of 4, for the loads it
    cannot hide."""
    from repro_torch.kernels import matmul_fused as k6
    from repro_torch.launch.roofline import (BF16_PEAK_FLOPS,
                                             HBM_BYTES_PER_S)
    per_sm = 2 if plan.route == "wgmma" and plan.bn == 128 else 1
    slots = k6.H100_SMS * per_sm
    tiles = -(-m // plan.bm) * -(-n // plan.bn)
    waves = -(-tiles // slots)
    peak = BF16_PEAK_FLOPS if plan.route == "wgmma" else F32_PEAK_FLOPS
    flop_s = 2.0 * plan.bm * plan.bn * k / (peak / slots)
    byte_s = (plan.bm + plan.bn) * k * dtype_bytes / (HBM_BYTES_PER_S / slots)
    fill = 1.0 + 0.1 * max(0, 4 - plan.stages)
    return waves * max(flop_s, byte_s) * fill * 1e6


def measure_matmul_us(m: int, n: int, k: int, plan, *,
                      dtype_bytes: int = 2) -> float:
    """Device microseconds of one K6 launch under ``plan`` on seeded
    random operands of ``dtype_bytes`` (bf16 or f32), bias and no act
    (``device_us``)."""
    import torch

    from repro_torch.kernels import matmul_fused as k6
    dtype = torch.bfloat16 if dtype_bytes == 2 else torch.float32
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
    bias = torch.randn((n,), generator=gen, device="cuda").to(dtype)
    return device_us(lambda: k6.matmul_fused(a, b, bias=bias, plan=plan))


def rank_matmul_plans(m: int, n: int, k: int, candidates: list, *,
                      dtype_bytes: int = 2, backend: str = "cuda"
                      ) -> list[tuple[float, object]]:
    """``rank_plans`` for K6: the model (``matmul_plan_cost_us``) orders
    the candidates; on the card every candidate (at most six) is timed and
    the default, ``candidates[0]``, stays first unless another plan is at
    least ``MIN_GAIN`` faster (``keep_default_unless_faster``)."""
    scored = sorted(((matmul_plan_cost_us(m, n, k, pl,
                                          dtype_bytes=dtype_bytes), i, pl)
                     for i, pl in enumerate(candidates)),
                    key=lambda t: t[:2])
    if not can_measure(backend):
        return [(score, pl) for score, _, pl in scored]

    def time_of(pl):
        return measure_matmul_us(m, n, k, pl, dtype_bytes=dtype_bytes)
    return keep_default_unless_faster([(time_of(pl), pl) for pl in candidates],
                                      time_of)


def can_measure(backend: str) -> bool:
    """Timings mean something only on the card: backend "cuda"."""
    return backend == "cuda"


def _cycles_per_ms() -> float:
    """``torch.cuda._sleep`` cycles a millisecond on this card, read once
    by CUDA events around one sleep."""
    global _sleep_cycles_per_ms
    if _sleep_cycles_per_ms is None:
        import torch
        cycles = 10_000_000
        torch.cuda._sleep(cycles // 10)         # the kernel's first launch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _sleep_cycles_per_ms = cycles / start.elapsed_time(end)
    return _sleep_cycles_per_ms


def device_us(run, *, warmup: int = 2, iters: int = 5) -> float:
    """Median device microseconds of one call of ``run`` (its launches on
    the current stream), by CUDA events around each of ``iters`` calls
    queued behind a ``torch.cuda._sleep`` busy kernel long enough for the
    host to queue them all first.  Where the events show the card waited
    between calls (the host fell behind), the sleep is made four times
    longer and the reading taken again, up to four times; then it raises."""
    import time

    import torch
    for _ in range(warmup):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    sleep_ms = 2 * (iters + 1) * (time.perf_counter() - t0) * 1e3 + 1.0
    for _ in range(4):
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        torch.cuda._sleep(int(sleep_ms * _cycles_per_ms()))
        for start, end in events:
            start.record()
            run()
            end.record()
        torch.cuda.synchronize()
        gaps = [events[i][1].elapsed_time(events[i + 1][0])
                for i in range(iters - 1)]
        if max(gaps, default=0.0) <= _GAP_MS:
            ts = sorted(start.elapsed_time(end) for start, end in events)
            return ts[len(ts) // 2] * 1e3
        sleep_ms *= 4
    raise RuntimeError(f"the host fell behind the card while timing: "
                       f"{max(gaps):.4f} ms between launches behind a "
                       f"{sleep_ms / 4:.1f} ms sleep")


def conv_inputs(kind: str, shape: dict, minibatch: int) -> dict:
    """The timed kernel's operands, made on the card from seed 0: x and w
    (K1, K4), x and dO (K2), int8 x_q and w_q with their scales (K3)."""
    import torch
    h, w, c, k = shape["h"], shape["w"], shape["c"], shape["k"]
    r, s = shape["r"], shape["s"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    if kind == "q8":
        def i8(*size):
            return torch.randint(-127, 128, size, generator=gen,
                                 device="cuda", dtype=torch.int8)
        return dict(x_q=i8(minibatch, h, w, c), w_q=i8(r, s, c, k),
                    x_scale=torch.full((), 0.02, device="cuda"),
                    w_scale=torch.rand(k, generator=gen, device="cuda")
                    * 0.01 + 0.001)
    x = torch.randn((minibatch, h, w, c), generator=gen, device="cuda")
    if kind == "wu":
        p = out_dim(h, r, shape["stride"], shape["padding"])
        q = out_dim(w, s, shape["stride"], shape["padding"])
        return dict(x=x, do=torch.randn((minibatch, p, q, k), generator=gen,
                                        device="cuda"))
    return dict(x=x, w=torch.randn((r, s, c, k), generator=gen,
                                   device="cuda") * 0.1)


def kernel_call(kind: str, shape: dict, args: dict, blk):
    """A call of the real kernel of ``kind`` on ``args`` (``conv_inputs``)
    without an epilogue: K4 under the ``ConvBlocking`` ``blk``
    ("streams"), K1 ("fwd", "bwd"), K2 ("wu") or K3 ("q8") under the
    plan ``blk``, or K10a ("fwd_whole", "bwd_whole"), K10c ("q8_whole")
    or K10b ("wu_whole") under the blocking ``blk``."""
    stride, padding = shape["stride"], shape["padding"]
    if kind in ("fwd_whole", "bwd_whole"):
        return lambda: k1.conv2d_direct_whole(
            **args, stride=stride, padding=padding, rb_p=blk.rb_p,
            k_blk=blk.k_blk)
    if kind == "q8_whole":
        return lambda: k3.conv2d_q8_whole(
            **args, stride=stride, padding=padding, rb_p=blk.rb_p,
            k_blk=blk.k_blk)
    if kind == "wu_whole":
        return lambda: k2.conv2d_wu_whole(
            **args, stride=stride, padding=padding,
            filter_rs=(shape["r"], shape["s"]), b_p=blk.rb_p,
            k_blk=blk.k_blk)
    if kind == "streams":
        # blocking= pins all four knobs and skips the autotune consult:
        # re-entering the tuner here would recurse on the same key
        return lambda: conv2d_streams_auto(args["x"], args["w"],
                                           stride=stride, padding=padding,
                                           blocking=blk)
    if kind == "wu":
        return lambda: k2.conv2d_wu(**args, stride=stride, padding=padding,
                                    filter_rs=(shape["r"], shape["s"]),
                                    plan=blk)
    if kind == "q8":
        return lambda: k3.conv2d_q8(**args, stride=stride, padding=padding,
                                    plan=blk)
    if kind in ("fwd", "bwd"):
        return lambda: k1.conv2d_direct(**args, stride=stride,
                                        padding=padding, plan=blk)
    raise ValueError(f"kind {kind!r}")


def measure_conv_us(shape: dict, blk, *, kind: str = "fwd",
                    minibatch: int = 1, warmup: int = 2,
                    iters: int = 10) -> float:
    """Median device microseconds of one launch of the real kernel of
    ``kind`` (``kernel_call``, timed by ``device_us``) on inputs made on
    the card from seed 0 (``conv_inputs``).  Needs the card: on the CPU it
    raises for every kind."""
    global measurements
    import torch
    if kind not in ("streams", "fwd", "bwd", "wu", "q8") + WHOLE_KINDS:
        raise ValueError(f"kind {kind!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"measure_conv_us({kind!r}) times the kernel on "
                           f"the card, and no GPU is present")
    base = whole_base(kind) if kind in WHOLE_KINDS else kind
    args = conv_inputs("fwd" if base == "streams" else base, shape,
                       minibatch)
    measurements += 1
    return device_us(kernel_call(kind, shape, args, blk), warmup=warmup,
                     iters=iters)


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


def rank_plans(kind: str, shape: dict, candidates: list, *,
               backend: str = "cuda", minibatch: int = 1,
               measure_top: int = 8) -> list[tuple[float, object]]:
    """Score kernel plans; returns (score_us, plan) sorted best-first.
    ``candidates[0]`` is the kernel's default plan.

    The model (``plan_cost_us``) scores all.  On the card the shortlist is
    the default plan and the model's ``measure_top - 1`` best of the rest;
    each is timed (``measure_conv_us``), and the list is sorted by time,
    except that the default stays first unless another plan is at least
    ``MIN_GAIN`` faster (``keep_default_unless_faster``).  A candidate
    that fails on the card raises."""
    default = candidates[0]
    scored = sorted(((plan_cost_us(kind, shape, pl, minibatch=minibatch), i,
                      pl) for i, pl in enumerate(candidates)),
                    key=lambda t: t[:2])
    if not can_measure(backend):
        return [(score, pl) for score, _, pl in scored]
    short = [default] + [pl for _, _, pl in scored
                         if pl != default][:measure_top - 1]

    def time_of(pl):
        return measure_conv_us(shape, pl, kind=kind, minibatch=minibatch)
    return keep_default_unless_faster([(time_of(pl), pl) for pl in short],
                                      time_of)


def keep_default_unless_faster(timed: list, time_of) -> list:
    """``timed``, (us, plan) pairs with the default plan first, sorted by
    time, except that the default stays first unless the fastest plan
    measured at least ``MIN_GAIN`` faster both there and again in turns
    with it (default, plan, plan, default, summed; ``time_of(plan)``
    times one plan): one reading taken while the card's clocks moved
    must not replace the default with a slower plan."""
    default, base = timed[0][1], timed[0][0]
    ranked = sorted(timed, key=lambda t: t[0])
    best_us, best = ranked[0]
    if best != default and best_us <= (1 - MIN_GAIN) * base:
        ds, bs = [time_of(default)], [time_of(best), time_of(best)]
        ds.append(time_of(default))
        if sum(bs) <= (1 - MIN_GAIN) * sum(ds):
            return ranked
    return sorted(ranked, key=lambda t: t[1] != default)
