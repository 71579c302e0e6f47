"""Blocking selection (paper §II-B/C/D), the port's counterpart of
``repro/core/blocking.py`` for the conv kinds.

A blocking is the reference's: ``rb_p`` output rows per tile (paper RB_P),
``rb_q`` output columns (RB_Q), ``k_blk`` output and ``c_blk`` input
features per block, and the dryrun loop ``order`` (§II-C).  The field names
are the reference's, so a cache entry reads the same in both packages.  On
this port only K4 (``kernels/conv2d_streams``) takes a blocking: K1, K2 and
K3 pick their CTA tiles inside their ``.cu`` files.

What the working set models here.  ``conv_working_set`` is the reference's
per-step residency sum, unchanged: the input (the ``c_blk`` slice of the
padded plane for "streams", else the streamed row band), the weight block,
the output tile and its f32 accumulator.  On the TPU that sum must fit the
core's VMEM.  On an H100 the nearest store is one CTA's shared memory, so
the default budget ``VMEM_BUDGET`` is the most a CTA may claim: 227 KB
(232,448 bytes), not the TPU's 16 MiB.  It bounds the candidate space to
tiles whose operands one SM could hold next to it.  K4 itself stages an
8-channel slice at a time and keeps the accumulator in registers, so its
real shared-memory use (~12-25 KB) does not grow with the blocking; the
budget shapes what the tuner searches, and the card's timings decide.
``REPRO_VMEM_BUDGET`` sets another budget.  Called with the reference's
budget, every function here returns exactly what the reference returns.

Two selection paths:

  * ``conv_blocking_analytic`` — the closed-form heuristic; always
    available, and the seed candidate of the tuner.
  * ``conv_blocking`` — the public entry.  With autotuning on
    (``backend.get_autotune`` / ``REPRO_AUTOTUNE`` / ``autotune=``) it
    consults ``repro_torch.tune``'s per-shape cache first ("cache": the
    cached winner, else analytic; "tune": search and persist on a miss).
"""
from __future__ import annotations

import dataclasses
import math
import os

from repro_torch import backend as be

# bytes one CTA may claim (H100: 227 KB of shared memory per block)
VMEM_BUDGET = int(os.environ.get("REPRO_VMEM_BUDGET", 232448))
# the reference's default budget (16 MiB), which the whole-plane kernels
# K10a-c take their blocking at: their plane stays in L2 (50 MB), not in a
# CTA's shared memory, and this budget gives the reference's rb_p and k_blk
WHOLE_PLANE_BUDGET = 16 * 1024 * 1024
LANE = 128          # widest feature block
SUBLANE = 8         # feature blocks are multiples of 8 (``lane_ok``)
M_TILE = 128        # pixels per tile the analytic heuristic aims for


@dataclasses.dataclass(frozen=True)
class ConvBlocking:
    rb_p: int          # output rows per microkernel (paper RB_P)
    k_blk: int         # output-feature block (paper's K_b vector block)
    c_blk: int         # input-feature block (C_b accumulation passes)
    order: str         # grid/dryrun loop order (paper §II-C)
    vmem_bytes: int    # modeled working set
    rb_q: int = 0      # output cols per microkernel (paper RB_Q; 0 = full Q)


def divisors(x: int):
    return [d for d in range(1, x + 1) if x % d == 0]


def aligned_block(dim: int) -> int:
    """Largest multiple-of-8 divisor of `dim` up to 128: the feature block
    every kernel's ``dim % blk == 0`` check accepts (non-powers of two such
    as Inception's 192 included)."""
    for d in range(min(dim, LANE) - min(dim, LANE) % SUBLANE, 0, -SUBLANE):
        if dim % d == 0:
            return d
    return min(dim, LANE)


def conv_working_set(*, h: int, w: int, c: int, k_blk: int, r: int, s: int,
                     q: int, rb_p: int, padding: int, dtype_bytes: int = 4,
                     stride: int = 1, c_blk: int | None = None,
                     rb_q: int | None = None,
                     whole_plane: bool = False,
                     kind: str = "fwd") -> int:
    """Modeled per-step bytes of a conv blocking candidate.

    Tiled (default): the input is one row band —
    ``((rb_p-1)*stride + r) x ((rb_q-1)*stride + s) x c_blk``.
    ``whole_plane=True`` (the "streams" model) holds the ``c_blk`` slice of
    the full padded plane instead.  ``kind``: "fwd"/"bwd" hold a weight
    block and an output tile + f32 accumulator beside the input; "wu"
    holds a dO pixel tile and the (r, s, C_blk, K_blk) f32 weight-gradient
    tile; "q8" (``dtype_bytes=1``) streams int8 operands but keeps an f32
    output tile and an int32 accumulator.
    """
    c_blk = c if not c_blk else c_blk
    rb_q = q if not rb_q else rb_q
    if whole_plane:
        hp, wp = h + 2 * padding + r, w + 2 * padding   # padded upper bound
        x_bytes = hp * wp * c_blk * dtype_bytes
    else:
        band_h = (rb_p - 1) * stride + r
        band_w = (rb_q - 1) * stride + s
        x_bytes = band_h * band_w * c_blk * dtype_bytes
    if kind == "wu":
        do_tile = rb_p * rb_q * k_blk * dtype_bytes
        dw_acc = r * s * c_blk * k_blk * 4           # f32 revisited tile
        return x_bytes + do_tile + dw_acc
    wblk = r * s * c_blk * k_blk * dtype_bytes
    out_bytes = 4 if kind == "q8" else dtype_bytes   # q8 stores f32 (§II-K)
    out = rb_p * rb_q * k_blk * out_bytes
    acc = rb_p * rb_q * k_blk * 4
    return x_bytes + wblk + out + acc


def conv_blocking_analytic(*, h: int, w: int, c: int, k: int, r: int, s: int,
                           stride: int, padding: int, dtype_bytes: int = 4,
                           vmem_budget: int = VMEM_BUDGET,
                           require_divisor: bool = False,
                           whole_plane: bool | None = None,
                           kind: str = "fwd") -> ConvBlocking:
    """Closed-form heuristic (no cache consulted).

    ``whole_plane`` (default: ``require_divisor``) selects the resident-
    plane model: the legacy update pass (``require_divisor``, rb_p | P)
    holds the full-C plane, "streams" a ``c_blk`` slice of it.  Otherwise
    the input is the row band: C stays unblocked (one accumulation pass)
    and RB_Q the full row unless even a one-row band overflows the budget.
    Then rb_p grows from 1 until the tile holds ``M_TILE`` pixels ("wu" and
    "q8" grow to the budget) or the next step would overflow; when even
    rb_p = 1 overflows, rb_p = 1 is returned all the same.  1x1 convs take
    order "npkc", the rest "nkpc" (§II-C).
    """
    p = (h + 2 * padding - r) // stride + 1
    q = (w + 2 * padding - s) // stride + 1
    k_blk = aligned_block(k)
    whole = require_divisor if whole_plane is None else whole_plane
    ws_kind = kind if kind in ("wu", "q8") else "fwd"

    # c_blk is the reported knob; c_model is what the working set holds
    # (the legacy update pass keeps its plane at full C)
    rb_q = q
    if require_divisor:
        c_blk, c_model = aligned_block(c), c
    elif whole:
        c_blk = c_model = aligned_block(c)
    else:
        c_blk = c_model = c

    def ws(rb_p: int, c_m: int, rb_q: int) -> int:
        return conv_working_set(h=h, w=w, c=c, k_blk=k_blk, r=r, s=s, q=q,
                                rb_p=rb_p, padding=padding,
                                dtype_bytes=dtype_bytes, stride=stride,
                                c_blk=c_m, rb_q=rb_q, whole_plane=whole,
                                kind=ws_kind)

    if not whole:
        if ws(1, c_model, rb_q) > vmem_budget:
            c_blk = c_model = aligned_block(c)
        while ws(1, c_model, rb_q) > vmem_budget and rb_q > 1:
            rb_q = math.ceil(rb_q / 2)          # wide image: block the row

    cands = divisors(p) if require_divisor else list(range(1, p + 1))
    grow_to_budget = kind in ("wu", "q8") and not whole
    best = cands[0]
    for rb in cands:
        if ws(rb, c_model, rb_q) > vmem_budget:
            break
        best = rb
        if rb * rb_q >= M_TILE and not grow_to_budget:
            break
    order = "npkc" if (r == 1 and s == 1) else "nkpc"
    return ConvBlocking(rb_p=best, k_blk=k_blk, c_blk=c_blk, order=order,
                        vmem_bytes=ws(best, c_model, rb_q), rb_q=rb_q)


def conv_blocking(*, h: int, w: int, c: int, k: int, r: int, s: int,
                  stride: int, padding: int, dtype_bytes: int = 4,
                  vmem_budget: int = VMEM_BUDGET,
                  require_divisor: bool = False,
                  backend: str | None = None,
                  autotune: str | None = None,
                  kind: str | None = None,
                  minibatch: int = 1) -> ConvBlocking:
    """Public blocking choice: the tuned winner when there is one, else the
    analytic answer.

    ``autotune`` None reads ``repro_torch.backend.get_autotune`` ("off" by
    default: pure analytic).  ``backend`` is the device type the blocking
    runs on ("cuda" or "cpu"; None resolves the default device, which
    raises without a GPU); it is part of the cache key, as are ``kind`` and
    ``minibatch``.  A budget other than the default never consults the
    cache: the key has no budget coordinate.  Only the "streams" kind
    consults it: K4 is the one port kernel that runs a ``ConvBlocking``;
    K1, K2 and K3 are tuned over their own plans
    (``repro_torch.tune.resolve_plan``), whose entries share the key.
    """
    mode = be.resolve_autotune(autotune)
    kind = kind or ("wu" if require_divisor else "fwd")
    if mode != "off" and vmem_budget == VMEM_BUDGET and kind == "streams":
        if backend is None:
            backend = be.resolve_device(None).type
        blk = _tuned_conv(mode, h=h, w=w, c=c, k=k, r=r, s=s, stride=stride,
                          padding=padding, dtype_bytes=dtype_bytes, kind=kind,
                          backend=backend, minibatch=minibatch)
        if blk is not None:
            if not require_divisor or _out_p(h, r, stride, padding) % blk.rb_p == 0:
                return blk
    return conv_blocking_analytic(h=h, w=w, c=c, k=k, r=r, s=s,
                                  stride=stride, padding=padding,
                                  dtype_bytes=dtype_bytes,
                                  vmem_budget=vmem_budget,
                                  require_divisor=require_divisor,
                                  whole_plane=(True if kind == "streams"
                                               else None),
                                  kind=kind)


def _out_p(h: int, r: int, stride: int, padding: int) -> int:
    return (h + 2 * padding - r) // stride + 1


def _tuned_conv(mode: str, **kw) -> ConvBlocking | None:
    # lazy: repro_torch.tune imports this module
    from repro_torch import tune
    if mode == "tune":
        return tune.autotune_conv(**kw)
    return tune.lookup_conv(**kw)
