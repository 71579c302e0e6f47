"""Blocking search space (paper §II-D: the per-shape specialization axis),
the port's counterpart of ``repro/tune/space.py`` for convs.

The coordinates are the blocking's:

  rb_p   output rows per tile (paper RB_P)
  rb_q   output columns per tile (paper RB_Q; the full row for "streams")
  k_blk  output-feature block (paper K_b; divides K)
  c_blk  input-feature block (paper C_b accumulation; divides C)
  order  dryrun loop order over (N, K_b, P_b, C_b) (paper §II-C)

``conv_candidates`` enumerates the feasible cross product — budget-
filtered, multiples of 8, divisors — with the analytic blocking first, so
the search never does worse than the heuristic.  Kinds, as in the
reference: "fwd", "bwd", "wu", "streams", "q8".  Only "streams" has a
consumer in the port (K4); the others are enumerated with the same
arithmetic, for the later slices that give K1/K2/K3 a blocking.
"""
from __future__ import annotations

from repro_torch.core.blocking import (LANE, SUBLANE, VMEM_BUDGET,
                                       ConvBlocking, conv_blocking_analytic,
                                       conv_working_set, divisors)

ORDERS = ("nkpc", "npkc", "knpc", "pknc")
MAX_CANDIDATES = 128


def out_dim(h: int, r: int, stride: int, padding: int) -> int:
    return (h + 2 * padding - r) // stride + 1


def _feature_blocks(dim: int) -> list[int]:
    """Divisors of `dim` that are multiples of 8 and at most 128."""
    blocks = [d for d in divisors(dim) if d % SUBLANE == 0 and d <= LANE]
    return blocks or [dim]          # tiny dims: single un-aligned block


def _rb_candidates(p: int, *, require_divisor: bool) -> list[int]:
    if require_divisor:
        cands = divisors(p)
    else:
        # divisors (exact grids) + powers of two (ceil-div grids) + full P
        cands = set(divisors(p))
        rb = 1
        while rb < p:
            cands.add(rb)
            rb *= 2
        cands.add(p)
        cands = sorted(cands)
    if len(cands) > 12:             # spread-sample large spatial dims
        step = len(cands) / 12
        cands = sorted({cands[int(i * step)] for i in range(12)} | {cands[-1]})
    return cands


def _rb_q_candidates(q: int) -> list[int]:
    """RB_Q column blocks: the full row plus a few power-of-two blocks."""
    return sorted({q} | {b for b in (8, 16, 32, 64, 128) if b < q})


def conv_candidates(*, h: int, w: int, c: int, k: int, r: int, s: int,
                    stride: int, padding: int, dtype_bytes: int = 4,
                    kind: str = "fwd",
                    vmem_budget: int = VMEM_BUDGET) -> list[ConvBlocking]:
    """Feasible blockings, analytic seed first, deduplicated, capped at
    ``MAX_CANDIDATES`` by spread sampling."""
    assert kind in ("fwd", "bwd", "wu", "streams", "q8"), kind
    p = out_dim(h, r, stride, padding)
    q = out_dim(w, s, stride, padding)
    whole = kind == "streams"       # only streams models the whole plane
    seed = conv_blocking_analytic(
        h=h, w=w, c=c, k=k, r=r, s=s, stride=stride, padding=padding,
        dtype_bytes=dtype_bytes, vmem_budget=vmem_budget,
        whole_plane=(True if whole else None), kind=kind)

    k_blocks = _feature_blocks(k)
    if kind == "wu":
        # update pass: c_blk / rb_q free, grid order fixed
        c_blocks = sorted({c} | set(_feature_blocks(c)), reverse=True)
        orders = (seed.order,)
        rb_qs = _rb_q_candidates(max(q, 1))
    elif kind == "streams":
        c_blocks = _feature_blocks(c)
        orders = ORDERS
        rb_qs = [q]
    else:
        # fwd/bwd/q8: full-C single pass first, then C_b blocks
        c_blocks = sorted({c} | set(_feature_blocks(c)), reverse=True)
        orders = ORDERS
        rb_qs = _rb_q_candidates(max(q, 1))
    rbs = _rb_candidates(max(p, 1), require_divisor=False)
    ws_kind = kind if kind in ("wu", "q8") else "fwd"

    pool: list[ConvBlocking] = []
    seen = {(seed.rb_p, seed.k_blk, seed.c_blk, seed.order,
             seed.rb_q or q)}
    for rb in rbs:
        for kb in k_blocks:
            for cb in c_blocks:
                for rq in rb_qs:
                    ws = conv_working_set(
                        h=h, w=w, c=c, k_blk=kb, r=r, s=s, q=q, rb_p=rb,
                        padding=padding, dtype_bytes=dtype_bytes,
                        stride=stride, c_blk=cb, rb_q=rq,
                        whole_plane=whole, kind=ws_kind)
                    if ws > vmem_budget:
                        continue
                    for order in orders:
                        key = (rb, kb, cb, order, rq)
                        if key in seen:
                            continue
                        seen.add(key)
                        pool.append(ConvBlocking(rb_p=rb, k_blk=kb, c_blk=cb,
                                                 order=order, vmem_bytes=ws,
                                                 rb_q=rq))
    if len(pool) > MAX_CANDIDATES - 1:
        # spread-sample the (rb_p-major) pool: a prefix cut would never
        # leave the first rb_p value
        step = len(pool) / (MAX_CANDIDATES - 1)
        pool = [pool[int(i * step)] for i in range(MAX_CANDIDATES - 1)]
    return [seed] + pool
