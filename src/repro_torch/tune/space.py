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
reference: "fwd", "bwd", "wu", "streams", "q8".  Its consumer in the port
is K4 ("streams"); the reference's arithmetic is kept for every kind.

K1, K2 and K3 take no ``ConvBlocking``: each cuts a conv by a plan of its
own (tile, split of the reduction, chunk; K3 also the stage depth), which
``plan_candidates`` lists for the kinds "fwd" and "bwd" (K1's
``MmaPlan``), "wu" (K2's ``WuPlan``) and "q8" (K3's ``RingPlan``): every
tile the kernel's ``.cu`` file instantiates, crossed with the splits whose
chunks keep the kernel's own least chunk, with the kernel's default plan
first.

The fused matmul K6 takes a ``MatmulPlan`` (kind "matmul"): on its wgmma
route the block's n-width and the ring's stages, on its SIMT route the
block's BM x BN.  ``plan_candidates("matmul", m=, n=, k=, dtype_bytes=)``
lists every plan the route's ``.cu`` file instantiates, the default
first; ``matmul_candidates`` is the reference's list of
``MatmulBlocking`` for the same shape, kept for its record.

The whole-plane kernels K10a, K10b and K10c take the reference's
``ConvBlocking`` (rb_p output rows by the full row, k_blk output
channels), which the kinds "fwd_whole" and "bwd_whole" (K10a's forward
and dual convs), "q8_whole" (K10c) and "wu_whole" (K10b, whose rb_p is
its b_p) tune: ``plan_candidates`` lists the (rb_p, k_blk) pairs of
``conv_candidates`` at the reference's budget ``WHOLE_PLANE_BUDGET``
whose k_blk divides K (and, for "wu_whole", rb_p divides P), the
analytic blocking (what ``core.conv.whole_blocking`` takes with
autotuning off) first.  Each kernel's cut of a block across CTAs
(``whole_split``, ``plan_whole``) stays a function of the blocking.
"""
from __future__ import annotations

from repro_torch.core.blocking import (LANE, SUBLANE, VMEM_BUDGET,
                                       WHOLE_PLANE_BUDGET, ConvBlocking,
                                       MatmulBlocking,
                                       conv_blocking_analytic,
                                       conv_working_set, divisors,
                                       matmul_blocking_analytic)
from repro_torch.kernels import conv2d_direct as k1
from repro_torch.kernels import conv2d_q8 as k3
from repro_torch.kernels import conv2d_wu as k2
from repro_torch.kernels import matmul_fused as k6

ORDERS = ("nkpc", "npkc", "knpc", "pknc")
MAX_CANDIDATES = 128
PLAN_KINDS = ("fwd", "bwd", "wu", "q8")
MATMUL_KIND = "matmul"
WHOLE_KINDS = ("fwd_whole", "bwd_whole", "q8_whole", "wu_whole")


def whole_base(kind: str) -> str:
    """The blocking kind of a whole-plane kind: "fwd_whole" -> "fwd"."""
    if kind not in WHOLE_KINDS:
        raise ValueError(f"kind {kind!r} is not one of {WHOLE_KINDS}")
    return kind[:-len("_whole")]


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


# -- kernel plans (K1, K2, K3) -------------------------------------------------

def plan_applies(kind: str, *, c: int, k: int) -> bool:
    """Whether a conv of channels (C, K) launches a kernel that takes a
    plan of ``kind``: a lane-aligned conv (``core.conv.lane_ok``; the rest
    take the reference path) on K1's or K2's mma route (C, K multiples of
    4) or K3's ring route (C % 16, K % 8); for a whole-plane kind, every
    lane-aligned conv (K10a-c take a blocking on either route)."""
    if kind not in PLAN_KINDS + WHOLE_KINDS:
        raise ValueError(f"kind {kind!r} takes no kernel plan; plan kinds: "
                         f"{PLAN_KINDS + WHOLE_KINDS}")
    if c % SUBLANE or k % SUBLANE:
        return False
    return c % 16 == 0 if kind == "q8" else True


def default_plan(kind: str, *, n: int, h: int, w: int, c: int, k: int,
                 r: int, s: int, stride: int, padding: int):
    """The kernel's own plan for the shape: ``mma_plan`` (K1),
    ``plan(route="mma")`` (K2) or ``ring_plan`` (K3); for a whole-plane
    kind the analytic blocking at ``WHOLE_PLANE_BUDGET`` (``n`` plays no
    part in it)."""
    if kind in WHOLE_KINDS:
        base = whole_base(kind)
        return conv_blocking_analytic(
            h=h, w=w, c=c, k=k, r=r, s=s, stride=stride, padding=padding,
            dtype_bytes=1 if base == "q8" else 4,
            vmem_budget=WHOLE_PLANE_BUDGET, require_divisor=base == "wu",
            kind=base)
    p, q = out_dim(h, r, stride, padding), out_dim(w, s, stride, padding)
    if kind in ("fwd", "bwd"):
        return k1.mma_plan(n=n, p=p, q=q, c=c, k=k, r=r, s=s)
    if kind == "wu":
        return k2.plan(n=n, p=p, q=q, c=c, k=k, r=r, s=s, route="mma")
    if kind == "q8":
        return k3.ring_plan(n, p, q, c, k, r, s, stride)
    raise ValueError(f"kind {kind!r} takes no kernel plan")


def check_plan(kind: str, plan, *, n: int, h: int, w: int, c: int, k: int,
               r: int, s: int, stride: int, padding: int) -> None:
    """The kernel's own validation of ``plan`` for the shape (raises
    ``ValueError``)."""
    p, q = out_dim(h, r, stride, padding), out_dim(w, s, stride, padding)
    if kind in WHOLE_KINDS:
        _check_whole(whole_base(kind), plan, n=n, p=p, q=q, c=c, k=k, r=r,
                     s=s, stride=stride)
        return
    check = {"fwd": k1.check_mma_plan, "bwd": k1.check_mma_plan,
             "wu": k2.check_wu_plan, "q8": k3.check_ring_plan}.get(kind)
    if check is None:
        raise ValueError(f"kind {kind!r} takes no kernel plan")
    check(plan, n=n, p=p, q=q, c=c, k=k, r=r, s=s)


def _check_whole(base: str, blk, *, n, p, q, c, k, r, s, stride) -> None:
    """A whole-plane blocking the kernel of ``base`` runs on the shape: a
    ``ConvBlocking`` with rb_p >= 1 (dividing P for "wu") and a k_blk of
    the multiples of 8 up to 128 that divides K, which the kernel's own
    plan of its main route takes (K10a's and K10c's ``whole_mma_plan``
    with their row and channel cuts, K10b's ``plan_whole``)."""
    if not isinstance(blk, ConvBlocking):
        raise ValueError(f"a whole-plane kind takes a ConvBlocking, not "
                         f"{blk!r}")
    if blk.rb_p < 1 or blk.k_blk < 1 or k % blk.k_blk or blk.k_blk % 8 \
            or blk.k_blk > LANE:
        raise ValueError(f"whole-plane blocking rb_p {blk.rb_p}, k_blk "
                         f"{blk.k_blk} for K={k}: k_blk must be a multiple "
                         f"of 8 up to {LANE} dividing K")
    geo = dict(n=n, p=p, q=q, k=k, rb_p=blk.rb_p, k_blk=blk.k_blk)
    if base == "wu":
        k2.plan_whole(n=n, p=p, q=q, c=c, k=k, r=r, s=s, b_p=blk.rb_p,
                      k_blk=blk.k_blk)
    elif base == "q8":
        k3.whole_mma_plan(p=p, q=q, k_blk=k3.whole_k_cta(**geo),
                          rb_p=blk.rb_p, r=r, s=s, stride=stride,
                          rows_cta=k3.whole_rows_cta(**geo))
    else:
        k1.whole_mma_plan(p=p, q=q, k_blk=blk.k_blk, rb_p=blk.rb_p, r=r,
                          s=s, stride=stride,
                          rows_cta=k1.whole_rows_cta(**geo))


def _whole_blockings(kind, *, n, h, w, c, k, r, s, stride, padding):
    """The (rb_p, k_blk) pairs of ``conv_candidates`` at
    ``WHOLE_PLANE_BUDGET``, one blocking each, that the kernel runs."""
    base = whole_base(kind)
    p, q = out_dim(h, r, stride, padding), out_dim(w, s, stride, padding)
    out, seen = [], set()
    for blk in conv_candidates(h=h, w=w, c=c, k=k, r=r, s=s, stride=stride,
                               padding=padding,
                               dtype_bytes=1 if base == "q8" else 4,
                               kind=base, vmem_budget=WHOLE_PLANE_BUDGET):
        if (blk.rb_p, blk.k_blk) in seen:
            continue
        seen.add((blk.rb_p, blk.k_blk))
        try:
            _check_whole(base, blk, n=n, p=p, q=q, c=c, k=k, r=r, s=s,
                         stride=stride)
        except ValueError:
            continue
        out.append(blk)
    return out


def _mma_plans(*, n, p, q, c, k, r, s):
    """K1: each tile of ``MMA_TILES`` by each split whose chunks keep at
    least ``MMA_MIN_CHUNK`` steps (one split where the steps are fewer),
    none empty."""
    steps = k1.mma_steps(c=c, r=r, s=s)
    most = min(max(1, steps // k1.MMA_MIN_CHUNK), k1.MAX_GRID_Z)
    out = []
    for tile in k1.MMA_TILES:
        for splits in range(1, most + 1):
            chunk = -(-steps // splits)
            if -(-steps // chunk) == splits:
                out.append(k1.make_mma_plan(n=n, p=p, q=q, k=k, tile=tile,
                                            splits=splits, chunk=chunk))
    return out


def _wu_plans(*, n, p, q, c, k, r, s):
    """K2: each tile of ``MMA_TILES`` by each chunk of whole
    ``MMA_PIX_STEP`` stages from ``MMA_MIN_CHUNK`` to ``MMA_MAX_CHUNK``
    pixels (one chunk of all the pixels where they are fewer), none empty,
    splits x R x S within the grid."""
    m = n * p * q
    step = k2.MMA_PIX_STEP
    chunks = range(k2.MMA_MIN_CHUNK, k2.MMA_MAX_CHUNK + 1, step)
    if m <= k2.MMA_MIN_CHUNK:
        chunks = [-(-m // step) * step]
    seen, out = set(), []
    for tile in k2.MMA_TILES:
        for chunk in chunks:
            splits = -(-m // chunk)
            # the least chunk of whole stages for this many splits
            chunk = -(-(-(-m // splits)) // step) * step
            if (tile, splits) in seen or (splits - 1) * chunk >= m \
                    or splits * r * s > k2.MAX_GRID_Z:
                continue
            seen.add((tile, splits))
            out.append(k2.WuPlan(tile=tile, splits=splits, chunk=chunk,
                                 route="mma"))
    return out


def _ring_plans(*, n, p, q, c, k, r, s):
    """K3: each tile of ``RING_TILES`` by each stage depth of ``RING_BK``
    that C fills (64 always; 128 where C reaches 128) by each split that
    keeps ``RING_MIN_SPLIT_STEPS`` steps a split."""
    out = []
    for bm, bn in k3.RING_TILES:
        for bk in k3.RING_BK:
            if bk > c and bk > min(k3.RING_BK):
                continue
            steps = r * s * -(-c // bk)
            most = min(max(1, steps // k3.RING_MIN_SPLIT_STEPS),
                       k3.MAX_GRID_Z)
            for splits in range(1, most + 1):
                out.append(k3.make_ring_plan(n=n, p=p, q=q, c=c, k=k, r=r,
                                             s=s, bm=bm, bn=bn, bk=bk,
                                             splits=splits))
    return out


def matmul_candidates(m: int, n: int, k: int, *, dtype_bytes: int = 2,
                      vmem_budget: int = WHOLE_PLANE_BUDGET
                      ) -> list[MatmulBlocking]:
    """The reference's matmul tile candidates (bm, bn, bk dividing the
    problem), its analytic seed first where it divides: its arithmetic and
    its default budget (16 MiB) unchanged."""
    seed = matmul_blocking_analytic(m, n, k, dtype_bytes=dtype_bytes,
                                    vmem_budget=vmem_budget)

    def largest_divisor(dim: int, cap: int) -> int:
        return max(d for d in divisors(dim) if d <= cap)

    bms = [d for d in (64, 128, 256) if m % d == 0] or [largest_divisor(m, 256)]
    bns = [d for d in (64, 128, 256) if n % d == 0] or [largest_divisor(n, 256)]
    bks = ([d for d in (128, 256, 512, 1024) if k % d == 0]
           or [largest_divisor(k, 1024)])

    def ws(bm, bn, bk):
        return (bm * bk + bk * bn) * dtype_bytes + 2 * bm * bn * 4

    out, seen = [], set()
    if m % seed.bm == 0 and n % seed.bn == 0 and k % seed.bk == 0:
        out.append(seed)
        seen.add((seed.bm, seed.bn, seed.bk))
    for bm in bms:
        for bn in bns:
            for bk in bks:
                if (bm, bn, bk) in seen or ws(bm, bn, bk) > vmem_budget:
                    continue
                seen.add((bm, bn, bk))
                out.append(MatmulBlocking(bm=bm, bn=bn, bk=bk,
                                          vmem_bytes=ws(bm, bn, bk)))
    return out[:MAX_CANDIDATES] or [seed]


def matmul_plan_candidates(*, m: int, n: int, k: int,
                           dtype_bytes: int) -> list:
    """K6's plans on the route an (m, k) x (k, n) product of
    ``dtype_bytes`` elements takes (``matmul_fused.route_for``), the
    default first: on "wgmma" each n-width by each stage count; on "simt"
    each BM x BN."""
    route = k6.route_for(k, n, dtype_bytes)
    default = k6.default_matmul_plan(route, m, n)
    if route == "wgmma":
        pool = [k6.MatmulPlan("wgmma", k6.WGMMA_BM, bn, st)
                for bn in k6.WGMMA_BN for st in k6.WGMMA_STAGES]
    else:
        pool = [k6.MatmulPlan("simt", bm, bn, k6.SIMT_STAGES)
                for bm in k6.SIMT_TILES for bn in k6.SIMT_TILES]
    return [default] + [pl for pl in pool if pl != default]


def plan_candidates(kind: str, *, minibatch: int = 1, **shape) -> list:
    """Every plan of ``kind`` the kernel can run on the shape at batch
    ``minibatch``, the kernel's default plan first (it is always a
    candidate), deduplicated, capped at ``MAX_CANDIDATES`` by spread
    sampling of the rest.  A pure function of (kind, shape, minibatch).
    A conv kind's shape is h, w, c, k, r, s, stride, padding; a
    whole-plane kind's list holds one blocking per (rb_p, k_blk).  The
    kind "matmul" takes m, n, k and dtype_bytes
    (``matmul_plan_candidates``)."""
    if kind == MATMUL_KIND:
        return matmul_plan_candidates(**shape)
    return _conv_plan_candidates(kind, minibatch=minibatch, **shape)


def _conv_plan_candidates(kind: str, *, h: int, w: int, c: int, k: int,
                          r: int, s: int, stride: int, padding: int,
                          minibatch: int = 1) -> list:
    n = minibatch
    p, q = out_dim(h, r, stride, padding), out_dim(w, s, stride, padding)
    shape = dict(n=n, p=p, q=q, c=c, k=k, r=r, s=s)
    default = default_plan(kind, n=n, h=h, w=w, c=c, k=k, r=r, s=s,
                           stride=stride, padding=padding)
    if kind in WHOLE_KINDS:
        pool = [blk for blk in _whole_blockings(
            kind, n=n, h=h, w=w, c=c, k=k, r=r, s=s, stride=stride,
            padding=padding)
            if (blk.rb_p, blk.k_blk) != (default.rb_p, default.k_blk)]
    else:
        pool = {"fwd": _mma_plans, "bwd": _mma_plans, "wu": _wu_plans,
                "q8": _ring_plans}[kind](**shape)
    pool = [pl for pl in pool if pl != default]
    if len(pool) > MAX_CANDIDATES - 1:
        step = len(pool) / (MAX_CANDIDATES - 1)
        pool = [pool[int(i * step)] for i in range(MAX_CANDIDATES - 1)]
    return [default] + pool
