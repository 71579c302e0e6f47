"""Shape-specialized blocking autotuner (paper §II-D, made empirical), the
port's counterpart of ``repro.tune`` for convs.

Per (kind, shape, dtype, stride/padding, batch, backend, card) it searches
the candidates, ranks them by the H100 cost model, times the model's
shortlist on the card by device time (``measure``), and remembers the
winner in a persistent versioned cache (``cache``), so every later process
gets it for free: libxsmm's dispatch cache, one level up.

What is tuned is what each port kernel takes:

* "streams" (K4): a ``ConvBlocking`` (``space.conv_candidates``), through
  ``lookup_conv`` / ``autotune_conv`` and ``core.blocking.conv_blocking``;
* "fwd" and "bwd" (K1's forward and backward-data dual convs), "wu" (K2)
  and "q8" (K3): the kernel's own plan (``space.plan_candidates``: K1's
  ``MmaPlan``, K2's ``WuPlan``, K3's ``RingPlan``), through
  ``lookup_plan`` / ``autotune_plan`` and, per launch, ``resolve_plan``,
  which ``core.conv`` consults.  The kernel's default plan is always a
  candidate and always timed; an entry the kernel cannot run on its shape
  misses, and the miss takes the default plan;
* "fwd_whole", "bwd_whole" (K10a), "q8_whole" (K10c) and "wu_whole"
  (K10b): the whole-plane kernels' ``ConvBlocking`` (rb_p, k_blk), the
  same way (``space.WHOLE_KINDS``), consulted per launch by
  ``core.conv.whole_blocking``; the analytic blocking is the default;
* "matmul" (K6): its ``MatmulPlan`` per (m, n, k, dtype bytes), through
  ``lookup_matmul`` / ``autotune_matmul`` under the reference's
  ``matmul_key``, which ``core.blocking.matmul_blocking`` and so
  ``kernels.ops.matmul`` consult; every candidate timed on the card, the
  default kept unless another is ``MIN_GAIN`` faster.

  mode "off"    the analytic blocking / the kernel's default plan (default)
  mode "cache"  consult the cache, fall back to those on a miss
  mode "tune"   on a miss, search + persist the winner, then use it

Select with ``REPRO_AUTOTUNE``, ``repro_torch.backend.set_autotune`` or the
``autotune=`` argument of ``core.blocking.conv_blocking``,
``kernels.conv2d_streams.conv2d_streams_auto``, the ``core.conv`` entry
points, ``graph.serving.CnnInferenceEngine`` and
``train.step.make_cnn_train_step``.  Layering: ``core.blocking`` calls
``lookup_conv`` / ``autotune_conv`` lazily; this package imports the
analytic helpers of ``core.blocking`` as the search seed, and the kernels'
plan functions.
"""
from __future__ import annotations

import dataclasses
import os as _os

from repro_torch import backend as _be
from repro_torch.core import blocking as _blocking
from repro_torch.core.blocking import ConvBlocking
from repro_torch.kernels.conv2d_direct import MmaPlan
from repro_torch.kernels.conv2d_q8 import RingPlan
from repro_torch.kernels.conv2d_wu import WuPlan
from repro_torch.tune.cache import _ENV_VAR as _CACHE_ENV
from repro_torch.kernels.matmul_fused import (MatmulPlan,  # noqa: F401
                                              check_matmul_plan,
                                              route_for)
from repro_torch.tune.cache import (CACHE_VERSION, TuneCache,  # noqa: F401
                                    conv_key, default_cache, device_kind,
                                    matmul_key)
from repro_torch.tune.measure import (can_measure, conv_cost_us,  # noqa: F401
                                      matmul_plan_cost_us, plan_cost_us,
                                      rank_conv, rank_matmul_plans,
                                      rank_plans)
from repro_torch.tune.space import (PLAN_KINDS,  # noqa: F401
                                    WHOLE_KINDS, check_plan,
                                    conv_candidates, default_plan,
                                    matmul_candidates, out_dim,
                                    plan_applies, plan_candidates)

PLAN_TYPES = {"fwd": MmaPlan, "bwd": MmaPlan, "wu": WuPlan, "q8": RingPlan,
              **dict.fromkeys(WHOLE_KINDS, ConvBlocking)}
# resolve_plan's memo: (kind, shape, batch, backend, mode, and for a mode
# that reads the cache REPRO_TUNE_CACHE and TuneCache.changes) -> plan;
# emptied when it reaches this size
MEMO_SIZE = 4096
_memo: dict = {}
# resolve_plan's answers from the memo and computed since the last reset
# (set to 0 to reset)
memo_hits = 0
memo_misses = 0

_CONV_FIELDS = ("rb_p", "k_blk", "c_blk", "order", "vmem_bytes", "rb_q")


def _to_conv(entry: dict, *, c: int, k: int) -> ConvBlocking | None:
    blk = entry.get("blocking", {})
    if not all(f in blk for f in _CONV_FIELDS):
        return None
    if k % blk["k_blk"] or c % blk["c_blk"]:    # key drift safety net
        return None
    if blk["rb_q"] < 0:
        return None
    budget = _blocking.VMEM_BUDGET
    if blk["vmem_bytes"] > budget and entry.get("budget") != budget:
        # the key has no budget coordinate: a blocking over this process's
        # budget serves only where it was chosen under this very budget
        # (there it is the analytic answer: when no tile fits, the
        # heuristic returns rb_p = 1 all the same)
        return None
    return ConvBlocking(**{f: blk[f] for f in _CONV_FIELDS})


def lookup_conv(*, h, w, c, k, r, s, stride, padding, dtype_bytes=4,
                kind="fwd", backend="cuda", minibatch=1,
                cache: TuneCache | None = None) -> ConvBlocking | None:
    """Cache-only consult; None on a miss (the caller falls back to the
    analytic blocking)."""
    cache = default_cache() if cache is None else cache
    key = conv_key(kind=kind, h=h, w=w, c=c, k=k, r=r, s=s, stride=stride,
                   padding=padding, dtype_bytes=dtype_bytes, backend=backend,
                   minibatch=minibatch)
    entry = cache.lookup(key)
    return _to_conv(entry, c=c, k=k) if entry else None


def autotune_conv(*, h, w, c, k, r, s, stride, padding, dtype_bytes=4,
                  kind="fwd", backend="cuda", minibatch=1,
                  cache: TuneCache | None = None,
                  persist: bool = True) -> ConvBlocking:
    """Cache hit, else search the space, persist the winner, return it.
    The entry's ``source`` is "measured" when the card timed the shortlist
    (backend "cuda"), "model" otherwise.  Only K4 ("streams") runs a
    ``ConvBlocking``: the plan kinds raise (``autotune_plan`` tunes
    them)."""
    if kind in PLAN_KINDS + WHOLE_KINDS:
        raise ValueError(f"kind {kind!r} is tuned as a kernel plan "
                         f"(autotune_plan), not a ConvBlocking")
    cache = default_cache() if cache is None else cache
    hit = lookup_conv(h=h, w=w, c=c, k=k, r=r, s=s, stride=stride,
                      padding=padding, dtype_bytes=dtype_bytes, kind=kind,
                      backend=backend, minibatch=minibatch, cache=cache)
    if hit is not None:
        return hit
    shape = dict(h=h, w=w, c=c, k=k, r=r, s=s, stride=stride,
                 padding=padding, dtype_bytes=dtype_bytes)
    cands = conv_candidates(h=h, w=w, c=c, k=k, r=r, s=s, stride=stride,
                            padding=padding, dtype_bytes=dtype_bytes,
                            kind=kind)
    ranked = rank_conv(shape, cands, kind=kind, backend=backend,
                       minibatch=minibatch)
    score, best = ranked[0]
    if k % best.k_blk == 0 and c % best.c_blk == 0:
        # persist only what the lookup accepts: a non-dividing winner would
        # miss forever
        key = conv_key(kind=kind, h=h, w=w, c=c, k=k, r=r, s=s,
                       stride=stride, padding=padding,
                       dtype_bytes=dtype_bytes, backend=backend,
                       minibatch=minibatch)
        cache.store(key, dataclasses.asdict(best),
                    source="measured" if can_measure(backend) else "model",
                    score_us=score, budget=_blocking.VMEM_BUDGET,
                    persist=persist)
    return best


def plan_dtype_bytes(kind: str) -> int:
    """The element bytes of a plan kind's cache key: 1 for "q8" and
    "q8_whole", else 4."""
    return 1 if kind in ("q8", "q8_whole") else 4


def _to_plan(kind: str, entry: dict, *, n: int, shape: dict):
    """The plan an entry holds, or None when it holds none the kernel can
    run on this shape (the counterpart of ``_to_conv``): a missing or
    mistyped field, or a plan ``check_plan`` refuses."""
    fields = entry.get("blocking", {})
    cls = PLAN_TYPES[kind]
    try:
        values = {f.name: fields[f.name] for f in dataclasses.fields(cls)}
    except (KeyError, TypeError):
        return None
    for f in dataclasses.fields(cls):
        want = str if f.name in ("route", "order") else int
        if type(values[f.name]) is not want:
            return None
    plan = cls(**values)
    try:
        check_plan(kind, plan, n=n, **shape)
    except ValueError:
        return None
    return plan


def _shape(h, w, c, k, r, s, stride, padding) -> dict:
    return dict(h=h, w=w, c=c, k=k, r=r, s=s, stride=stride, padding=padding)


def lookup_plan(*, kind, h, w, c, k, r, s, stride, padding, backend="cuda",
                minibatch=1, dtype_bytes=None, cache: TuneCache | None = None):
    """Cache-only consult of a kernel plan; None on a miss or an entry the
    kernel cannot run on the shape (the caller takes the default plan)."""
    cache = default_cache() if cache is None else cache
    shape = _shape(h, w, c, k, r, s, stride, padding)
    db = plan_dtype_bytes(kind) if dtype_bytes is None else dtype_bytes
    entry = cache.lookup(conv_key(kind=kind, **shape, dtype_bytes=db,
                                  backend=backend, minibatch=minibatch))
    return _to_plan(kind, entry, n=minibatch, shape=shape) if entry else None


def autotune_plan(*, kind, h, w, c, k, r, s, stride, padding, backend="cuda",
                  minibatch=1, dtype_bytes=None,
                  cache: TuneCache | None = None, persist: bool = True):
    """Cache hit, else rank the kernel's plans (``rank_plans``: timed on
    the card, the default among them; by the model elsewhere), persist the
    winner, return it.  The entry holds the plan's fields, its score, and
    (where timed) the default plan's time and the candidates timed."""
    cache = default_cache() if cache is None else cache
    shape = _shape(h, w, c, k, r, s, stride, padding)
    db = plan_dtype_bytes(kind) if dtype_bytes is None else dtype_bytes
    hit = lookup_plan(kind=kind, **shape, backend=backend,
                      minibatch=minibatch, dtype_bytes=db, cache=cache)
    if hit is not None:
        return hit
    if not plan_applies(kind, c=c, k=k):
        raise ValueError(f"no {kind!r} kernel plan applies to C={c}, K={k}")
    cands = plan_candidates(kind, **shape, minibatch=minibatch)
    ranked = rank_plans(kind, shape, cands, backend=backend,
                        minibatch=minibatch)
    score, best = ranked[0]
    measured = can_measure(backend)
    extra = {"candidates": len(cands), "timed": len(ranked) if measured
             else 0}
    if measured:
        extra["default_us"] = next(t for t, pl in ranked if pl == cands[0])
    cache.store(conv_key(kind=kind, **shape, dtype_bytes=db, backend=backend,
                         minibatch=minibatch),
                dataclasses.asdict(best),
                source="measured" if measured else "model", score_us=score,
                persist=persist, extra=extra)
    return best


def resolve_plan(kind: str, *, n, h, w, c, k, r, s, stride, padding,
                 backend: str = "cuda", autotune: str | None = None):
    """The plan one launch of ``kind`` takes, by the autotune mode
    (``backend.resolve_autotune``): "off" the kernel's default plan,
    "cache" the cached plan or the default on a miss, "tune" the cached or
    newly tuned plan.  ``core.conv`` calls it on every launch, so the
    answer is memoised per (kind, shape, batch, backend, mode and, where
    the mode reads the cache, ``REPRO_TUNE_CACHE`` and
    ``TuneCache.changes``): a warm call is one environment read and one
    dict lookup.  The default file's other inputs (``XDG_CACHE_HOME``,
    the home directory) are taken as fixed for the process."""
    global memo_hits, memo_misses
    mode = _be.resolve_autotune(autotune)
    key = (kind, n, h, w, c, k, r, s, stride, padding, backend, mode)
    if mode != "off":
        key += (_os.environ.get(_CACHE_ENV), TuneCache.changes)
    plan = _memo.get(key)
    if plan is not None:
        memo_hits += 1
        return plan
    memo_misses += 1
    shape = _shape(h, w, c, k, r, s, stride, padding)
    if mode == "tune":
        plan = autotune_plan(kind=kind, **shape, backend=backend,
                             minibatch=n)
    elif mode == "cache":
        plan = lookup_plan(kind=kind, **shape, backend=backend, minibatch=n)
    if plan is None:
        plan = default_plan(kind, n=n, **shape)
    if len(_memo) >= MEMO_SIZE:
        _memo.clear()
    _memo[key] = plan
    return plan


def warmup_convs(shapes, *, minibatches=(1,), kinds=("fwd",), mode="tune",
                 backend=None, cache: TuneCache | None = None,
                 dtype_bytes=4, bwd_mode=None) -> list[dict]:
    """Fill the blocking cache for the conv ``shapes`` before the first
    request or step needs them.

    ``shapes``: dicts with h/w/c/k/r/s/stride/padding (for example from
    ``graph.serving.conv_shapes``).  One entry per shape x ``kinds`` x
    ``minibatches`` (the batch is part of the key).  "bwd" and "bwd_whole"
    expand each layer into the dual forward-conv signature(s) its
    backward-data pass launches (``duality.dual_conv_signatures``, under
    ``bwd_mode``).  "streams" tunes K4's ``ConvBlocking``; "fwd", "bwd",
    "wu" and "q8" tune the kernel plan of K1, K2 or K3, the whole-plane
    kinds the blocking of K10a-c (``autotune_plan``), on the shapes
    whose launches take one (``space.plan_applies``): the others (a C=3
    stem, a "q8" C off the multiples of 16) are reported, not tuned.
    ``mode`` "tune" searches and persists on a miss, "cache" only reports
    what is there.  ``backend`` None resolves the default device ("cuda";
    raises without a GPU).  New entries are saved in one atomic write at
    the end.  Returns one report per key: ``{"key", "kind", "cached",
    "source"}``, and for the plan kinds ``"plan"`` (None where it missed).
    """
    import sys

    from repro_torch import backend as be
    from repro_torch.core import duality
    if backend is None:
        backend = be.resolve_device(None).type
    cache = default_cache() if cache is None else cache
    report = []
    for sh in shapes:
        base = {f: sh[f] for f in ("h", "w", "c", "k", "r", "s",
                                   "stride", "padding")}
        db = sh.get("dtype_bytes", dtype_bytes)
        for kind in kinds:
            if kind in ("bwd", "bwd_whole"):
                targets = duality.dual_conv_signatures(
                    r=base["r"], s=base["s"], c=base["c"], k=base["k"],
                    stride=base["stride"], padding=base["padding"],
                    input_hw=(base["h"], base["w"]), mode=bwd_mode)
            else:
                targets = [base]
            planned = kind in PLAN_KINDS + WHOLE_KINDS
            for tgt in targets:
                takes = planned and plan_applies(kind, c=tgt["c"],
                                                 k=tgt["k"])
                for mb in minibatches:
                    if mode == "tune" and takes:
                        autotune_plan(kind=kind, **tgt, dtype_bytes=db,
                                      backend=backend, minibatch=mb,
                                      cache=cache, persist=False)
                    elif mode == "tune" and not planned:
                        autotune_conv(**tgt, dtype_bytes=db, kind=kind,
                                      backend=backend, minibatch=mb,
                                      cache=cache, persist=False)
                    key = conv_key(kind=kind, **tgt, dtype_bytes=db,
                                   backend=backend, minibatch=mb)
                    entry = cache.lookup(key)
                    rec = {"key": key, "kind": kind}
                    if planned:
                        plan = _to_plan(kind, entry, n=mb, shape=tgt) \
                            if entry and takes else None
                        entry = entry if plan is not None else None
                        rec["plan"] = plan
                    rec.update(cached=entry is not None,
                               source=entry["source"] if entry else None)
                    report.append(rec)
    if mode == "tune" and any(e["cached"] for e in report):
        try:
            cache.save()
        except OSError as e:        # unwritable path: warm in-memory only
            print(f"repro_torch.tune: warmup cache not persisted "
                  f"({cache.path}: {e})", file=sys.stderr)
    return report


def _to_matmul(entry: dict, *, m: int, n: int, k: int, dtype_bytes: int):
    """The ``MatmulPlan`` an entry holds, or None where it holds none the
    shape's route runs (a missing or mistyped field, or a plan
    ``check_matmul_plan`` refuses)."""
    fields = entry.get("blocking", {})
    try:
        values = {f.name: fields[f.name]
                  for f in dataclasses.fields(MatmulPlan)}
    except (KeyError, TypeError):
        return None
    for name, v in values.items():
        if type(v) is not (str if name == "route" else int):
            return None
    plan = MatmulPlan(**values)
    try:
        check_matmul_plan(plan, route_=route_for(k, n, dtype_bytes), m=m,
                          n=n, k=k)
    except ValueError:
        return None
    return plan


def lookup_matmul(m, n, k, *, dtype_bytes=2, backend="cuda",
                  cache: TuneCache | None = None) -> MatmulPlan | None:
    """Cache-only consult of K6's plan for an (m, k) x (k, n) product;
    None on a miss or an entry its route cannot run."""
    cache = default_cache() if cache is None else cache
    entry = cache.lookup(matmul_key(m=m, n=n, k=k, dtype_bytes=dtype_bytes,
                                    backend=backend))
    if not entry:
        return None
    return _to_matmul(entry, m=m, n=n, k=k, dtype_bytes=dtype_bytes)


def autotune_matmul(m, n, k, *, dtype_bytes=2, backend="cuda",
                    cache: TuneCache | None = None,
                    persist: bool = True) -> MatmulPlan:
    """Cache hit, else rank K6's plans (``rank_matmul_plans``: each timed
    by device time on the card, scored by the model elsewhere), persist
    the winner under the reference's ``matmul_key`` and return it.  The
    entry holds the plan's fields, its score, the candidates and, where
    timed, the default plan's time."""
    cache = default_cache() if cache is None else cache
    hit = lookup_matmul(m, n, k, dtype_bytes=dtype_bytes, backend=backend,
                        cache=cache)
    if hit is not None:
        return hit
    cands = plan_candidates("matmul", m=m, n=n, k=k, dtype_bytes=dtype_bytes)
    ranked = rank_matmul_plans(m, n, k, cands, dtype_bytes=dtype_bytes,
                               backend=backend)
    score, best = ranked[0]
    measured = can_measure(backend)
    extra = {"candidates": len(cands), "timed": len(ranked) if measured
             else 0}
    if measured:
        extra["default_us"] = next(t for t, pl in ranked if pl == cands[0])
    cache.store(matmul_key(m=m, n=n, k=k, dtype_bytes=dtype_bytes,
                           backend=backend),
                dataclasses.asdict(best),
                source="measured" if measured else "model", score_us=score,
                persist=persist, extra=extra)
    return best
