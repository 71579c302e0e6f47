"""Shape-specialized blocking autotuner (paper §II-D, made empirical), the
port's counterpart of ``repro.tune`` for convs.

Per (kind, shape, dtype, stride/padding, batch, backend, card) it searches
the blocking space (``space.conv_candidates``), ranks it by the H100 cost
model, times the model's shortlist on the card with CUDA events
(``measure``), and remembers the winner in a persistent versioned cache
(``cache``), so every later process gets the tuned blocking for free:
libxsmm's dispatch cache, one level up.

  mode "off"    analytic heuristic only (default)
  mode "cache"  consult the cache, fall back to the heuristic on a miss
  mode "tune"   on a miss, search + persist the winner, then use it

Select with ``REPRO_AUTOTUNE``, ``repro_torch.backend.set_autotune`` or the
``autotune=`` argument of ``core.blocking.conv_blocking`` and
``kernels.conv2d_streams.conv2d_streams_auto``.  Layering: ``core.blocking``
calls ``lookup_conv`` / ``autotune_conv`` lazily; this package imports the
analytic helpers of ``core.blocking`` as the search seed.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import blocking as _blocking
from repro_torch.core.blocking import ConvBlocking
from repro_torch.tune.cache import (CACHE_VERSION, TuneCache,  # noqa: F401
                                    conv_key, default_cache, device_kind)
from repro_torch.tune.measure import (can_measure, conv_cost_us,  # noqa: F401
                                      rank_conv)
from repro_torch.tune.space import conv_candidates, out_dim  # noqa: F401

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
    (backend "cuda"), "model" otherwise."""
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


def warmup_convs(shapes, *, minibatches=(1,), kinds=("fwd",), mode="tune",
                 backend=None, cache: TuneCache | None = None,
                 dtype_bytes=4, bwd_mode=None) -> list[dict]:
    """Fill the blocking cache for the conv ``shapes`` before the first
    request or step needs them.

    ``shapes``: dicts with h/w/c/k/r/s/stride/padding (for example from
    ``graph.serving.conv_shapes``).  One entry per shape x ``kinds`` x
    ``minibatches`` (the batch is part of the key).  "bwd" expands each
    layer into the dual forward-conv signature(s) its backward-data pass
    launches (``duality.dual_conv_signatures``, under ``bwd_mode``).
    ``mode`` "tune" searches and persists on a miss, "cache" only reports
    what is there.  ``backend`` None resolves the default device ("cuda";
    raises without a GPU).  New entries are saved in one atomic write at
    the end.  Returns one report per key: ``{"key", "kind", "cached",
    "source"}``.
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
            if kind == "bwd":
                targets = duality.dual_conv_signatures(
                    r=base["r"], s=base["s"], c=base["c"], k=base["k"],
                    stride=base["stride"], padding=base["padding"],
                    input_hw=(base["h"], base["w"]), mode=bwd_mode)
            else:
                targets = [base]
            for tgt in targets:
                for mb in minibatches:
                    if mode == "tune":
                        autotune_conv(**tgt, dtype_bytes=db, kind=kind,
                                      backend=backend, minibatch=mb,
                                      cache=cache, persist=False)
                    key = conv_key(kind=kind, **tgt, dtype_bytes=db,
                                   backend=backend, minibatch=mb)
                    entry = cache.lookup(key)
                    report.append({"key": key, "kind": kind,
                                   "cached": entry is not None,
                                   "source": entry["source"] if entry
                                   else None})
    if mode == "tune" and any(e["cached"] for e in report):
        try:
            cache.save()
        except OSError as e:        # unwritable path: warm in-memory only
            print(f"repro_torch.tune: warmup cache not persisted "
                  f"({cache.path}: {e})", file=sys.stderr)
    return report
