"""Weight-gradient parallelization strategy (paper §II-J), the port's copy
of ``repro/core/wu_strategy.py``: lifted from threads sharing an LLC to
devices sharing an interconnect.

The paper's two extremes, per layer, for T workers:
  "shared":  partition (C, K) feature maps across workers; every worker
             re-reads T/T_c x the input and T/T_k x the dO tensor, but dW is
             written once.
  "copies":  partition the minibatch; activations are read once, but T full
             dW copies must be reduced (2T x dW traffic).
Hybrids pick a minibatch-parallelism degree in between.  The dryrun phase
costs both and picks the cheaper; so does this module, with the
interconnect's bytes as the reduction cost:
  "copies"  -> dW lives data-parallel, one all-reduce (the default
               data-parallel gradient reduction, ``train.distributed``).
  "shared"  -> dW is reduce-scattered over the data group (ZeRO-2 flavor)
               so each device owns a shard: less dW traffic, more
               activation traffic when the shard must be re-gathered.
The functions are pure arithmetic on byte counts, the reference's.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WuCost:
    strategy: str          # "shared" | "copies" | hybrid degree
    act_bytes: float       # activation + grad-output read traffic
    dw_bytes: float        # weight-gradient write/reduce traffic
    total: float


def choose_wu_strategy(*, n: int, c: int, k: int, h: int, w: int,
                       p: int, q: int, r: int, s: int,
                       n_workers: int, dtype_bytes: int = 4,
                       feature_par: tuple[int, int] | None = None) -> WuCost:
    """Cost the two §II-J extremes for this layer and pick the cheaper."""
    dw = r * s * c * k * dtype_bytes
    act = n * c * h * w * dtype_bytes
    dout = n * k * p * q * dtype_bytes
    t = n_workers
    if feature_par is None:
        # split workers over (C, K) as evenly as possible
        tc = max(int(t ** 0.5), 1)
        tk = max(t // tc, 1)
    else:
        tc, tk = feature_par
    shared = WuCost("shared",
                    act_bytes=act * (t / tc) + dout * (t / tk),
                    dw_bytes=float(dw),
                    total=act * (t / tc) + dout * (t / tk) + dw)
    copies = WuCost("copies",
                    act_bytes=float(act + dout),
                    dw_bytes=2.0 * t * dw,
                    total=act + dout + 2.0 * t * dw)
    return shared if shared.total < copies.total else copies


def hybrid_copies(*, n: int, dw_bytes: int, act_bytes: int,
                  n_workers: int) -> int:
    """Pick the minibatch-parallel degree m (number of dW copies) minimizing
    modeled traffic — the paper's hybrid between the two extremes."""
    best_m, best_cost = 1, float("inf")
    m = 1
    while m <= min(n, n_workers):
        cost = act_bytes * (n_workers / m) / n_workers + 2.0 * m * dw_bytes
        if cost < best_cost:
            best_m, best_cost = m, cost
        m *= 2
    return best_m
