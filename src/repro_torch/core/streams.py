"""Kernel streams: the paper's §II-H dryrun, the port's counterpart of
``repro/core/streams.py`` (numpy only).

The paper records, per thread, the exact sequence of microkernel invocations
(input / weight / output sub-tensor offsets and the fused-operator variant),
run-length encodes it into segments, and replays it branch-free.  The
*dryrun* below walks the §II-A loop nest on the host and records those
streams; the *replay* is K4 (``kernels/conv2d_streams.py``), a CUDA kernel
that reads the five streams from device memory and obeys the flag of every
step it executes.

A *run* is the contiguous stretch of steps from ``FLAG_INIT`` to
``FLAG_EPILOGUE`` that accumulates one output tile over its C-blocks; C
innermost is what makes runs contiguous, so one CTA (or a fixed set that
splits the tile) can keep the accumulator in registers for the whole run.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Per-step flag bits (the "kernel variant / APPLY" column of Fig. 2).
FLAG_INIT = 1       # first visit of this output tile: zero the accumulator
FLAG_EPILOGUE = 2   # last visit: apply the fused L() and write back
FLAG_RELU = 4       # L() includes ReLU
FLAG_HANDOFF = 8    # depth-first hand-off between chain layers
                    # (``build_chain_schedule``)


@dataclasses.dataclass(frozen=True)
class ConvSchedule:
    """Flat replay schedule: one entry per microkernel invocation."""
    n_ids: np.ndarray       # image index stream
    kb_ids: np.ndarray      # output-feature block offset stream (w/o offsets)
    pb_ids: np.ndarray      # output row-block offset stream (o offsets)
    cb_ids: np.ndarray      # input-feature block offset stream (i offsets)
    flags: np.ndarray       # per-step variant/fusion flags
    segments: tuple         # RLE segments: (kind, start, length)
    grid: tuple             # (n, k_b, p_b, c_b) loop bounds

    def __len__(self):
        return len(self.n_ids)


def build_conv_schedule(*, n: int, k_b: int, p_b: int, c_b: int,
                        order: str = "nkpc", relu: bool = False) -> ConvSchedule:
    """Dryrun: walk the §II-A loop nest in `order` and record the streams.

    `order` is a permutation of "nkpc" (minibatch, K-blocks, row-blocks,
    C-blocks) — the §II-C loop-order choice.  C-block steps for one output
    tile must be contiguous (the accumulator stays with one output tile for
    the whole run), so "c" must be the innermost dimension; the other
    orders decide which tiles run next to each other, and so which weight
    blocks and input planes neighbouring runs share in cache.
    """
    assert sorted(order) == sorted("nkpc"), order
    assert order.endswith("c"), "C-blocks must be innermost (accumulator tile)"
    bounds = {"n": n, "k": k_b, "p": p_b, "c": c_b}
    dims = [bounds[d] for d in order]
    idx = np.stack(np.meshgrid(*[np.arange(d) for d in dims], indexing="ij"),
                   axis=-1).reshape(-1, 4)
    cols = {d: idx[:, i] for i, d in enumerate(order)}
    cb = cols["c"]
    flags = np.zeros(len(idx), dtype=np.int32)
    flags[cb == 0] |= FLAG_INIT
    flags[cb == c_b - 1] |= FLAG_EPILOGUE
    if relu:
        flags[cb == c_b - 1] |= FLAG_RELU

    segments = rle_segments(flags)
    return ConvSchedule(
        n_ids=cols["n"].astype(np.int32), kb_ids=cols["k"].astype(np.int32),
        pb_ids=cols["p"].astype(np.int32), cb_ids=cb.astype(np.int32),
        flags=flags, segments=tuple(segments), grid=(n, k_b, p_b, c_b))


@dataclasses.dataclass(frozen=True)
class ChainSchedule:
    """Interleaved depth-first replay schedule of a conv->conv chain: per
    final-layer output band, one step for each layer, producers first.
    Every step is a complete band micro-conv (INIT|EPILOGUE); every step
    but the last layer's carries FLAG_HANDOFF: its output band is the next
    step's input and is not part of the chain's output.

    ``o0``/``o1`` are each step's output-row range at its layer (real,
    clipped coordinates): the band driver computes exactly these rows, so
    the band arithmetic lives here."""
    layer_ids: np.ndarray   # chain-layer index per step
    band_ids: np.ndarray    # final-layer band index per step
    o0: np.ndarray          # first output row of this step's band
    o1: np.ndarray          # one past its last output row
    flags: np.ndarray
    segments: tuple         # RLE segments: (flags, start, length)
    grid: tuple             # (n_layers, n_bands)

    def __len__(self):
        return len(self.layer_ids)


def build_chain_schedule(*, rs, h_in: int, rb: int) -> ChainSchedule:
    """Dryrun of a depth-first chain: one interleaved schedule.

    ``rs`` is the per-layer (r, stride, padding) list, producers first;
    ``h_in`` the chain input's height; ``rb`` the final layer's output
    rows per band.  Per band, the output rows each layer must compute
    follow back from the final band by the halo recurrence (out rows
    [o0, o1) of layer l+1 need rows [o0*s - pad, (o1-1)*s + r - pad) of
    its input, clipped at the plane's edges); the steps are emitted
    producer first.  Consecutive bands of a non-final layer overlap by
    the halo, and those rows are computed again."""
    rs = [tuple(t) for t in rs]
    n_layers = len(rs)
    p = []                          # per-layer output rows
    h = h_in
    for r, stride, pad in rs:
        h = (h + 2 * pad - r) // stride + 1
        p.append(h)
    n_bands = -(-p[-1] // rb)

    layer_ids, band_ids, o0s, o1s, flags = [], [], [], [], []
    for b in range(n_bands):
        o = [None] * n_layers
        o[-1] = (b * rb, min((b + 1) * rb, p[-1]))
        for l in range(n_layers - 2, -1, -1):
            lo, hi = o[l + 1]
            r, stride, pad = rs[l + 1]
            o[l] = (max(lo * stride - pad, 0),
                    min((hi - 1) * stride + r - pad, p[l]))
        for l in range(n_layers):
            assert o[l][1] > o[l][0], (b, l, o)
            layer_ids.append(l)
            band_ids.append(b)
            o0s.append(o[l][0])
            o1s.append(o[l][1])
            f = FLAG_INIT | FLAG_EPILOGUE
            if l < n_layers - 1:
                f |= FLAG_HANDOFF
            flags.append(f)

    flags = np.asarray(flags, dtype=np.int32)
    return ChainSchedule(
        layer_ids=np.asarray(layer_ids, dtype=np.int32),
        band_ids=np.asarray(band_ids, dtype=np.int32),
        o0=np.asarray(o0s, dtype=np.int32),
        o1=np.asarray(o1s, dtype=np.int32),
        flags=flags, segments=tuple(rle_segments(flags)),
        grid=(n_layers, n_bands))


def rle_segments(flags: np.ndarray):
    """Run-length encode the flag stream into (flag_value, start, length)
    segments — the paper's CONV-STREAK / APPLY compression (Fig. 2)."""
    segs = []
    start = 0
    for i in range(1, len(flags) + 1):
        if i == len(flags) or flags[i] != flags[start]:
            segs.append((int(flags[start]), start, i - start))
            start = i
    return segs


def decode_segments(segs, total: int) -> np.ndarray:
    """Inverse of rle_segments."""
    out = np.zeros(total, dtype=np.int32)
    for val, start, length in segs:
        out[start:start + length] = val
    return out


def prefetch_streams(sched: ConvSchedule):
    """The §II-E property: prefetch offsets at step i are the argument
    offsets of step i+1 (the last step prefetches itself — a no-op)."""
    def nxt(a):
        return np.concatenate([a[1:], a[-1:]])
    return (nxt(sched.n_ids), nxt(sched.kb_ids),
            nxt(sched.pb_ids), nxt(sched.cb_ids))


def run_starts(sched: ConvSchedule) -> np.ndarray:
    """Index of the first step of every run (its ``FLAG_INIT`` step), in
    schedule order."""
    return np.flatnonzero(sched.flags & FLAG_INIT).astype(np.int32)


def permute_runs(sched: ConvSchedule, perm) -> ConvSchedule:
    """The same steps with whole runs reordered: run ``perm[j]`` of
    ``sched`` becomes run ``j``.  Every run keeps its C-blocks innermost, so
    the result computes the same output; a replay engine that derived its
    work from its grid position instead of from the streams would not."""
    starts = run_starts(sched)
    ends = np.append(starts[1:], len(sched))
    assert sorted(perm) == list(range(len(starts))), "not a permutation"
    take = np.concatenate([np.arange(starts[j], ends[j]) for j in perm])
    flags = sched.flags[take]
    return ConvSchedule(
        n_ids=sched.n_ids[take], kb_ids=sched.kb_ids[take],
        pb_ids=sched.pb_ids[take], cb_ids=sched.cb_ids[take], flags=flags,
        segments=tuple(rle_segments(flags)), grid=sched.grid)
