"""Mixture-of-Experts MLP (top-k router, grouped capacity dispatch), the
counterpart of ``repro/nn/moe.py``.

GShard/Switch dispatch with groups: the tokens of a sequence are cut into
contiguous groups of ``GROUP_SIZE`` (one group of L when that does not
divide L), each group gets a capacity of C = max(int(cf·S·k/E), 1) slots
per expert, and overflow is dropped slot by slot, then token by token in
the group's order, exactly as the reference does.  That is the dryrun of
paper §II-H.

The replay is K9 (``kernels/moe_gmm``), the grouped matmul the reference
calls the single-chip version of its einsum schedule
(``repro/nn/moe.py:9-12``): the kept entries of the held experts become
rows grouped by expert, each group padded to a tile of ``bm`` rows, with a
``tile_eid`` stream naming each tile's expert and -1 on the tiles past the
last used one; the SwiGLU runs as three K9 products over those rows, and
each token sums its k weighted rows in slot order.  Only the experts that
received tokens are read.  The rows buffer is sized on the host from the
shapes alone, so the layer reads no device value on the host.  On a CPU
tensor K9 is its plain version; on the card, where autograd records, each
product's gradient is K9' (``moe_gmm_bwd``), and the gathers of the rows
and the combine stay plain torch, as they are plain JAX in the reference.  The function is the reference's einsum
replay's; the gate values are rounded to the activation dtype before the
combine, as the reference's ``combine.astype(x.dtype)`` does.

A device may hold a share of the experts (``MoECfg.expert_share``, the
per-device view of expert parallelism).  The router, the capacity, the
drops and the aux losses are computed over all E experts; only the held
experts' entries are replayed, and the layer returns the part of the
combined output that they give, so the shares of all devices sum to the
full layer.

Aux losses: load balancing (Switch) and the router z-loss.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import moe_gmm as k9
from repro_torch.nn.common import dense_init

GROUP_SIZE = 512


def init(generator, cfg, dtype, device=None):
    """The router over all E experts and the held experts' stacked SwiGLU
    weights.  The reference's ``dense_init`` takes fan-in from shape[0],
    which for the stacked (E, d, f) weights is E: every expert weight has
    std E^-1/2 at the published E, whatever the share."""
    d, dff, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    e0, e1 = cfg.moe.held_experts()
    held = e1 - e0
    scale = e ** -0.5
    return {
        "router": dense_init(generator, (d, e), dtype=dtype, device=device),
        "w_gate": dense_init(generator, (held, d, dff), scale=scale,
                             dtype=dtype, device=device),
        "w_up": dense_init(generator, (held, d, dff), scale=scale,
                           dtype=dtype, device=device),
        "w_down": dense_init(generator, (held, dff, d), scale=scale,
                             dtype=dtype, device=device),
    }


def route(probs, k: int):
    """The router's decision: the top-k experts of each token's
    probabilities (G,S,E), ties to the lower index as ``lax.top_k`` (bf16
    logits do tie), and their gate values renormalised to sum to 1.
    Returns (gate_vals f32, gate_idx), each (G,S,k)."""
    gate_vals, gate_idx = probs.sort(dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[..., :k], gate_idx[..., :k]
    return (gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9),
            gate_idx)


def kept(gate_idx, e: int, cap: int):
    """The capacity rule: which of the (G,S,k) routed entries keep a slot.
    Slot by slot, then token by token in the group's order, each entry
    takes its expert's next free place of ``cap`` in its group
    (``repro/nn/moe.py:62-71``)."""
    counts = torch.zeros((gate_idx.shape[0], e), dtype=torch.float32,
                         device=gate_idx.device)
    keep = []
    for slot in range(gate_idx.shape[-1]):
        onehot = F.one_hot(gate_idx[..., slot], e).float()    # (G,S,E)
        pos_in_slot = onehot.cumsum(dim=1) - onehot
        pos = ((pos_in_slot + counts[:, None, :]) * onehot).sum(-1)
        keep.append(pos < cap)
        counts = counts + (onehot * keep[-1][..., None]).sum(dim=1)
    return torch.stack(keep, dim=-1)


def replay_layout(expert, mine, held: int, bm: int, tiles: int):
    """Rows of K9's input for the entries to replay here.

    expert: (N,) held-expert id of each entry (id - e0); mine: (N,) whether
    the entry is kept and its expert held.  The entries of held expert h
    take the rows from h's group start on, in entry order; each group
    starts at a tile, so it is padded to a multiple of ``bm``.  Returns
    (row (N,) int64, with ``tiles * bm`` for an entry not replayed;
    tile_eid (tiles,) int32, each tile's held expert, -1 past the last
    used tile).  ``tiles`` must bound the tiles used; nothing is read on
    the host."""
    local = torch.where(mine, expert, held)
    onehot = (local[:, None] == torch.arange(
        held + 1, device=local.device)[None, :]).long()         # (N, held+1)
    rank = ((onehot.cumsum(dim=0) - 1) * onehot).sum(dim=1)
    used = (onehot[:, :held].sum(dim=0) + bm - 1) // bm         # tiles per h
    ends = used.cumsum(dim=0)
    starts = F.pad((ends - used) * bm, (0, 1))
    row = torch.where(mine, starts[local] + rank, tiles * bm)
    tile = torch.arange(tiles, device=local.device)
    owner = (tile[:, None] >= ends[None, :]).sum(dim=1)
    tile_eid = torch.where(owner < held, owner, -1).to(torch.int32)
    return row, tile_eid


def replay_plan(gate_idx, keep, e0: int, e1: int, cap: int):
    """K9's input rows for the kept entries of the held experts [e0, e1).

    gate_idx, keep: (G,S,k).  The rows buffer is sized on the host from the
    shapes alone: at most min(G·S·k, held·G·cap) entries, each expert's
    group padded to a tile, so ⌈that / bm⌉ + held tiles.  Returns (bm,
    tile_eid (tiles,) int32, row (G·S·k,) int64 of each entry, ``tiles*bm``
    for one not replayed here, source (tiles*bm,) int64: 1 + the token
    (G·S order) of each row, 0 on padding)."""
    g, s, k = gate_idx.shape
    held = e1 - e0
    rows_max = min(g * s * k, held * g * cap)
    bm = k9.pick_bm(rows_max, held)
    tiles = -(-rows_max // bm) + held
    expert = gate_idx.reshape(-1) - e0
    row, tile_eid = replay_layout(
        expert, keep.reshape(-1) & (expert >= 0) & (expert < held), held,
        bm, tiles)
    source = torch.zeros((tiles * bm + 1,), dtype=torch.long,
                         device=gate_idx.device)
    source.index_put_((row,), torch.arange(
        1, g * s + 1, device=gate_idx.device)[:, None].expand(g * s, k)
        .reshape(-1))
    return bm, tile_eid, row, source[:-1]


def apply(p, cfg, x):
    """x: (B,L,D) -> (out (B,L,D), {"lb_loss", "z_loss"} f32 scalars)."""
    b, l, d = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    e0, e1 = cfg.moe.held_experts()
    s = min(GROUP_SIZE, l)
    if l % s:
        s = l
    g = (b * l) // s
    xg = x.reshape(g, s, d)

    logits = (xg @ p["router"].to(x.dtype)).float()           # (G,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = route(probs, k)                     # (G,S,k)

    cap = max(int(cfg.moe.capacity_factor * s * k / e), 1)

    # --- dryrun: the kept entries of the held experts as K9's rows --------
    bm, tile_eid, row, source = replay_plan(gate_idx, kept(gate_idx, e, cap),
                                            e0, e1, cap)

    # --- replay: the held experts' SwiGLU on their rows, then the combine --
    with torch.profiler.record_function("moe.experts"):
        xf = x.reshape(g * s, d)
        x_rows = torch.where((source > 0)[:, None],
                             xf[(source - 1).clamp_min(0)], 0)
        h = F.silu(k9.moe_gmm(x_rows, p["w_gate"], tile_eid, bm=bm))
        u = k9.moe_gmm(x_rows, p["w_up"], tile_eid, bm=bm)
        ye = k9.moe_gmm(h * u, p["w_down"], tile_eid, bm=bm)
        ye = torch.cat([ye, ye.new_zeros((1, d))])   # the row of no entry
        rows = row.reshape(g * s, k)
        gates = gate_vals.reshape(g * s, k).to(x.dtype).float()
        out = torch.zeros((g * s, d), dtype=torch.float32, device=x.device)
        for slot in range(k):
            out = out + gates[:, slot, None] * ye[rows[:, slot]].float()
        out = out.to(x.dtype)

    # --- aux losses over the full router ----------------------------------
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(gate_idx[..., 0], e).float().mean(dim=(0, 1))
    lb_loss = e * (me * ce).sum()
    z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return out.reshape(b, l, d), {"lb_loss": lb_loss, "z_loss": z_loss}
