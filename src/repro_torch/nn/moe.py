"""Mixture-of-Experts MLP (top-k router, grouped capacity dispatch), the
counterpart of ``repro/nn/moe.py``.

GShard/Switch dispatch with groups: the tokens of a sequence are cut into
contiguous groups of ``GROUP_SIZE`` (one group of L when that does not
divide L), each group gets a capacity of C = max(int(cf·S·k/E), 1) slots
per expert, and overflow is dropped slot by slot, then token by token in
the group's order, exactly as the reference does.  The experts run as the
reference's dense einsums over (G, E, C, D).

A device may hold a share of the experts (``MoECfg.expert_share``, the
per-device view of expert parallelism).  The router, the capacity, the
drops and the aux losses are computed over all E experts; the SwiGLU runs
on the held experts only, and the layer returns the part of the combined
output that they give, so the shares of all devices sum to the full layer.
Every held expert runs in decode too (replaying only the experts that
received tokens is K9's work).

Aux losses: load balancing (Switch) and the router z-loss.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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

    # --- dryrun: per-group dispatch and combine over all E experts --------
    combine = torch.zeros((g, s, e, cap), dtype=torch.float32,
                          device=x.device)
    dispatch = torch.zeros_like(combine)
    counts = torch.zeros((g, e), dtype=torch.float32, device=x.device)
    for slot in range(k):
        onehot = F.one_hot(gate_idx[..., slot], e).float()    # (G,S,E)
        pos_in_slot = onehot.cumsum(dim=1) - onehot
        pos = ((pos_in_slot + counts[:, None, :]) * onehot).sum(-1).long()
        keep = pos < cap
        posc = pos.clamp_max(cap - 1)
        mask = (onehot * keep[..., None])[..., None] \
            * F.one_hot(posc, cap).float()[..., None, :]
        dispatch = dispatch + mask
        combine = combine + mask * gate_vals[..., slot][..., None, None]
        counts = counts + (onehot * keep[..., None]).sum(dim=1)

    # --- replay: the held experts' SwiGLU ---------------------------------
    with torch.profiler.record_function("moe.experts"):
        xe = torch.einsum("gsec,gsd->gecd",
                          dispatch[:, :, e0:e1].to(x.dtype), xg)
        h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["w_gate"]))
        u = torch.einsum("gecd,edf->gecf", xe, p["w_up"])
        ye = torch.einsum("gecf,efd->gecd", h * u, p["w_down"])
        out = torch.einsum("gsec,gecd->gsd",
                           combine[:, :, e0:e1].to(x.dtype), ye)

    # --- aux losses over the full router ----------------------------------
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(gate_idx[..., 0], e).float().mean(dim=(0, 1))
    lb_loss = e * (me * ce).sum()
    z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return out.reshape(b, l, d), {"lb_loss": lb_loss, "z_loss": z_loss}
