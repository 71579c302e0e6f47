"""Mamba selective-SSM mixer (Jamba's attention-free layer), the counterpart
of ``repro/nn/mamba.py``.

The depthwise causal conv1d goes through ``ops.conv1d``: K8 on the card
(with K8' as its gradient where autograd records), its plain version on
the CPU.  The selective scan h_t = a_t * h_{t-1} + b_t
(data-dependent a_t, b_t of shape (d_inner, d_state)) is plain torch, as it
is plain JAX in the reference: sequential over chunks of ``cfg.scan_chunk``
tokens carrying h (B, d_inner, d_state) in f32, and inside a chunk a
log-depth doubling scan over the (a, b) pairs, one tensor op per step on
(B, chunk, d_inner, d_state), so the per-token state exists for one chunk
at a time.  The last chunk may be ragged; the reference instead falls back
to one chunk of the whole sequence when the chunk does not divide L
(``mamba.py:72-73``), which at full width would hold (B, L, 16384, 16) f32.
The two sum in other orders, so they agree to rounding, not bit for bit.

Dtypes follow the reference step by step, so bf16 stays close: dt * B is
formed in the model dtype and then widened, a = exp(dt * -exp(A_log)) in
f32, the output cast to x's dtype before ``out_proj``.  Decode is the O(1)
single-token update with its window sum in plain torch (K8 is not
launched), and writes the conv and ssm states into the cache in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.nn.common import dense_init


def dt_rank(cfg) -> int:
    return max(cfg.d_model // 16, 1)


def init(generator, cfg, dtype, device=None):
    d, di, ds, dc = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv
    r = dt_rank(cfg)
    conv_w = torch.randn((dc, di), generator=generator,
                         device=generator.device) * dc ** -0.5
    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32)
                      .repeat(di, 1))
    return {
        "in_proj": dense_init(generator, (d, 2 * di), dtype=dtype,
                              device=device),
        "conv_w": conv_w.to(dtype=dtype, device=device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": dense_init(generator, (di, r + 2 * ds), dtype=dtype,
                             device=device),
        "dt_proj": dense_init(generator, (r, di), dtype=dtype, device=device),
        "dt_bias": torch.zeros((di,), dtype=dtype, device=device),
        "A_log": a_log.to(dtype=dtype, device=device),
        "D": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": dense_init(generator, (di, d), dtype=dtype,
                               device=device),
    }


def _ssm_inputs(p, cfg, xc):
    """xc: post-conv activations (B,L,di) of one chunk -> a, bx (B,L,di,ds)
    f32 and C (B,L,ds) in the model dtype."""
    r, ds = dt_rank(cfg), cfg.d_state
    proj = xc @ p["x_proj"]                                   # (B,L,r+2s)
    dt_low, bmat, cmat = proj.split([r, ds, ds], dim=-1)
    dt = F.softplus(dt_low @ p["dt_proj"] + p["dt_bias"])     # (B,L,di)
    a_cont = -torch.exp(p["A_log"].float())                   # (di,ds)
    a = torch.exp(dt[..., None].float() * a_cont)
    bx = (dt[..., None] * bmat[:, :, None, :]).float() * xc[..., None].float()
    return a, bx, cmat


def _scan_pairs(a, b):
    """Inclusive scan along axis 1 of the pairs (a_t, b_t) under
    (a1, b1) then (a2, b2) = (a1 a2, a2 b1 + b2), by doubling: after the
    step of stride k each position holds the combination of the 2k pairs
    ending there.  Returns (prod a, h with h_{-1} = 0), both f32.  Where
    autograd records (training, on the CPU or the card), the same products
    run out of place: ``out=`` buffers cannot carry a gradient."""
    n = a.shape[1]
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        k = 1
        while k < n:
            b = torch.cat([b[:, :k], torch.addcmul(b[:, k:], a[:, k:],
                                                   b[:, :-k])], dim=1)
            a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
            k *= 2
        return a, b
    a2, b2 = torch.empty_like(a), torch.empty_like(b)
    k = 1
    while k < n:
        torch.addcmul(b[:, k:], a[:, k:], b[:, :-k], out=b2[:, k:])
        b2[:, :k] = b[:, :k]
        torch.mul(a[:, k:], a[:, :-k], out=a2[:, k:])
        a2[:, :k] = a[:, :k]
        a, a2, b, b2 = a2, a, b2, b
        k *= 2
    return a, b


def _chunk_scan(p, cfg, xc, h):
    """Selective scan of xc (B,L,di) from state h (B,di,ds) f32, sequential
    over chunks of ``cfg.scan_chunk`` tokens (the last may be shorter).
    Returns (y (B,L,di) f32, the state after the last token)."""
    chunk = cfg.scan_chunk
    ys = []
    for c0 in range(0, xc.shape[1], chunk):
        a, bx, cmat = _ssm_inputs(p, cfg, xc[:, c0:c0 + chunk])
        pa, pb = _scan_pairs(a, bx)
        h_all = torch.addcmul(pb, pa, h[:, None])             # (B,c,di,ds)
        ys.append(torch.einsum("bcds,bcs->bcd", h_all, cmat.float()))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h


def apply(p, cfg, x, *, return_state: bool = False):
    """x: (B,L,D) -> (B,L,D).  With ``return_state`` also (conv_state
    (B,d_conv-1,di) in x's dtype, ssm_state (B,di,ds) f32), the decode
    states after the last token; a prompt shorter than d_conv - 1 tokens
    gets a conv state zero-padded on the left, as the causal conv pads."""
    b, l, _ = x.shape
    xi, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xc = ops.conv1d(xi, p["conv_w"], bias=p["conv_b"], act="silu")
    h0 = torch.zeros((b, cfg.d_inner, cfg.d_state), dtype=torch.float32,
                     device=x.device)
    with torch.profiler.record_function("mamba.scan"):
        y, h_t = _chunk_scan(p, cfg, xc, h0)
    y = y + p["D"].float() * xc.float()
    y = y * F.silu(z.float())
    out = y.to(x.dtype) @ p["out_proj"]
    if return_state:
        keep = cfg.d_conv - 1
        conv = F.pad(xi[:, max(l - keep, 0):], (0, 0, max(keep - l, 0), 0))
        return out, (conv.to(x.dtype).contiguous(), h_t)
    return out


def decode(p, cfg, x, state):
    """One-token decode.  x: (B,1,D); state = (conv_state (B,d_conv-1,di),
    ssm_state (B,di,ds) f32), both updated in place.  Returns (out (B,1,D),
    state)."""
    conv_state, h = state
    xi, z = (x @ p["in_proj"]).chunk(2, dim=-1)               # (B,1,di)
    window = torch.cat([conv_state, xi], dim=1)                # (B,dc,di)
    xc = (window.float() * p["conv_w"].float()[None]).sum(dim=1, keepdim=True)
    xc = F.silu(xc + p["conv_b"].float()).to(x.dtype)
    a, bx, cmat = _ssm_inputs(p, cfg, xc)                     # L = 1
    h.copy_(torch.addcmul(bx[:, 0], a[:, 0], h))
    y = torch.einsum("bds,bs->bd", h, cmat[:, 0].float())[:, None]
    y = y + p["D"].float() * xc.float()
    y = y * F.silu(z.float())
    conv_state.copy_(window[:, 1:])
    return y.to(x.dtype) @ p["out_proj"], (conv_state, h)
