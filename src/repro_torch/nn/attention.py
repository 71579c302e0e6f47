"""GQA attention (optional QKV bias, qk-norm) with prefill and decode
paths, the counterpart of ``repro/nn/attention.py``.

Prefill (``apply``) goes through ``ops.attention``: K7 on the card, its
plain version on the CPU.  Decode stays plain torch, as in the reference
(the memory-bound KV-cache GEMV): logits in f32, masked to ``-1e30`` past
the current position, softmax, cast back.  The reference's
``partitioning.constrain`` calls have no counterpart on one device.

Unlike the reference, ``decode`` writes the new key and value into the
cache in place and returns the same tensors: one (B, Hkv, 1, Dh) write per
layer instead of a new copy of the whole cache every step.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.nn.common import apply_rope, dense_init, rms_norm


def init(generator, cfg, dtype, device=None):
    d, hd = cfg.d_model, cfg.head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    p = {}
    for name, shape in (("wq", (d, nh * hd)), ("wk", (d, nkv * hd)),
                        ("wv", (d, nkv * hd)), ("wo", (nh * hd, d))):
        p[name] = dense_init(generator, shape, dtype=dtype, device=device)
    if cfg.qkv_bias:
        for name, width in (("bq", nh * hd), ("bk", nkv * hd),
                            ("bv", nkv * hd)):
            p[name] = torch.zeros((width,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def specs(cfg) -> dict:
    """The logical axes of each leaf ``init`` makes (the reference's spec
    tree, ``attention.py:15-31``)."""
    s = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
         "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}
    if cfg.qkv_bias:
        s.update(bq=("heads",), bk=("kv_heads",), bv=("kv_heads",))
    if cfg.qk_norm:
        s.update(q_norm=(None,), k_norm=(None,))
    return s


def _project(p, cfg, x):
    """x: (B,L,D) -> q (B,Hq,L,Dh), k and v (B,Hkv,L,Dh), contiguous."""
    b, l, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, l, nh, hd).transpose(1, 2).contiguous()
    k = k.reshape(b, l, nkv, hd).transpose(1, 2).contiguous()
    v = v.reshape(b, l, nkv, hd).transpose(1, 2).contiguous()
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], eps=cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], eps=cfg.norm_eps)
    return q, k, v


def apply(p, cfg, x, positions, *, return_kv: bool = False):
    """Full-sequence causal attention.  x: (B,L,D), positions: (B,L)."""
    b, l, _ = x.shape
    q, k, v = _project(p, cfg, x)
    q = apply_rope(q, positions[:, None, :], theta=cfg.rope_theta)
    k = apply_rope(k, positions[:, None, :], theta=cfg.rope_theta)
    o = ops.attention(q, k, v, causal=True)
    o = o.transpose(1, 2).reshape(b, l, cfg.n_heads * cfg.head_dim)
    out = o @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def decode(p, cfg, x, cache_kv, idx):
    """One-token decode.  x: (B,1,D); cache_kv = (K, V), each
    (B,Hkv,S,Dh); idx: the current position, an int or 0-d tensor
    (lockstep batch) or a (B,) tensor (continuous batching: per-lane
    positions).  Writes this token's K/V at ``idx`` in place and returns
    (out (B,1,D), (K, V))."""
    b = x.shape[0]
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    ck, cv = cache_kv
    s = ck.shape[2]
    idx = torch.as_tensor(idx, device=x.device)
    per_lane = idx.dim() == 1
    pos = (idx.long()[:, None] if per_lane
           else idx.long().expand(b)[:, None])                   # (B,1)
    q, k, v = _project(p, cfg, x)
    q = apply_rope(q, pos[:, None, :], theta=cfg.rope_theta)
    k = apply_rope(k, pos[:, None, :], theta=cfg.rope_theta)
    lanes = torch.arange(b, device=x.device)
    ck[lanes, :, pos[:, 0]] = k[:, :, 0].to(ck.dtype)
    cv[lanes, :, pos[:, 0]] = v[:, :, 0].to(cv.dtype)
    rep = nh // nkv
    qg = q.reshape(b, nkv, rep, hd)                              # (B,Hkv,rep,Dh)
    logits = torch.einsum("bgrd,bgsd->bgrs", qg.float(),
                          ck.float()) * (hd ** -0.5)
    mask = torch.arange(s, device=x.device) <= pos[:, None, None, :]
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bgrs,bgsd->bgrd", probs, cv.float())
    o = o.reshape(b, 1, nh * hd).to(x.dtype)
    return o @ p["wo"], (ck, cv)
