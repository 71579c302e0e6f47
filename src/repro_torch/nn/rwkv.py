"""RWKV-6 (Finch) time mix with data-dependent decay, the counterpart of
``repro/nn/rwkv.py``.

Attention-free: the WKV recurrence carries an (H, dh, dh) f32 state per
sequence,
  S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t ;  y_t = (S_{t-1} + diag(u) k_t ⊗ v_t) r_t
with the decay w_t = exp(-exp(dec_t)) in f32 from a LoRA of the token's
mix (``_LORA`` = 64, ``dec_bias`` -6): the Finch contribution.  Token shift
is a size-1 temporal shift, not a convolution.  After the recurrence a
per-head group norm (``ln_x``), the SiLU gate and the output projection.

The recurrence stays plain PyTorch, a loop over tokens, as the reference's
is plain JAX (``lax.scan``) under ``jit``: no kernel is involved.  It walks
chunks of ``CHUNK`` tokens; where grad is enabled each chunk's body runs
under ``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
reference's ``@jax.checkpoint`` on its chunk body, so the backward holds
one (B, H, dh, dh) state a chunk instead of one a token.  Unlike the
reference, which makes a ragged L one chunk, the last chunk may be
shorter: the same recurrence, less memory.  The output y_t is computed as
S_{t-1}ᵀ r_t + v_t (u k_t · r_t), the reference's product with its sum
split: the loop over tokens carries only the state (a product with r_t,
then S_t = w_t S_{t-1} + k_t ⊗ v_t: three launches a token and layer),
and the bonus term is added for a whole chunk at once.

``decode`` writes the token shift ``x_prev`` and the state ``s`` into the
cache in place, as the port's attention and Mamba decode do.  The group
norm divides by ``torch.sqrt`` rather than multiplying by ``torch.rsqrt``,
whose approximate CUDA version would move the card's logits off the CPU's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.nn.common import dense_init

_LORA = 64
CHUNK = 64       # tokens a chunk of the recurrence (the reference's chunk)
NORM_EPS = 1e-5  # the group norm's epsilon


def init(generator, cfg, dtype, device=None):
    d = cfg.d_model
    p = {name: dense_init(generator, (d, d), dtype=dtype, device=device)
         for name in ("w_r", "w_k", "w_v", "w_g", "w_o")}
    p["w_dec_a"] = dense_init(generator, (d, _LORA), dtype=dtype,
                              device=device)
    p["w_dec_b"] = dense_init(generator, (_LORA, d), dtype=dtype,
                              device=device)
    p["dec_bias"] = torch.full((d,), -6.0, dtype=dtype, device=device)
    for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
        p[name] = torch.full((d,), 0.5, dtype=dtype, device=device)
    nh = cfg.n_heads
    p["u"] = torch.zeros((nh, d // nh), dtype=dtype, device=device)
    p["ln_x"] = torch.ones((d,), dtype=dtype, device=device)
    return p


def specs(cfg) -> dict:
    """The logical axes of ``init``'s leaves (``rwkv.py:20-37``)."""
    s = {name: ("embed", "heads") for name in ("w_r", "w_k", "w_v", "w_g")}
    s.update(w_o=("heads", "embed"), w_dec_a=("embed", None),
             w_dec_b=(None, "heads"), dec_bias=("heads",),
             u=("heads", None), ln_x=("heads",))
    s.update({name: ("embed",) for name in ("mu_r", "mu_k", "mu_v", "mu_g",
                                            "mu_w")})
    return s


def _mix(x, x_prev, mu):
    return x + mu * (x_prev - x)


def _proj_rkvgw(p, cfg, x, x_prev):
    """-> r, k, v (B,L,H,dh) in x's dtype, the gate g (B,L,D) and the decay
    w (B,L,H,dh) f32."""
    b, l, d = x.shape
    nh = cfg.n_heads
    hshape = (b, l, nh, d // nh)
    r = _mix(x, x_prev, p["mu_r"]) @ p["w_r"]
    k = _mix(x, x_prev, p["mu_k"]) @ p["w_k"]
    v = _mix(x, x_prev, p["mu_v"]) @ p["w_v"]
    g = F.silu(_mix(x, x_prev, p["mu_g"]) @ p["w_g"])
    xw = _mix(x, x_prev, p["mu_w"])
    dec = torch.tanh(xw @ p["w_dec_a"]) @ p["w_dec_b"] + p["dec_bias"]
    w = torch.exp(-torch.exp(dec.float()))                  # (B,L,D) in (0,1)
    return (r.reshape(hshape), k.reshape(hshape), v.reshape(hshape), g,
            w.reshape(hshape))


def _chunk_body(s, r, k, v, w, u):
    """Tokens of one chunk in order: r, k, v, w (B,c,H,dh) f32 -> (the
    state after the chunk, y (B,c,H,dh))."""
    rt, kt, vt, wt = (t.transpose(0, 1).contiguous() for t in (r, k, v, w))
    ys = []
    for t in range(rt.shape[0]):
        ys.append(torch.matmul(rt[t, ..., None, :], s)[..., 0, :])
        s = torch.addcmul(wt[t, ..., None] * s, kt[t, ..., None],
                          vt[t, ..., None, :])
    # each token's own term, v (u k · r), for the whole chunk at once
    return s, torch.stack(ys, dim=1) + v * (u * k * r).sum(-1, keepdim=True)


def _wkv_scan(r, k, v, w, u, s0):
    """The WKV recurrence over r, k, v (B,L,H,dh), w (B,L,H,dh) f32, u
    (H,dh) f32, from the state s0 (B,H,dh,dh) f32, in chunks of ``CHUNK``
    tokens, each checkpointed where autograd records them.  Returns (y
    (B,L,H,dh) f32, the state after the last token)."""
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (r, k, v, w, u, s0))
    s, ys = s0, []
    for c0 in range(0, r.shape[1], CHUNK):
        chunk = [t[:, c0:c0 + CHUNK].float() for t in (r, k, v, w)]
        if remat:
            s, y = checkpoint(_chunk_body, s, *chunk, u, use_reentrant=False)
        else:
            s, y = _chunk_body(s, *chunk, u)
        ys.append(y)
    return torch.cat(ys, dim=1), s


def _group_norm(p, y, dtype):
    """Per-head norm of y (B,L,H,dh) f32 (population variance, eps 1e-5),
    times ``ln_x``, as (B,L,D) in ``dtype``."""
    b, l, nh, dh = y.shape
    y = (y - y.mean(dim=-1, keepdim=True)) \
        / torch.sqrt(y.var(dim=-1, unbiased=False, keepdim=True) + NORM_EPS)
    return (y.reshape(b, l, nh * dh) * p["ln_x"].float()).to(dtype)


def apply(p, cfg, x, *, return_state: bool = False):
    """x: (B,L,D) -> (B,L,D).  With ``return_state`` also (x_prev (B,D), the
    last token of x, and s (B,H,dh,dh) f32), the decode state after the
    last token."""
    b, l, d = x.shape
    nh = cfg.n_heads
    dh = d // nh
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, g, w = _proj_rkvgw(p, cfg, x, x_prev)
    s0 = torch.zeros((b, nh, dh, dh), dtype=torch.float32, device=x.device)
    y, s_t = _wkv_scan(r, k, v, w, p["u"].float(), s0)
    out = (_group_norm(p, y, x.dtype) * g) @ p["w_o"]
    if return_state:
        return out, (x[:, -1, :], s_t)
    return out


def decode(p, cfg, x, state):
    """One-token decode.  x: (B,1,D); state = (x_prev (B,D), s (B,H,dh,dh)
    f32), both updated in place.  Returns (out (B,1,D), state)."""
    xp_last, s = state
    r, k, v, g, w = _proj_rkvgw(p, cfg, x, xp_last[:, None, :])
    s_next, y = _chunk_body(s, *(t.float() for t in (r, k, v, w)),
                            p["u"].float())
    out = (_group_norm(p, y, x.dtype) * g) @ p["w_o"]
    s.copy_(s_next)
    xp_last.copy_(x[:, -1, :])
    return out, (xp_last, s)
