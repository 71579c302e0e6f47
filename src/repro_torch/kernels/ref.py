"""Plain-PyTorch oracles, the port's counterpart of ``repro/kernels/ref.py``.

Ground truth for the tests and the path of convs the kernels do not take
(the C=3 ResNet stem).  Layouts are the reference's: activations NHWC,
weights RSCK, conv outputs NPQK; the NCHW/KCRS permutes that
``F.conv2d`` wants stay inside this module.

On the card these must compute true f32: cuDNN would run an f32
convolution in TF32 by default, so ``conv2d`` turns it off locally, and
``repro_torch.backend.resolve_device`` turns it off process-wide.

The backward oracles are the exact VJPs of ``conv2d``, taken with
``torch.autograd.grad``.  A convolution's backward runs when ``grad`` is
called, not when the forward ran, so the TF32-off block encloses the
``grad`` call too.

The LM oracles (``matmul_fused``, ``attention_chunked``) follow
``repro/kernels/ref.py``: GELU is ``jax.nn.gelu``'s tanh form.  The
reference has two attention oracles, ``attention`` (full softmax, ``-inf``
causal mask) and ``attention_chunked`` (query chunks, finite ``-1e30``
mask, falling back to ``attention`` when the chunk does not divide L).  The
port keeps one, ``attention_chunked``, whose last chunk may be ragged: a
chunk of L is the reference's ``attention``, since every causal row keeps
its diagonal and so ``-1e30`` and ``-inf`` give the same softmax.
``conv1d_causal`` is ``repro/kernels/ref.py:134-145`` and ``moe_gmm``
``:217-230``, computed segment by segment: one (rows_e, D) @ (D, F)
product per expert, where the reference gathers a (T, D, F) weight per
row.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _true_f32():
    """cuDNN in true f32 (TF32 off) for the block, its ``benchmark`` and
    ``deterministic`` choices left as the caller set them
    (``cudnn.flags`` would reset both to False)."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def conv2d(x, w, *, stride: int = 1, padding: int = 0):
    """Forward conv in f32. x: (N,H,W,C), w: (R,S,C,K) -> (N,P,Q,K)."""
    with _true_f32():
        out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                       stride=stride, padding=padding)
    return out.permute(0, 2, 3, 1).contiguous()


def conv2d_fused(x, w, *, stride: int = 1, padding: int = 0,
                 bias=None, scale=None, shift=None, residual=None,
                 relu: bool = False):
    """Conv with the paper's §II-G fused epilogue, in the reference's order:
    O = act(scale * conv(x,w) + shift + bias [+ residual])."""
    out = conv2d(x, w, stride=stride, padding=padding)
    if scale is not None:
        out = out * scale
    if shift is not None:
        out = out + shift
    if bias is not None:
        out = out + bias
    if residual is not None:
        out = out + residual
    if relu:
        out = torch.clamp_min(out, 0)
    return out


def conv2d_bwd_data(do, w, *, stride: int = 1, padding: int = 0, input_hw):
    """dI from dO and W (paper §II-I).  do: (N,P,Q,K), w: (R,S,C,K) ->
    (N,H,W,C), the exact VJP of ``conv2d`` with respect to its input."""
    n = do.shape[0]
    c = w.shape[2]
    h, wd = input_hw
    with torch.enable_grad(), \
            _true_f32():
        x0 = torch.zeros((n, h, wd, c), dtype=torch.float32,
                         device=do.device, requires_grad=True)
        out = conv2d(x0, w.detach(), stride=stride, padding=padding)
        (di,) = torch.autograd.grad(out, x0, do)
    return di


def conv2d_bwd_weights(x, do, *, stride: int = 1, padding: int = 0,
                       filter_rs=None):
    """dW from I and dO (paper §II-J).  Returns (R,S,C,K), the exact VJP of
    ``conv2d`` with respect to its weights.  ``filter_rs`` disambiguates
    the filter size of a strided conv."""
    n, h, wd, c = x.shape
    _, p, q, k = do.shape
    if filter_rs is not None:
        r, s = filter_rs
    else:
        r = h + 2 * padding - (p - 1) * stride
        s = wd + 2 * padding - (q - 1) * stride
    with torch.enable_grad(), \
            _true_f32():
        w0 = torch.zeros((r, s, c, k), dtype=torch.float32, device=x.device,
                         requires_grad=True)
        out = conv2d(x.detach(), w0, stride=stride, padding=padding)
        (dw,) = torch.autograd.grad(out, w0, do)
    return dw


# ---------------------------------------------------------------------------
# LM oracles
# ---------------------------------------------------------------------------

def _act(out, act: str):
    if act == "relu":
        return torch.clamp_min(out, 0)
    if act == "gelu":
        return F.gelu(out, approximate="tanh")   # jax.nn.gelu's default
    if act == "silu":
        return F.silu(out)
    if act != "none":
        raise ValueError(act)
    return out


def matmul_fused(a, b, *, bias=None, act: str = "none", residual=None):
    """act(a @ b + bias [+ residual]) in f32, cast to a's dtype.
    a: (M,K), b: (K,N)."""
    out = a.float() @ b.float()
    if bias is not None:
        out = out + bias.float()
    if residual is not None:
        out = out + residual.float()
    return _act(out, act).to(a.dtype)


def _repeat_kv(q, k, v):
    hq, hkv = q.shape[1], k.shape[1]
    if hkv != hq:
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    return k, v


def attention_chunked(q, k, v, *, causal: bool = True, scale=None,
                      chunk: int = 512):
    """q: (B,Hq,L,Dh), k/v: (B,Hkv,L,Dh), GQA by head repeat -> (B,Hq,L,Dh).
    f32 logits, ``-1e30`` causal mask, full softmax over each chunk of
    ``chunk`` queries (O(chunk x L) logits at a time; the last chunk may be
    shorter)."""
    l, dh = q.shape[2], q.shape[3]
    if scale is None:
        scale = dh ** -0.5
    k, v = _repeat_kv(q, k, v)
    kf, vf = k.float(), v.float()
    kpos = torch.arange(l, device=q.device)
    outs = []
    for q0 in range(0, l, chunk):
        qi = q[:, :, q0:q0 + chunk]
        logits = torch.einsum("bhqd,bhkd->bhqk", qi.float(), kf) * scale
        if causal:
            qpos = q0 + torch.arange(qi.shape[2], device=q.device)
            mask = qpos[:, None] >= kpos[None, :]
            logits = torch.where(mask, logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype))
    return torch.cat(outs, dim=2)


# ---------------------------------------------------------------------------
# Depthwise causal conv1d (the Mamba mixer)
# ---------------------------------------------------------------------------

def conv1d_causal(x, w, *, bias=None, act: str = "silu"):
    """x: (B,L,D), w: (KW,D) depthwise causal -> (B,L,D) in x's dtype: left
    pad KW - 1 zeros, the f32 sum of the KW shifted products, + bias, then
    act ("silu" or "none")."""
    if act not in ("silu", "none"):
        raise ValueError(act)
    kw, l = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, kw - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(kw):
        out = out + xp[:, i:i + l].float() * w[i].float()
    if bias is not None:
        out = out + bias.float()
    return _act(out, act).to(x.dtype)


# ---------------------------------------------------------------------------
# Grouped matmul for MoE dispatch (kernel streams, paper §II-H)
# ---------------------------------------------------------------------------

def moe_gmm(tokens, weights, group_sizes):
    """Grouped matmul.  tokens: (T, D) sorted by expert; weights: (E, D, F);
    group_sizes: (E,) ints summing to T.  Row t uses the expert whose
    segment holds it.  Sums in f32, output in the tokens' dtype."""
    t, d = tokens.shape
    e, dw, f = weights.shape
    sizes = [int(n) for n in torch.as_tensor(group_sizes).tolist()]
    if dw != d or len(sizes) != e or min(sizes, default=0) < 0 \
            or sum(sizes) != t:
        raise ValueError(f"tokens {tuple(tokens.shape)}, weights "
                         f"{tuple(weights.shape)}: group_sizes {sizes} must "
                         f"be {e} non-negative ints summing to {t}")
    out = torch.empty((t, f), dtype=tokens.dtype, device=tokens.device)
    start = 0
    for eid, n in enumerate(sizes):
        out[start:start + n] = (tokens[start:start + n].float()
                                @ weights[eid].float()).to(tokens.dtype)
        start += n
    return out
