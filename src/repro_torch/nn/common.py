"""Shared NN primitives: RMS norm, rotary embeddings, init helpers.

The counterpart of ``repro/nn/common.py``, with the LM loss
``softmax_xent``.  Params are plain dicts of tensors.  Each module's
``specs(cfg)`` mirrors its ``init``'s tree with tuples of *logical* axis
names ("embed", "heads", "mlp", "vocab", "expert", ...), as the reference's
init functions return beside their params; ``nn/partitioning.py`` maps
them onto a mesh.
"""
from __future__ import annotations

import torch


def rms_norm(x, scale, *, eps: float = 1e-5):
    """x * rsqrt(mean(x²) + eps) * scale, computed in f32, cast back to
    x's dtype (``common.py:15-19``)."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dtype)


def rms_norm_specs() -> tuple:
    """The logical axes of an RMS norm's scale (``common.py:22-23``)."""
    return ("embed",)


def dense_init(generator: torch.Generator, shape, *, scale=None,
               dtype=torch.float32, device=None):
    """Normal(0, 1) * ``scale`` (default fan_in ** -0.5, fan_in =
    shape[0]), drawn in f32 on the generator's device, then cast to
    ``dtype`` and moved to ``device``; without a generator (the meta
    device: shapes only) drawn on ``device``."""
    scale = scale if scale is not None else shape[0] ** -0.5
    w = torch.randn(shape, generator=generator, device=(
        generator.device if generator is not None else device))
    return (w * scale).to(dtype=dtype, device=device)


def rope_freqs(d_head: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x, positions, *, theta: float = 1e4):
    """x: (..., L, Dh), positions: (..., L) ints.  Rotates the two halves
    x1 | x2 of the head (not interleaved pairs), in f32, cast back."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)          # (Dh/2,)
    ang = positions[..., None].float() * freqs              # (..., L, Dh/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softmax_xent(logits, labels, *, z_loss: float = 0.0):
    """Mean token cross-entropy of ``logits`` (..., V) against ``labels``
    (...) ints, over the labels >= 0 (-1 masks a position out); logsumexp
    in f32; with ``z_loss``, plus z_loss * logsumexp² per kept token
    (``common.py:48``)."""
    mask = (labels >= 0).float()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long().clamp_min(0)[..., None])[..., 0]
    loss = (logz - gold) * mask
    if z_loss:
        loss = loss + z_loss * logz ** 2 * mask
    return loss.sum() / mask.sum().clamp_min(1.0)
