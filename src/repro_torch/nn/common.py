"""Shared NN primitives: RMS norm, rotary embeddings, init helpers.

The counterpart of ``repro/nn/common.py``.  Params are plain dicts of
tensors; the reference's logical-axis specs have no counterpart on one
device.  ``softmax_xent`` waits for the LM training slice.
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


def dense_init(generator: torch.Generator, shape, *, scale=None,
               dtype=torch.float32, device=None):
    """Normal(0, 1) * ``scale`` (default fan_in ** -0.5, fan_in =
    shape[0]), drawn in f32 on the generator's device, then cast to
    ``dtype`` and moved to ``device``."""
    scale = scale if scale is not None else shape[0] ** -0.5
    w = torch.randn(shape, generator=generator, device=generator.device)
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
