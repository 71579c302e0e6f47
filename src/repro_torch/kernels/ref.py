"""Plain-PyTorch oracles, the port's counterpart of ``repro/kernels/ref.py``.

Ground truth for the tests and the path of convs the kernels do not take
(the C=3 ResNet stem).  Layouts are the reference's: activations NHWC,
weights RSCK, conv outputs NPQK; the NCHW/KCRS permutes that
``F.conv2d`` wants stay inside this module.

On the card these must compute true f32: cuDNN would run an f32
convolution in TF32 by default, so ``conv2d`` turns it off locally, and
``repro_torch.backend.resolve_device`` turns it off process-wide.

Only the forward oracles live here so far; the backward, matmul and LM
oracles arrive with the slices that need them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x, w, *, stride: int = 1, padding: int = 0):
    """Forward conv in f32. x: (N,H,W,C), w: (R,S,C,K) -> (N,P,Q,K)."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
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
