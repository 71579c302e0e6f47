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
``grad`` call too.  The matmul and LM oracles arrive with the slices that
need them.
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


def conv2d_bwd_data(do, w, *, stride: int = 1, padding: int = 0, input_hw):
    """dI from dO and W (paper §II-I).  do: (N,P,Q,K), w: (R,S,C,K) ->
    (N,H,W,C), the exact VJP of ``conv2d`` with respect to its input."""
    n = do.shape[0]
    c = w.shape[2]
    h, wd = input_hw
    with torch.enable_grad(), \
            torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
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
            torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        w0 = torch.zeros((r, s, c, k), dtype=torch.float32, device=x.device,
                         requires_grad=True)
        out = conv2d(x.detach(), w0, stride=stride, padding=padding)
        (dw,) = torch.autograd.grad(out, w0, do)
    return dw
