"""Conv dispatch, the port's counterpart of ``repro/core/conv.py``.

Only the inference forward is here; the training VJP (duality and the
weight-update kernel), int8, chains and backward come with later slices.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.conv2d_direct import conv2d_direct


def lane_ok(c: int, k: int) -> bool:
    """True when (C, K) take the direct-conv kernel; small-C layers (the
    C=3 ResNet stem) take the reference path, as in the JAX package."""
    return c % 8 == 0 and k % 8 == 0


def conv2d_fwd(x, w, *, stride=1, padding=1, bias=None, scale=None,
               shift=None, residual=None, relu=False):
    """Fused forward conv: K1 for lane-aligned (C, K), ``ref.conv2d_fused``
    otherwise.  K1 itself picks its plain version on a CPU tensor."""
    c, k = x.shape[-1], w.shape[-1]
    fn = conv2d_direct if lane_ok(c, k) else ref.conv2d_fused
    return fn(x, w, stride=stride, padding=padding, bias=bias, scale=scale,
              shift=shift, residual=residual, relu=relu)
