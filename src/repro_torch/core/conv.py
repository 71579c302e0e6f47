"""Conv dispatch, the port's counterpart of ``repro/core/conv.py``.

Forward: the direct-conv kernel K1 with its fused epilogue.  Training:
``conv2d_train``, a ``torch.autograd.Function`` whose backward is the
paper's pipeline: dI by the §II-I duality (``core.duality``), every dual
forward through K1, and dW through the update-pass kernel K2 (§II-J).
Convs whose (C, K) fail the lane rule take the ``kernels.ref`` oracles, as
in the reference.  int8 and chains come with later slices.
"""
from __future__ import annotations

import torch

from repro_torch.core import duality
from repro_torch.kernels import ref
from repro_torch.kernels.conv2d_direct import conv2d_direct
from repro_torch.kernels.conv2d_wu import conv2d_wu


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


def _dual_fwd(x, w, stride, padding):
    """One forward launch of the backward-data pass."""
    return conv2d_fwd(x, w, stride=stride, padding=padding)


def conv2d_bwd_data_via_fwd(do, w, *, stride, padding, input_hw, mode=None):
    """dI by the §II-I duality: transform the weights, run the forward
    conv.  The generic (stride > 1, R,S > 1) case follows ``mode`` /
    ``REPRO_BWD_DUALITY``: "phase" (default) launches stride² forward
    sub-convs over the undilated dO; "dilate" is the materialized A/B
    plan."""
    r, s = w.shape[0], w.shape[1]
    scenario, _ = duality.bwd_data_plan(r=r, s=s, stride=stride,
                                        padding=padding, input_hw=input_hw,
                                        mode=mode)
    if scenario == "phase":
        return duality.phase_bwd_data(do, w, stride=stride, padding=padding,
                                      input_hw=input_hw, conv_fn=_dual_fwd)
    do2, wt, kw, post = duality.prepare_bwd_data(
        do, w, stride=stride, padding=padding, input_hw=input_hw, mode=mode)
    return post(_dual_fwd(do2, wt, kw["stride"], kw["padding"]))


def conv2d_bwd_weights(x, do, *, stride, padding, filter_rs):
    """dW by the update-pass kernel K2 (§II-J) for lane-aligned (C, K),
    ``ref.conv2d_bwd_weights`` otherwise."""
    c, k = x.shape[-1], do.shape[-1]
    if not lane_ok(c, k):
        return ref.conv2d_bwd_weights(x, do, stride=stride, padding=padding,
                                      filter_rs=filter_rs)
    return conv2d_wu(x, do, stride=stride, padding=padding,
                     filter_rs=filter_rs)


class _Conv2dTrain(torch.autograd.Function):
    """Forward: ``conv2d_fwd`` with no epilogue.  Backward: dI through the
    duality plan (skipped when the input needs no gradient, as for the
    image), dW through K2.  The incoming dO is made contiguous here and
    the transformed weights in ``duality.transform_weights``: the kernels
    take contiguous operands only."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        return conv2d_fwd(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, do):
        x, w = ctx.saved_tensors
        do = do.contiguous()
        di = dw = None
        if ctx.needs_input_grad[0]:
            di = conv2d_bwd_data_via_fwd(do, w, stride=ctx.stride,
                                         padding=ctx.padding,
                                         input_hw=(x.shape[1], x.shape[2]))
        if ctx.needs_input_grad[1]:
            dw = conv2d_bwd_weights(x, do, stride=ctx.stride,
                                    padding=ctx.padding,
                                    filter_rs=(w.shape[0], w.shape[1]))
        return di, dw, None, None


def conv2d_train(x, w, stride: int, padding: int):
    """Differentiable direct conv whose backward is the paper's pipeline.
    x (N,H,W,C), w (R,S,C,K) -> (N,P,Q,K)."""
    return _Conv2dTrain.apply(x, w, stride, padding)
