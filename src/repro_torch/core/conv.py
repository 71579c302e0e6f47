"""Conv dispatch, the port's counterpart of ``repro/core/conv.py``.

Forward: the direct-conv kernel K1 with its fused epilogue.  Training:
``conv2d_train``, a ``torch.autograd.Function`` whose backward is the
paper's pipeline: dI by the §II-I duality (``core.duality``), every dual
forward through K1, and dW through the update-pass kernel K2 (§II-J).
int8 inference (§II-K): ``conv2d_q8_fwd`` quantizes the activation and
runs the int8 kernel K3.  Convs whose (C, K) fail the lane rule take the
``kernels.ref`` oracles, as in the reference.  ``conv2d_chain_fwd`` runs
a conv->conv chain band by band (``kernels.conv2d_chain``), each band
through the same dispatch.

Each tiled launch takes the kernel plan ``tune.resolve_plan`` gives for
its kind, shape and batch under the autotune mode (``autotune=``, else
``backend.get_autotune``), as the reference asks ``conv_blocking(...,
autotune=, kind=, minibatch=n)`` for each launch's blocking
(``repro/core/conv.py:41-64, 109-111, 122-168``): "fwd" for a forward,
"bwd" for a backward-data dual conv, "q8" for an int8 forward, "wu" for a
weight gradient.  A launch whose route takes no plan (K1's and K2's SIMT
routes, K3's "sync") asks for none.

Under ``REPRO_CONV_TILING=whole`` (``backend.get_conv_tiling``, read at
each call) every lane-aligned conv takes the reference's legacy
whole-plane kernels instead, with the reference's blocking
(``repro/core/conv.py:56-64, 162-178``): K10a for each forward and dual
conv, K10c for each int8 forward, K10b for each weight gradient.  There is
no fallback from one strategy to the other.  Their blocking is the
reference's analytic one with autotuning off, and the tuned one of the
kind "fwd_whole", "bwd_whole", "q8_whole" or "wu_whole" under "cache" or
"tune" (``whole_blocking``).
"""
from __future__ import annotations

import torch

from repro_torch import backend as be
from repro_torch import tune
from repro_torch.core import duality
from repro_torch.core.quantize import quantize_act
from repro_torch.kernels import conv2d_direct as k1
from repro_torch.kernels import conv2d_q8 as k3
from repro_torch.kernels import conv2d_wu as k2
from repro_torch.kernels import ref
from repro_torch.kernels.conv2d_direct import (conv2d_direct,
                                               conv2d_direct_whole)
from repro_torch.kernels.conv2d_q8 import _deq, conv2d_q8, conv2d_q8_whole
from repro_torch.kernels.conv2d_wu import conv2d_wu, conv2d_wu_whole


def lane_ok(c: int, k: int) -> bool:
    """True when (C, K) take the direct-conv kernel; small-C layers (the
    C=3 ResNet stem) take the reference path, as in the JAX package."""
    return c % 8 == 0 and k % 8 == 0


def whole_blocking(x_shape, w_shape, *, stride, padding, kind, backend=None,
                   autotune=None):
    """The blocking of a whole-plane launch, as ``repro/core/conv.py``
    asks ``conv_blocking`` for it at the reference's budget with
    ``minibatch`` N.  ``kind`` is "fwd", "bwd" (a dual conv), "q8" (one
    byte an element) or "wu" (the update pass, whose rb_p, then b_p, must
    divide P).  Under ``autotune`` (None: the knob) "off", the reference's
    analytic blocking (``tune.default_plan`` of the kind + "_whole");
    under "cache" or "tune" the blocking ``tune.resolve_plan`` gives for
    that kind, memoised (``backend`` None: the default device)."""
    n, h, wd, c = x_shape
    r, s, _, k = w_shape
    shape = dict(h=h, w=wd, c=c, k=k, r=r, s=s, stride=stride,
                 padding=padding)
    mode = be.resolve_autotune(autotune)
    if mode == "off":
        return tune.default_plan(f"{kind}_whole", n=n, **shape)
    if backend is None:
        backend = be.resolve_device(None).type
    return tune.resolve_plan(f"{kind}_whole", n=n, **shape, backend=backend,
                             autotune=mode)


def _plan(kind, x, w_shape, stride, padding, autotune):
    """The kernel plan of one tiled launch of ``kind`` (x's batch, shape
    and device, w's (R, S, C, K)): ``tune.resolve_plan``, memoised."""
    n, h, wd, c = x.shape
    r, s, _, k = w_shape
    return tune.resolve_plan(kind, n=n, h=h, w=wd, c=c, k=k, r=r, s=s,
                             stride=stride, padding=padding,
                             backend=x.device.type, autotune=autotune)


def conv2d_fwd(x, w, *, stride=1, padding=1, bias=None, scale=None,
               shift=None, residual=None, relu=False, kind="fwd",
               autotune=None):
    """Fused forward conv: K1 (K10a under ``whole``, its blocking of
    ``kind``: "fwd", or "bwd" for a dual conv) for lane-aligned (C, K),
    ``ref.conv2d_fused`` otherwise.  On K1's mma route the launch takes
    the plan of ``kind`` under ``autotune`` (None: the knob).  The
    kernel's wrapper itself picks its plain version on a CPU tensor."""
    c, k = x.shape[-1], w.shape[-1]
    kw = dict(stride=stride, padding=padding, bias=bias, scale=scale,
              shift=shift, residual=residual, relu=relu)
    if not lane_ok(c, k):
        return ref.conv2d_fused(x, w, **kw)
    if be.get_conv_tiling() == "whole":
        blk = whole_blocking(x.shape, w.shape, stride=stride,
                             padding=padding, kind=kind,
                             backend=x.device.type, autotune=autotune)
        return conv2d_direct_whole(x, w, rb_p=blk.rb_p, k_blk=blk.k_blk,
                                   **kw)
    plan = _plan(kind, x, w.shape, stride, padding, autotune) \
        if k1.route(x, w) == "mma" else None
    return conv2d_direct(x, w, plan=plan, **kw)


def conv2d_chain_fwd(x, layers, *, rb, autotune=None):
    """A single-consumer conv->conv chain run depth-first, band by band
    (``kernels.conv2d_chain``): each band takes the dispatch of
    ``conv2d_fwd`` with its layer's full-shape plan or blocking, so the
    result equals the layer-by-layer one bit for bit."""
    from repro_torch.kernels.conv2d_chain import conv2d_chain
    return conv2d_chain(x, layers, rb=rb, autotune=autotune)


def conv2d_q8_fwd(x, w_q, *, x_scale, w_scale, stride=1, padding=1,
                  bias=None, scale=None, shift=None, residual=None,
                  relu=False, autotune=None):
    """Fused quantized forward conv (§II-K): quantize the f32 activation
    against its calibrated per-tensor scale (plain torch: XLA glue in the
    reference), run K3 for lane-aligned (C, K), return f32.  On K3's ring
    route the launch takes the "q8" plan under ``autotune`` (None: the
    knob).

    The C=3 stem follows the reference's fallback: ``ref.conv2d_fused`` on
    the int8 operands cast to f32, with the premultiplied dequant scale
    folded into the BN-scale slot, ``acc*(deq*bn)`` where K3 computes
    ``(acc*deq)*bn``: the same scheme, another f32 rounding."""
    c, k = x.shape[-1], w_q.shape[-1]
    x_q = quantize_act(x, x_scale)
    if lane_ok(c, k):
        kw = dict(x_scale=x_scale, w_scale=w_scale, stride=stride,
                  padding=padding, bias=bias, scale=scale, shift=shift,
                  residual=residual, relu=relu)
        if be.get_conv_tiling() == "whole":
            blk = whole_blocking(x.shape, w_q.shape, stride=stride,
                                 padding=padding, kind="q8",
                                 backend=x.device.type, autotune=autotune)
            return conv2d_q8_whole(x_q, w_q, rb_p=blk.rb_p, k_blk=blk.k_blk,
                                   **kw)
        plan = _plan("q8", x_q, w_q.shape, stride, padding, autotune) \
            if k3.route(x_q, w_q) == "ring" else None
        return conv2d_q8(x_q, w_q, plan=plan, **kw)
    deq = _deq(x_scale, w_scale)
    combined = deq if scale is None else deq * scale
    combined_shift = shift if scale is not None else \
        torch.zeros((k,), dtype=torch.float32, device=x.device)
    return ref.conv2d_fused(x_q.to(torch.float32), w_q.to(torch.float32),
                            stride=stride, padding=padding, bias=bias,
                            scale=combined, shift=combined_shift,
                            residual=residual, relu=relu)


def conv2d_bwd_data_via_fwd(do, w, *, stride, padding, input_hw, mode=None,
                            autotune=None):
    """dI by the §II-I duality: transform the weights, run the forward
    conv, each launch under kind "bwd".  The generic (stride > 1, R,S > 1)
    case follows ``mode`` / ``REPRO_BWD_DUALITY``: "phase" (default)
    launches stride² forward sub-convs over the undilated dO; "dilate" is
    the materialized A/B plan."""
    def dual_fwd(x, wt, st, pd):
        return conv2d_fwd(x, wt, stride=st, padding=pd, kind="bwd",
                          autotune=autotune)
    r, s = w.shape[0], w.shape[1]
    scenario, _ = duality.bwd_data_plan(r=r, s=s, stride=stride,
                                        padding=padding, input_hw=input_hw,
                                        mode=mode)
    if scenario == "phase":
        return duality.phase_bwd_data(do, w, stride=stride, padding=padding,
                                      input_hw=input_hw, conv_fn=dual_fwd)
    do2, wt, kw, post = duality.prepare_bwd_data(
        do, w, stride=stride, padding=padding, input_hw=input_hw, mode=mode)
    return post(dual_fwd(do2, wt, kw["stride"], kw["padding"]))


def conv2d_bwd_weights(x, do, *, stride, padding, filter_rs, autotune=None):
    """dW by the update-pass kernel K2 (§II-J; K10b under ``whole``, with
    the reference's b_p | P blocking) for lane-aligned (C, K),
    ``ref.conv2d_bwd_weights`` otherwise.  On K2's mma route the launch
    takes the "wu" plan under ``autotune`` (None: the knob)."""
    c, k = x.shape[-1], do.shape[-1]
    if not lane_ok(c, k):
        return ref.conv2d_bwd_weights(x, do, stride=stride, padding=padding,
                                      filter_rs=filter_rs)
    if be.get_conv_tiling() == "whole":
        r, s = filter_rs
        blk = whole_blocking(x.shape, (r, s, c, k), stride=stride,
                             padding=padding, kind="wu",
                             backend=x.device.type, autotune=autotune)
        return conv2d_wu_whole(x, do, stride=stride, padding=padding,
                               filter_rs=filter_rs, b_p=blk.rb_p,
                               k_blk=blk.k_blk)
    plan = _plan("wu", x, (*filter_rs, c, k), stride, padding, autotune) \
        if k2.route(x, do) == "mma" else None
    return conv2d_wu(x, do, stride=stride, padding=padding,
                     filter_rs=filter_rs, plan=plan)


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
