"""Depth-first chain replay, the port's counterpart of
``repro/kernels/conv2d_chain.py`` (the reference's DESIGN.md §16).

Runs a single-consumer conv->conv chain band by band: layer l+1's output
band is computed from layer l's output band, which is never assembled
into the full intermediate activation.  The step order, each step's
output rows and the FLAG_HANDOFF discipline come from
``core.streams.build_chain_schedule``; this module is the replay half.
It is plain PyTorch over the conv kernels, as the reference's is plain
JAX over its Pallas kernel: a band is a fresh padded copy of its input
rows (layer 0's from the chain input, later layers' from the hand-off
band), and each step launches K1, K10a (``REPRO_CONV_TILING=whole``) or
``ref.conv2d_fused`` (C or K off the lane rule) by the dispatch of
``core.conv.conv2d_fwd``, with padding 0.  Between two steps the hand-off
band lives in device memory (on the card, mostly in L2), not in a CTA's
shared memory: a kernel that keeps it there is the port's own speed work.

Bit-exactness contract: fused and unfused agree bit for bit.  Each band
takes what its layer's full launch takes, so each output element is
summed in the same order:

* K1: the full layer's ``MmaPlan`` (``tune.resolve_plan`` for the full
  shape under the autotune mode), whose tile, splits and chunk the band
  re-makes for its own pixels (``make_mma_plan``): ``mma_plan`` on the
  band's pixel count could pick another split of the reduction.  Band
  shapes never enter the plan memo or the tune cache.  Each band input is
  a fresh contiguous tensor, so ``route`` sends it where the full launch
  goes.
* K10a: the full layer's whole-plane blocking (``core.conv.
  whole_blocking``); the band's row cut across CTAs (``whole_split``)
  moves rows between CTAs, not terms between sums.
* ``ref.conv2d_fused``: the same function on the band.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import backend as be
from repro_torch import tune
from repro_torch.core.conv import lane_ok, whole_blocking
from repro_torch.core.streams import FLAG_HANDOFF, build_chain_schedule
from repro_torch.kernels import conv2d_direct as k1
from repro_torch.kernels import ref


def _layer_launch(L, shape, *, device_type, autotune):
    """How every band of one chain layer launches, fixed from the layer's
    full input ``shape`` (N, H, W, C): ("ref", None), ("whole", its
    ``ConvBlocking``) or ("k1", its full-shape ``MmaPlan``)."""
    w = L["w"]
    r, s, c, k = w.shape
    if not lane_ok(c, k):
        return "ref", None
    if be.get_conv_tiling() == "whole":
        return "whole", whole_blocking(shape, w.shape, stride=L["stride"],
                                       padding=L["padding"], kind="fwd",
                                       backend=device_type,
                                       autotune=autotune)
    n, h, wd, _ = shape
    return "k1", tune.resolve_plan("fwd", n=n, h=h, w=wd, c=c, k=k, r=r, s=s,
                                   stride=L["stride"], padding=L["padding"],
                                   backend=device_type, autotune=autotune)


def _band_conv(xb, L, launch, residual):
    """One band micro-conv on the padded band ``xb`` (padding 0)."""
    path, how = launch
    w = L["w"]
    kw = dict(stride=L["stride"], padding=0, bias=L.get("bias"),
              scale=L.get("scale"), shift=L.get("shift"), residual=residual,
              relu=L.get("relu", False))
    if path == "ref":
        return ref.conv2d_fused(xb, w, **kw)
    if path == "whole":
        return k1.conv2d_direct_whole(xb, w, rb_p=how.rb_p, k_blk=how.k_blk,
                                      **kw)
    plan = None
    if k1.route(xb, w) == "mma":
        n, h, wd, _ = xb.shape
        r, s, _, k = w.shape
        plan = k1.make_mma_plan(n=n, p=(h - r) // L["stride"] + 1,
                                q=(wd - s) // L["stride"] + 1, k=k,
                                tile=how.tile, splits=how.splits,
                                chunk=how.chunk)
    return k1.conv2d_direct(xb, w, plan=plan, **kw)


def conv2d_chain(x, layers, *, rb: int, autotune=None):
    """Run a conv chain depth-first.  x: (N,H,W,C) chain input; ``layers``:
    one dict per conv, producers first, with ``w`` (R,S,C,K), ``stride``,
    ``padding`` and the fused epilogue's ``bias``, ``scale``, ``shift``,
    ``residual`` (the final layer's full (N,P,Q,K) residual) and ``relu``.
    ``rb`` is the final layer's output rows per band
    (``core.blocking.chain_blocking`` picks it); ``autotune`` (None: the
    knob) is the mode of the full-shape plans.  Returns the final layer's
    (N,P,Q,K) output, equal bit for bit to the layer-by-layer run."""
    n, h, wd, _ = x.shape
    rs = [(L["w"].shape[0], L["stride"], L["padding"]) for L in layers]
    sched = build_chain_schedule(rs=rs, h_in=h, rb=rb)

    launches, h_ins = [], []
    h_cur, w_cur, c_cur = h, wd, x.shape[3]
    for L in layers:
        r, s, _, k = L["w"].shape
        launches.append(_layer_launch(L, (n, h_cur, w_cur, c_cur),
                                      device_type=x.device.type,
                                      autotune=autotune))
        h_ins.append(h_cur)
        h_cur = (h_cur + 2 * L["padding"] - r) // L["stride"] + 1
        w_cur = (w_cur + 2 * L["padding"] - s) // L["stride"] + 1
        c_cur = k

    live = {}           # layer -> (o0, band) awaiting hand-off
    out_bands = []
    for i in range(len(sched)):
        l = int(sched.layer_ids[i])
        o0, o1 = int(sched.o0[i]), int(sched.o1[i])
        r, stride, pad = rs[l]
        # input rows of out rows [o0, o1), in padded coordinates, clipped
        a, b = o0 * stride, (o1 - 1) * stride + r
        i0, i1 = max(a - pad, 0), min(b - pad, h_ins[l])
        pt, pb = i0 + pad - a, b - pad - i1
        if l == 0:
            src = x[:, i0:i1]
        else:
            po0, prev = live.pop(l - 1)
            src = prev[:, i0 - po0:i1 - po0]
        # F.pad lists the last dimension first: (C, W, H) for NHWC; its
        # result is a fresh contiguous tensor even with no padding
        xb = F.pad(src, (0, 0, pad, pad, pt, pb))
        resid = layers[l].get("residual")
        yb = _band_conv(xb, layers[l], launches[l],
                        None if resid is None
                        else resid[:, o0:o1].contiguous())
        if sched.flags[i] & FLAG_HANDOFF:
            live[l] = (o0, yb)
        else:
            out_bands.append(yb)
    return out_bands[0] if len(out_bands) == 1 else torch.cat(out_bands, 1)
