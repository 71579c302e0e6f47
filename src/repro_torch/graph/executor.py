"""GxM executor, the port's counterpart of ``repro/graph/executor.py``.

Runs an ETG forward for inference serving: BN is folded from the running
statistics into each conv's fused epilogue, and every lane-aligned conv
goes through the direct-conv kernel K1 (``core.conv.conv2d_fwd``).  Params
are plain nested dicts of tensors keyed by task name, with the reference's
leaves and layouts (RSCK conv weights, per-K vectors, (C, K) fc weight), so
``convert.params_from_jax`` carries a reference tree over unchanged.

Training (BN batch statistics and the conv VJP through the duality and
weight-update kernels), depth-first chain fusion, int8 and calibration taps
come with later slices and raise here.
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from repro_torch.backend import resolve_device
from repro_torch.core.conv import conv2d_fwd
from repro_torch.graph.etg import ETG, build_etg


def _maxpool(x, window, stride, padding):
    """NHWC window max with -inf padding (``lax.reduce_window``'s)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding)
    return y.permute(0, 2, 3, 1).contiguous()


class GxM:
    """Graph execution model over an ETG, on one device."""

    def __init__(self, nl, *, device=None, fuse: bool = True,
                 num_classes: int = 1000):
        self.etg: ETG = build_etg(nl, fuse=fuse)
        self.device = resolve_device(device)
        self.num_classes = num_classes

    # -- parameter init -----------------------------------------------------
    def init(self, generator: torch.Generator | None = None):
        """Random params in the reference's distribution (He-normal conv
        weights, identity BN, LeCun-normal fc), f32; drawn on the CPU from
        ``generator`` (default: seed 0), then moved to ``self.device``."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        def normal(shape, std):
            return (torch.randn(shape, generator=generator)
                    * std).to(self.device)

        def const(k, value):
            return torch.full((k,), value, device=self.device)

        params = {}
        for t in self.etg.tasks:
            a = t.attrs
            if t.op == "conv":
                fan_in = a["c"] * a["r"] * a["s"]
                p = {"w": normal((a["r"], a["s"], a["c"], a["k"]),
                                 math.sqrt(2.0 / fan_in))}
                for kind, _ in t.fused:
                    if kind == "bn":
                        p.update(scale=const(a["k"], 1.0),
                                 shift=const(a["k"], 0.0),
                                 mean=const(a["k"], 0.0),
                                 var=const(a["k"], 1.0))
                    elif kind == "bias":
                        p["bias"] = const(a["k"], 0.0)
                params[t.name] = p
            elif t.op == "bn":  # unfused BN
                params[t.name] = {"scale": const(a["k"], 1.0),
                                  "shift": const(a["k"], 0.0),
                                  "mean": const(a["k"], 0.0),
                                  "var": const(a["k"], 1.0)}
            elif t.op == "fc":
                params[t.name] = {"w": normal((a["c"], a["k"]),
                                              math.sqrt(1.0 / a["c"])),
                                  "b": const(a["k"], 0.0)}
        return params

    # -- forward ------------------------------------------------------------
    def forward(self, params, x, *, train: bool = False, tap=None):
        """Inference forward: the running BN statistics fold into the conv
        epilogue (scale' = g/sqrt(var+eps), shift' = b - g*mean/sqrt(var+eps)),
        the paper's §II-G fused BN."""
        if train:
            raise NotImplementedError(
                "GxM.forward(train=True) arrives with the training slice "
                "(duality + weight-update kernel K2)")
        if tap is not None:
            raise NotImplementedError(
                "calibration taps arrive with the int8 slice")
        if self.etg.chains and os.environ.get("REPRO_CHAIN_FUSION") == "on":
            raise NotImplementedError(
                "REPRO_CHAIN_FUSION=on: depth-first chain fusion arrives "
                "with the streams-and-chains slice")
        tensors = {"input": x}

        def get(name):
            return tensors[name]

        def folded(p):
            inv = torch.rsqrt(p["var"] + 1e-5)
            return p["scale"] * inv, p["shift"] - p["scale"] * p["mean"] * inv

        for t in self.etg.tasks:
            a = t.attrs
            if t.op == "input":
                continue
            if t.op == "conv":
                p = params[t.name]
                if "w_q" in p:
                    raise NotImplementedError(
                        f"conv {t.name} holds int8 weights (w_q): the int8 "
                        f"path arrives with the int8 slice")
                scale = shift = bias = residual = None
                relu = False
                for kind, attrs in t.fused:
                    if kind == "bn":
                        scale, shift = folded(p)
                    elif kind == "bias":
                        bias = p["bias"]
                    elif kind == "relu":
                        relu = True
                    elif kind == "add":
                        residual = get(attrs["residual"])
                out = conv2d_fwd(get(t.inputs[0]), p["w"], stride=a["stride"],
                                 padding=a["padding"], bias=bias, scale=scale,
                                 shift=shift, residual=residual, relu=relu)
            elif t.op == "bn":
                p = params[t.name]
                out = (get(t.inputs[0]) - p["mean"]) \
                    * torch.rsqrt(p["var"] + 1e-5) * p["scale"] + p["shift"]
            elif t.op == "relu":
                out = torch.clamp_min(get(t.inputs[0]), 0)
            elif t.op == "add":
                out = get(t.inputs[0]) + get(t.inputs[1])
            elif t.op == "split":
                out = get(t.inputs[0])
            elif t.op == "concat":
                out = torch.cat([get(i) for i in t.inputs], dim=-1)
            elif t.op == "maxpool":
                out = _maxpool(get(t.inputs[0]), a["window"], a["stride"],
                               a["padding"])
            elif t.op == "avgpool":
                out = get(t.inputs[0]).mean(dim=(1, 2))
            elif t.op == "fc":
                p = params[t.name]
                out = get(t.inputs[0]) @ p["w"] + p["b"]
            else:
                raise ValueError(f"unknown op {t.op}")
            tensors[t.name] = out
            if "output_name" in a:
                tensors[a["output_name"]] = out
        return tensors[self.etg.tasks[-1].name]

    # -- inference serving entry ---------------------------------------------
    def infer(self, params, x):
        """Inference forward under ``torch.inference_mode``."""
        with torch.inference_mode():
            return self.forward(params, x)
