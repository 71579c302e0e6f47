"""Reduced precision (paper §II-K), the port's copy of
``repro/core/quantize.py``.

LM weights (``quantize_int8`` / ``dequantize``): matrices stored int8 with
per-output-channel scales (the max over every axis but the last), small
tensors as they are, dequantized to bf16 or f32 for the math;
``quantization_error`` reports each leaf's reconstruction error.  Their
callers in the reference are its dry-run tools and its reduced-precision
bench; ``quantized_specs`` mirrors a logical-axis spec tree
(``nn/transformer.param_specs``) onto the quantized structure.

CNN serving:
Per-conv activation scales are calibrated from warmup batches, weights are
stored int8 with per-K-channel scales, and K3 (``kernels.conv2d_q8``)
multiplies int8 by int8 into int32 and dequantizes in its f32 epilogue.
Every scale carries the reference's ``+ 1e-12`` guard, so an all-zero
tensor quantizes to zeros instead of dividing by zero.  Rounding is
``torch.round``: half to even, as ``jnp.round``.
"""
from __future__ import annotations

import math

import torch


def _is_leaf_dict(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


def _tree_map(fn, tree, *, is_leaf=lambda x: False):
    if isinstance(tree, dict) and not is_leaf(tree):
        return {key: _tree_map(fn, v, is_leaf=is_leaf)
                for key, v in tree.items()}
    return fn(tree)


def quantize_int8(params, *, min_size: int = 1024):
    """Per-output-channel symmetric int8 for matrices; a leaf of fewer than
    2 dims or ``min_size`` elements stays as it is.  Returns the tree with
    each quantized leaf a ``{"q": int8, "s": f32 (last dim,)}`` dict, its
    scale ``max|p|`` over every axis but the last, / 127 + 1e-12."""
    def leaf(p):
        if p.dim() < 2 or p.numel() < min_size:
            return p
        p32 = p.to(torch.float32)
        scale = p32.abs().amax(dim=tuple(range(p.dim() - 1))) / 127.0 \
            + 1e-12
        q = torch.clamp(torch.round(p32 / scale), -127, 127).to(torch.int8)
        return {"q": q, "s": scale.to(torch.float32)}
    return _tree_map(leaf, params)


def dequantize(qparams, dtype=torch.bfloat16):
    """``quantize_int8``'s tree back to dense leaves of ``dtype``: q x s in
    f32, cast; other leaves as they are."""
    def leaf(x):
        if _is_leaf_dict(x):
            return (x["q"].to(torch.float32) * x["s"]).to(dtype)
        return x
    return _tree_map(leaf, qparams, is_leaf=_is_leaf_dict)


def quantized_specs(param_specs, params_or_shapes, *,
                    min_size: int = 1024):
    """Mirror the logical-axis spec tree onto ``quantize_int8``'s structure
    (``repro/core/quantize.py:52-61``): a leaf it quantizes becomes
    {"q": its axes, "s": its last axis}, the rest keep their axes.
    ``params_or_shapes`` holds tensors or anything with a ``.shape``."""
    def leaf(spec, p):
        shape = tuple(p.shape)
        if len(shape) < 2 or math.prod(shape) < min_size:
            return spec
        return {"q": spec, "s": spec[-1:]}

    def walk(spec, p):
        if isinstance(spec, dict):
            return {key: walk(v, p[key]) for key, v in spec.items()}
        return leaf(spec, p)
    return walk(param_specs, params_or_shapes)


def quantization_error(params, dtype=torch.bfloat16):
    """Max relative reconstruction error per leaf, as Python floats:
    ``max|p - dequantize(quantize_int8(p))| / (max|p| + 1e-9)`` in f32."""
    deq = dequantize(quantize_int8(params), dtype)

    def walk(a, b):
        if isinstance(a, dict):
            return {key: walk(v, b[key]) for key, v in a.items()}
        a, b = a.to(torch.float32), b.to(torch.float32)
        return float((a - b).abs().max() / (a.abs().max() + 1e-9))
    return walk(params, deq)


def quantize_act(x, scale):
    """Symmetric int8 activation quantization against a calibrated scale:
    round half to even, clip to ±127 (values beyond the calibration range
    saturate instead of wrapping)."""
    return torch.clamp(torch.round(x.to(torch.float32) / scale),
                       -127, 127).to(torch.int8)


@torch.no_grad()
def calibrate_network(gxm, params, batches) -> dict:
    """Per-conv activation scales from warmup batches.

    Runs the f32 inference forward with a tap on every conv input, keeps
    the absolute max per conv task across ``batches`` (arrays or tensors,
    (n, H, W, 3)), and returns ``{task_name: scale}`` with ``scale =
    absmax/127 + 1e-12`` as 0-d f32 tensors on the model's device."""
    absmax: dict = {}

    def tap(name, v):
        m = v.to(torch.float32).abs().max()
        prev = absmax.get(name)
        absmax[name] = m if prev is None else torch.maximum(prev, m)

    for b in batches:
        x = torch.as_tensor(b, dtype=torch.float32, device=gxm.device)
        gxm.forward(params, x.contiguous(), train=False, tap=tap)
    return {name: (m / 127.0 + 1e-12).to(torch.float32)
            for name, m in absmax.items()}


def quantize_gxm_params(etg, params, act_scales) -> dict:
    """Quantize the conv weights of a GxM params tree for the q8 path.

    For every conv task the ETG marked ``kernel_kind == "q8"`` that has a
    calibrated scale: replace ``w`` by int8 ``w_q`` and the per-K-channel
    ``w_scale`` (``max|w|`` over (R,S,C) / 127 + 1e-12), and attach the
    activation scale as a 0-d f32 ``x_scale``.  BN and bias leaves stay f32
    (they fold into the f32 epilogue after dequantization); other tasks
    are left as they are.  Returns a new tree; ``params`` is not changed."""
    out = {name: dict(p) for name, p in params.items()}
    for t in etg.tasks:
        if t.op != "conv" or t.attrs.get("kernel_kind") != "q8":
            continue
        if t.name not in act_scales:
            continue
        p = out[t.name]
        w = p.pop("w").to(torch.float32)
        w_scale = w.abs().amax(dim=(0, 1, 2)) / 127.0 + 1e-12
        p["w_q"] = torch.clamp(torch.round(w / w_scale), -127, 127) \
            .to(torch.int8)
        p["w_scale"] = w_scale.to(torch.float32)
        p["x_scale"] = torch.as_tensor(act_scales[t.name],
                                       dtype=torch.float32,
                                       device=w.device).reshape(())
    return out
