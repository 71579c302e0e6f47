"""GxM executor, the port's counterpart of ``repro/graph/executor.py``.

Runs an ETG forward for training and for inference serving.  Params are
plain nested dicts of tensors keyed by task name, with the reference's
leaves and layouts (RSCK conv weights, per-K vectors, (C, K) fc weight), so
``convert.params_from_jax`` carries a reference tree over unchanged.

Training: every conv runs ``core.conv.conv2d_train``, whose backward is the
paper's pipeline (dI by duality through K1, dW through K2); BN uses batch
statistics and yields the running-statistics update.  Inference: BN is
folded from the running statistics into each conv's fused epilogue, and
every lane-aligned conv goes through K1 (``core.conv.conv2d_fwd``).

Depth-first chain fusion, int8 and calibration taps come with later slices
and raise here.
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from repro_torch.backend import resolve_device
from repro_torch.core.conv import conv2d_fwd, conv2d_train
from repro_torch.graph.etg import ETG, build_etg

# BN leaves that are running statistics: buffers, not trained by SGD.
RUNNING_STATS = ("mean", "var")


@torch.no_grad()
def apply_bn_updates(params, stats, bn_momentum):
    """Fold freshly collected batch statistics into the running BN stats,
    in place on a params tree the caller owns (the post-SGD tree): each
    ``mean``/``var`` entry is replaced by a new tensor, outside autograd."""
    for name, (mu, var) in stats.items():
        params[name]["mean"] = bn_momentum * params[name]["mean"] \
            + (1 - bn_momentum) * mu
        params[name]["var"] = bn_momentum * params[name]["var"] \
            + (1 - bn_momentum) * var
    return params


def _batch_stats(y):
    """Per-channel mean and population variance (``jnp.var``'s, not
    ``torch.var``'s unbiased default) over N, H, W."""
    return y.mean(dim=(0, 1, 2)), y.var(dim=(0, 1, 2), correction=0)


def _relu(x):
    return torch.clamp_min(x, 0)


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
    def forward(self, params, x, *, train: bool = True,
                collect_stats: bool = False, tap=None):
        """Training (the default, as in the reference) normalises with batch
        statistics and, with ``collect_stats``, also returns them as
        ``{task: (mean, var)}`` for the running update.  Inference folds
        the *running* BN statistics into the conv epilogue (scale' =
        g/sqrt(var+eps), shift' = b - g*mean/sqrt(var+eps)), the paper's
        §II-G fused BN."""
        if tap is not None:
            raise NotImplementedError(
                "calibration taps arrive with the int8 slice")
        if (not train and self.etg.chains
                and os.environ.get("REPRO_CHAIN_FUSION") == "on"):
            raise NotImplementedError(
                "REPRO_CHAIN_FUSION=on: depth-first chain fusion arrives "
                "with the streams-and-chains slice")
        tensors = {"input": x}
        stats = {}

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
                bn = bias = residual = None
                relu = False
                for kind, attrs in t.fused:
                    if kind == "bn":
                        bn = p
                    elif kind == "bias":
                        bias = p["bias"]
                    elif kind == "relu":
                        relu = True
                    elif kind == "add":
                        residual = get(attrs["residual"])
                if train:
                    # the conv runs bare; BN with batch statistics, bias,
                    # residual and relu follow as separate passes
                    out = conv2d_train(get(t.inputs[0]), p["w"], a["stride"],
                                       a["padding"])
                    if bn is not None:
                        mu, var = stats[t.name] = _batch_stats(out)
                        out = (out - mu) * torch.rsqrt(var + 1e-5)
                        out = out * bn["scale"] + bn["shift"]
                    if bias is not None:
                        out = out + bias
                    if residual is not None:
                        out = out + residual
                    if relu:
                        out = _relu(out)
                else:
                    scale, shift = folded(bn) if bn is not None \
                        else (None, None)
                    out = conv2d_fwd(get(t.inputs[0]), p["w"],
                                     stride=a["stride"], padding=a["padding"],
                                     bias=bias, scale=scale, shift=shift,
                                     residual=residual, relu=relu)
            elif t.op == "bn":
                p = params[t.name]
                y = get(t.inputs[0])
                if train:
                    mu, var = stats[t.name] = _batch_stats(y)
                else:
                    mu, var = p["mean"], p["var"]
                out = (y - mu) * torch.rsqrt(var + 1e-5) * p["scale"] \
                    + p["shift"]
            elif t.op == "relu":
                out = _relu(get(t.inputs[0]))
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
        result = tensors[self.etg.tasks[-1].name]
        if collect_stats:
            return result, stats
        return result

    # -- inference serving entry ---------------------------------------------
    def infer(self, params, x):
        """Inference forward under ``torch.inference_mode``."""
        with torch.inference_mode():
            return self.forward(params, x, train=False)

    # -- loss / steps ---------------------------------------------------------
    def loss(self, params, batch, *, train=True, collect_stats=False):
        """Mean softmax cross-entropy of ``batch`` ({"image", "label"}
        tensors on this model's device)."""
        out = self.forward(params, batch["image"], train=train,
                           collect_stats=collect_stats)
        logits, stats = out if collect_stats else (out, None)
        loss = F.cross_entropy(logits, batch["label"].long())
        if collect_stats:
            return loss, stats
        return loss

    def sgd_train_step(self, params, batch, lr=0.1, *, bn_momentum=0.9):
        """One SGD step: ``(new_params, loss)``.  Not in place: ``params`` is
        left as it was and the new tree holds new tensors.  Every leaf but
        the running statistics gets ``p - lr * grad``; the running
        statistics take the detached batch statistics
        (``apply_bn_updates``)."""
        leaves = {name: {leaf: v.detach().requires_grad_(
                             leaf not in RUNNING_STATS)
                         for leaf, v in p.items()}
                  for name, p in params.items()}
        trained = [(name, leaf) for name, p in leaves.items()
                   for leaf, v in p.items() if v.requires_grad]
        loss, stats = self.loss(leaves, batch, collect_stats=True)
        grads = torch.autograd.grad(
            loss, [leaves[name][leaf] for name, leaf in trained])
        new = {name: {leaf: v.detach() for leaf, v in p.items()}
               for name, p in leaves.items()}
        with torch.no_grad():
            for (name, leaf), g in zip(trained, grads):
                new[name][leaf] = new[name][leaf] - lr * g
        apply_bn_updates(new, stats, bn_momentum)
        return new, loss.detach()
