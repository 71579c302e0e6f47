"""GxM executor, the port's counterpart of ``repro/graph/executor.py``.

Runs an ETG forward for training and for inference serving.  Params are
plain nested dicts of tensors keyed by task name, with the reference's
leaves and layouts (RSCK conv weights, per-K vectors, (C, K) fc weight), so
``convert.params_from_jax`` carries a reference tree over unchanged.

Training: every conv runs ``core.conv.conv2d_train``, whose backward is the
paper's pipeline (dI by duality through K1, dW through K2); BN uses batch
statistics and yields the running-statistics update.  Inference: BN is
folded from the running statistics into each conv's fused epilogue, and
every lane-aligned conv goes through K1 (``core.conv.conv2d_fwd``), or,
for a q8-marked task whose params hold int8 weights, through K3
(``core.conv.conv2d_q8_fwd``, §II-K).  ``forward(tap=)`` shows every conv
input to a callback: the calibration pass of ``core.quantize``.

Depth-first chain fusion (``REPRO_CHAIN_FUSION=on``,
``backend.get_chain_fusion``): an inference forward without a tap runs
each conv->conv chain of the ETG (``core.fusion.detect_chains``) band by
band through ``core.conv.conv2d_chain_fwd`` where
``tune.measure.chain_traffic`` fuses it, and layer by layer where it does
not, or where a layer holds int8 weights (``w_q``).  ``chains_fused`` and
``chains_unfused`` count the two.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.backend import get_chain_fusion, get_quantize, resolve_device
from repro_torch.core import blocking
from repro_torch.core.conv import (conv2d_chain_fwd, conv2d_fwd,
                                   conv2d_q8_fwd, conv2d_train)
from repro_torch.graph.etg import ETG, build_etg

# BN leaves that are running statistics: buffers, not trained by SGD.
RUNNING_STATS = ("mean", "var")
# Chains run band by band, and chains that fell back to layer by layer,
# since the last reset (set to 0 to reset).
chains_fused = 0
chains_unfused = 0
_CHAIN_GEO = ("h", "w", "c", "k", "r", "s", "stride", "padding",
              "dtype_bytes")


@functools.lru_cache(maxsize=1024)
def _chain_rb(shapes: tuple, minibatch: int, budget: int):
    """The final layer's rows per band of a chain of conv ``shapes`` (one
    ``_CHAIN_GEO`` tuple a layer), or None to run it layer by layer:
    ``tune.measure.chain_traffic``'s decision at ``budget``.  A pure
    function of its arguments, so it is kept, as the reference's decision
    is fixed once per traced shape."""
    from repro_torch.tune.measure import chain_traffic
    t = chain_traffic([dict(zip(_CHAIN_GEO, sh)) for sh in shapes],
                      minibatch=minibatch, vmem_budget=budget)
    return t["rb"] if t["fused"] else None


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
                 num_classes: int = 1000, quantized: bool | None = None):
        if quantized is None:
            quantized = get_quantize() == "int8"
        self.etg: ETG = build_etg(nl, fuse=fuse, quantized=quantized)
        self.device = resolve_device(device)
        self.num_classes = num_classes
        self.quantized = quantized

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

    # -- depth-first chains (the reference's DESIGN.md §16) -----------------
    def _task(self, name):
        by_name = getattr(self, "_task_by_name", None)
        if by_name is None:
            by_name = self._task_by_name = {t.name: t for t in self.etg.tasks}
        return by_name[name]

    def _plan_chain(self, ch, params, x):
        """Fuse or not, decided once per chain at its entry task, where
        the input's plane is known: the band plan ``{"rb": rows}``, or None
        to run the chain layer by layer.  A chain with an int8 layer stays
        unfused (K3 has its own banding), as does one whose band does not
        fit the chain budget or whose fused bytes exceed the unfused sum
        (``tune.measure.chain_traffic`` at ``core.blocking.CHAIN_BUDGET``,
        read now)."""
        if any("w_q" in params[name] for name in ch.names):
            return None
        h, w = int(x.shape[1]), int(x.shape[2])
        shapes = []
        for name in ch.names:
            a = self._task(name).attrs
            shapes.append((h, w, a["c"], a["k"], a["r"], a["s"], a["stride"],
                           a["padding"], x.dtype.itemsize))
            h = (h + 2 * a["padding"] - a["r"]) // a["stride"] + 1
            w = (w + 2 * a["padding"] - a["s"]) // a["stride"] + 1
        rb = _chain_rb(tuple(shapes), int(x.shape[0]), blocking.CHAIN_BUDGET)
        return None if rb is None else {"rb": rb}

    def _chain_layer(self, name, params, get, folded):
        """One chain layer's weights and epilogue: the BN fold, bias,
        residual and relu the unfused inference branch passes to
        ``conv2d_fwd``."""
        t = self._task(name)
        p = params[name]
        layer = dict(w=p["w"], stride=t.attrs["stride"],
                     padding=t.attrs["padding"])
        for kind, attrs in t.fused:
            if kind == "bn":
                layer["scale"], layer["shift"] = folded(p)
            elif kind == "bias":
                layer["bias"] = p["bias"]
            elif kind == "relu":
                layer["relu"] = True
            elif kind == "add":
                layer["residual"] = get(attrs["residual"])
        return layer

    # -- forward ------------------------------------------------------------
    def forward(self, params, x, *, train: bool = True,
                collect_stats: bool = False, tap=None):
        """Training (the default, as in the reference) normalises with batch
        statistics and, with ``collect_stats``, also returns them as
        ``{task: (mean, var)}`` for the running update.  Inference folds
        the *running* BN statistics into the conv epilogue (scale' =
        g/sqrt(var+eps), shift' = b - g*mean/sqrt(var+eps)), the paper's
        §II-G fused BN.  ``tap(name, x)``, if given, sees the input of
        every conv task (the calibration pass of ``core.quantize``).  A
        q8-marked conv whose params hold ``w_q`` runs the int8 path, one
        with f32 params the f32 path.  Under ``REPRO_CHAIN_FUSION=on`` an
        inference forward without a tap runs the ETG's chains depth-first
        (the module docstring); training and tapped forwards never do."""
        global chains_fused, chains_unfused
        tensors = {"input": x}
        stats = {}

        def get(name):
            return tensors[name]

        def folded(p):
            # 1/sqrt, both correctly rounded, not rsqrt: CUDA's rsqrt is
            # approximate, so the card would fold BN to other bits than the
            # CPU, and on the int8 path each such bit can move a quantized
            # activation a step
            inv = 1.0 / torch.sqrt(p["var"] + 1e-5)
            return p["scale"] * inv, p["shift"] - p["scale"] * p["mean"] * inv

        chain_of, chain_plans = {}, {}
        if (not train and tap is None and self.etg.chains
                and get_chain_fusion() == "on"):
            for ch in self.etg.chains:
                for pos, name in enumerate(ch.names):
                    chain_of[name] = (ch, pos)

        for t in self.etg.tasks:
            a = t.attrs
            if t.op == "input":
                continue
            if t.name in chain_of:
                ch, pos = chain_of[t.name]
                if pos == 0:
                    plan = chain_plans[ch.names] = self._plan_chain(
                        ch, params, get(t.inputs[0]))
                    if plan is None:
                        chains_unfused += 1
                plan = chain_plans[ch.names]
                if plan is not None:
                    if pos < len(ch.names) - 1:
                        continue        # its band is handed on in the chain
                    out = conv2d_chain_fwd(
                        get(self._task(ch.names[0]).inputs[0]),
                        [self._chain_layer(name, params, get, folded)
                         for name in ch.names], rb=plan["rb"])
                    chains_fused += 1
                    tensors[t.name] = out
                    if "output_name" in a:
                        tensors[a["output_name"]] = out
                    continue
            if t.op == "conv":
                inp = get(t.inputs[0])
                if tap is not None:
                    tap(t.name, inp)
                p = params[t.name]
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
                    if "w_q" in p:
                        raise ValueError(
                            f"conv {t.name} holds quantized weights (w_q); "
                            f"the q8 path is inference-only: train with "
                            f"the f32 params tree")
                    # the conv runs bare; BN with batch statistics, bias,
                    # residual and relu follow as separate passes
                    out = conv2d_train(inp, p["w"], a["stride"],
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
                    kw = dict(stride=a["stride"], padding=a["padding"],
                              bias=bias, scale=scale, shift=shift,
                              residual=residual, relu=relu)
                    if a.get("kernel_kind") == "q8" and "w_q" in p:
                        # §II-K: int8 kernel, f32 epilogue.  A q8-marked
                        # task with f32 params (no w_q) takes K1: the
                        # calibration pass.
                        out = conv2d_q8_fwd(inp, p["w_q"],
                                            x_scale=p["x_scale"],
                                            w_scale=p["w_scale"], **kw)
                    else:
                        out = conv2d_fwd(inp, p["w"], **kw)
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
        """One SGD step: ``(new_params, loss)``, ``local_grads`` then
        ``apply_sgd``.  Not in place: ``params`` is left as it was and the
        new tree holds new tensors."""
        loss, stats, grads = self.local_grads(params, batch)
        return self.apply_sgd(params, grads, stats, lr,
                              bn_momentum=bn_momentum), loss

    def local_grads(self, params, batch):
        """``(loss, stats, grads)`` of ``batch``: the detached loss, the BN
        batch statistics ``loss(..., collect_stats=True)`` collects and the
        gradient tree by autograd, which has every leaf of ``params``
        (zeros for the running statistics, which SGD does not train).  The
        data-parallel step reduces these between this and ``apply_sgd``."""
        leaves = {name: {leaf: v.detach().requires_grad_(
                             leaf not in RUNNING_STATS)
                         for leaf, v in p.items()}
                  for name, p in params.items()}
        trained = [(name, leaf) for name, p in leaves.items()
                   for leaf, v in p.items() if v.requires_grad]
        with torch.enable_grad():
            loss, stats = self.loss(leaves, batch, collect_stats=True)
            grads = torch.autograd.grad(
                loss, [leaves[name][leaf] for name, leaf in trained])
        got = dict(zip(trained, grads))
        tree = {name: {leaf: got[name, leaf] if (name, leaf) in got
                       else torch.zeros_like(v) for leaf, v in p.items()}
                for name, p in params.items()}
        return loss.detach(), {k: (a.detach(), b.detach())
                               for k, (a, b) in stats.items()}, tree

    @torch.no_grad()
    def apply_sgd(self, params, grads, stats, lr, *, bn_momentum=0.9):
        """The new params tree: ``p - lr * grad`` for every leaf but the
        running statistics, which take ``stats`` (``apply_bn_updates``)."""
        new = {name: {leaf: v.detach() if leaf in RUNNING_STATS
                      else v.detach() - lr * grads[name][leaf]
                      for leaf, v in p.items()}
               for name, p in params.items()}
        return apply_bn_updates(new, stats, bn_momentum)
