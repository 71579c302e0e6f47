"""Carry the reference's parameters over to the port.

torch cannot reproduce ``jax.random`` streams, so parity runs build params
with the reference's ``GxM.init`` or ``init_lm`` and hand them across as
numpy.  A bf16 leaf arrives as numpy's ``ml_dtypes.bfloat16``, which torch
does not know; it crosses through a ``uint16`` view, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.backend import resolve_device


def to_tensor(leaf, device) -> torch.Tensor:
    """One array-like leaf as a fresh tensor on ``device``; bf16 (numpy's
    ``ml_dtypes.bfloat16``, named "bfloat16") bit for bit."""
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.copy(order="C").view(np.uint16))
        return bits.view(torch.bfloat16).to(device, copy=True)
    return torch.tensor(arr, device=device)


def params_from_jax(tree, device=None) -> dict:
    """The reference's params (nested dicts, leaves array-like: numpy or
    anything ``np.asarray`` takes) as the port's tensors on ``device``.
    Layouts and dtypes are copied as they are (RSCK weights, per-K vectors,
    the LM's stacked "layers" axis, f32 or bf16); every leaf is a fresh
    copy."""
    device = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {key: convert(v) for key, v in node.items()}
        return to_tensor(node, device)

    return convert(tree)


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def take_expert_share(tree, cfg, *, axis: int = 1) -> dict:
    """The reference's params ``tree`` with every MoE expert leaf
    (``w_gate``, ``w_up``, ``w_down`` of an MoE layer) cut along its expert
    ``axis`` to the experts ``cfg.moe.expert_share`` holds: axis 1 for an LM
    tree (leading "layers" axis, then E), axis 0 for one MoE layer's tree.
    Other leaves are passed through as they are; no leaf is copied."""
    e0, e1 = cfg.moe.held_experts()
    cut = (slice(None),) * axis + (slice(e0, e1),)

    def walk(node):
        if not isinstance(node, dict):
            return node
        moe_layer = "router" in node and all(k in node for k in EXPERT_LEAVES)
        return {key: v[cut] if moe_layer and key in EXPERT_LEAVES
                else walk(v) for key, v in node.items()}

    return walk(tree)


def params_to(tree, device) -> dict:
    """A params tree of the port (nested dicts of tensors) with every leaf
    copied to ``device``: the same params on the card and on the CPU."""
    if isinstance(tree, dict):
        return {key: params_to(v, device) for key, v in tree.items()}
    return tree.to(device, copy=True)
