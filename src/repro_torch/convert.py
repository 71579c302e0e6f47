"""Carry the reference's parameters over to the port.

torch cannot reproduce ``jax.random`` streams, so parity runs build params
with the reference's ``GxM.init`` and hand them across as numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.backend import resolve_device


def params_from_jax(tree, device=None) -> dict:
    """The reference's params (nested dicts keyed by task name, leaves
    array-like: numpy or anything ``np.asarray`` takes) as the port's
    tensors on ``device``.  Layouts are copied as they are (RSCK weights,
    per-K vectors, (C, K) fc weight); every leaf is a fresh copy."""
    device = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {key: convert(v) for key, v in node.items()}
        return torch.tensor(np.asarray(node), device=device)

    return convert(tree)
