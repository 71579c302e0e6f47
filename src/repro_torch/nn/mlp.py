"""The SwiGLU MLP of the dense LMs, the counterpart of ``repro/nn/mlp.py``
(:11-26): plain matmuls, as the reference leaves them to XLA.  The RWKV
channel mix waits for the RWKV slice."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.nn.common import dense_init


def init(generator, cfg, dtype, device=None):
    d, dff = cfg.d_model, cfg.d_ff
    return {name: dense_init(generator, shape, dtype=dtype, device=device)
            for name, shape in (("w_gate", (d, dff)), ("w_up", (d, dff)),
                                ("w_down", (dff, d)))}


def apply(p, cfg, x):
    g = F.silu(x @ p["w_gate"])
    u = x @ p["w_up"]
    return (g * u) @ p["w_down"]
