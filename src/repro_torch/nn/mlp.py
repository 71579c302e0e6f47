"""MLP blocks, the counterpart of ``repro/nn/mlp.py``: the SwiGLU MLP of
the dense LMs (:11-26) and RWKV's channel mix (:29-44), relu(xk w_k)² w_v
on the token-shifted mix xk.  Plain matmuls, as the reference leaves them
to XLA."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.common import dense_init


def init(generator, cfg, dtype, device=None):
    d, dff = cfg.d_model, cfg.d_ff
    return {name: dense_init(generator, shape, dtype=dtype, device=device)
            for name, shape in (("w_gate", (d, dff)), ("w_up", (d, dff)),
                                ("w_down", (dff, d)))}


def specs(cfg) -> dict:
    """The logical axes of ``init``'s leaves (``mlp.py:11-18``)."""
    return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")}


def apply(p, cfg, x):
    g = F.silu(x @ p["w_gate"])
    u = x @ p["w_up"]
    return (g * u) @ p["w_down"]


def init_rwkv_cm(generator, cfg, dtype, device=None):
    d, dff = cfg.d_model, cfg.d_ff
    return {"mu_k": torch.full((d,), 0.5, dtype=dtype, device=device),
            "w_k": dense_init(generator, (d, dff), dtype=dtype,
                              device=device),
            "w_v": dense_init(generator, (dff, d), dtype=dtype,
                              device=device)}


def rwkv_cm_specs(cfg) -> dict:
    """The logical axes of ``init_rwkv_cm``'s leaves (``mlp.py:29-36``)."""
    return {"mu_k": ("embed",), "w_k": ("embed", "mlp"),
            "w_v": ("mlp", "embed")}


def apply_rwkv_cm(p, cfg, x, x_prev):
    """RWKV channel mix.  x_prev is the token-shifted x (B,L,D)."""
    xk = x + p["mu_k"] * (x_prev - x)
    return torch.square(F.relu(xk @ p["w_k"])) @ p["w_v"]
