"""Architecture registry: ``--arch <id>`` -> ModelCfg, + reduced smoke
configs for CPU tests.  The port's copy of ``repro/configs/registry.py``:
the same ten configs, data only, and two of the port's own,
``jamba-1.5-large-398b-1chip`` (one chip's share of Jamba-1.5-Large, served)
and ``jamba-1.5-large-398b-train-1chip`` (a two-layer cut of it that trains
on one card)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (dbrx_132b, internlm2_1p8b, internvl2_2b,
                           jamba_1p5_large, jamba_1p5_large_chip,
                           jamba_1p5_large_train_chip, musicgen_large,
                           phi35_moe, qwen2_1p5b, qwen3_8b, rwkv6_1p6b,
                           smollm_360m)
from repro_torch.nn.config import ModelCfg, MoECfg

ARCHS: dict[str, ModelCfg] = {
    c.name: c for c in [
        qwen2_1p5b.CONFIG, qwen3_8b.CONFIG, internlm2_1p8b.CONFIG,
        smollm_360m.CONFIG, phi35_moe.CONFIG, dbrx_132b.CONFIG,
        musicgen_large.CONFIG, rwkv6_1p6b.CONFIG, internvl2_2b.CONFIG,
        jamba_1p5_large.CONFIG, jamba_1p5_large_chip.CONFIG,
        jamba_1p5_large_train_chip.CONFIG,
    ]
}


def list_archs():
    return sorted(ARCHS)


def get_config(name: str) -> ModelCfg:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    return ARCHS[name]


def smoke_config(cfg: ModelCfg) -> ModelCfg:
    """Reduced same-family config: tiny widths/depth, same structure/flags.
    Exercised by per-arch CPU smoke tests (one fwd + one train step)."""
    moe = MoECfg(n_experts=4, top_k=min(cfg.moe.top_k, 2)) if cfg.moe else None
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=len(cfg.block_pattern),
        d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=256,
        moe=moe,
        d_state=8, d_conv=4, expand=2,
        scan_chunk=8,
        dtype="float32", remat=False,
    )
