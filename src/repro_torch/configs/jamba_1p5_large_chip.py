"""jamba-1.5-large-398b-1chip — one chip's share of Jamba-1.5-Large.

Source: Jamba (arXiv:2403.19887) at the widths of the reference's
``repro/configs/jamba_1p5_large.py``: d_model 8192, d_inner 16384, d_state
16, d_conv 4, 64 query / 8 KV heads of 128, d_ff 24576, 16 experts top-2,
vocab 65536 untied; per 8-layer period attention at position 4 and Mamba
elsewhere, MoE on the odd positions.  Every width is the published one.

reduced:
  n_layers 72 -> 8: one period, every layer kind in its published ratio
    (7 Mamba + 1 attention, 4 dense + 4 MoE MLPs);
  experts held 16 -> 8 per MoE layer (``MoECfg.expert_share`` (0, 2));
    ``n_experts`` stays 16, so the router keeps its 16 outputs and top-2
    and the capacity is over all 16.

The deployment it stands for: each 8-layer period on its own pipeline
stage, and each MoE layer's 16 experts split over 2 chips by expert
parallelism (the reference's "ep" sharding profile), this chip holding
experts 0-7 and computing the part of each MoE layer's output that they
give.  Memory: 25.91 B parameters, 51.82 GB in bf16 (the whole period
with all 16 experts would be 45.24 B, 90.5 GB, more than the card's
80 GB).

One departure of the reference from the published model, which the port
follows: Jamba's attention layers use no explicit positional encoding,
while the reference applies RoPE (theta 1e6) in them.
"""
import dataclasses

from repro_torch.configs import jamba_1p5_large

CONFIG = dataclasses.replace(
    jamba_1p5_large.CONFIG,
    name="jamba-1.5-large-398b-1chip",
    n_layers=8,
    moe=dataclasses.replace(jamba_1p5_large.CONFIG.moe, expert_share=(0, 2)),
)
