"""jamba-1.5-large-398b-train-1chip — a training cut of Jamba-1.5-Large
that fits one card.

Source: Jamba (arXiv:2403.19887) at the widths of the reference's
``repro/configs/jamba_1p5_large.py``: d_model 8192, d_inner 16384, d_state
16, d_conv 4, 64 query / 8 KV heads of 128, d_ff 24576, 16 experts top-2,
vocab 65536 untied, bf16, remat, the factored optimizer.  Every width is
the published one.

reduced:
  n_layers 72 -> 2, with the block pattern (("mamba", "moe"),
    ("attn", "dense")): the shortest period that keeps every layer kind
    (a Mamba and an attention mixer, an MoE and a dense MLP); the published
    7:1 Mamba-to-attention ratio is not kept;
  experts held 16 -> 4 per MoE layer (``MoECfg.expert_share`` (0, 4));
    ``n_experts`` stays 16, so the router keeps its 16 outputs and top-2,
    and the capacity and the aux losses are over all 16;
  the training batch: 2 sequences of 512 tokens (``launch/train``'s
    ``--global-batch 2 --seq-len 512``).

The deployment it stands for: one pipeline stage of two layers, each MoE
layer's experts split over 4 devices by expert parallelism (the
reference's "ep" sharding profile), this one holding experts 0-3.

Memory on one 80 GB card:
  parameters: 2.233 B outside the experts (the embedding and head 1.074 B,
    the Mamba mixer 0.403 B, the attention mixer 0.151 B, the dense MLP
    0.604 B) and 4 held experts of 0.604 B, 4.65 B in all, 9.3 GB in bf16;
    their gradients another 9.3 GB and AdamW's bf16 ``m`` 9.3 GB; the
    factored ``v`` is a row and a column a matrix;
  the largest leaf, the held ``w_gate`` (4, 8192, 24576), holds 0.81 B
    elements: each f32 temporary of ``AdamW.update`` on it is 3.2 GB;
  under remat the Mamba layer's recompute records the doubling scan's graph:
    8 chunks of 64 tokens, about 15 tensors of (2, 64, 16384, 16) f32 a
    chunk at 134 MB each, about 16 GB;
  so about 50 GB at the peak; ``chip_smoke.py`` prints the measured peak
  and fails above 72 GB.  The uncut period of ``jamba-1.5-large-398b-1chip``
  (25.9 B parameters held, 51.8 GB in bf16) cannot train here: its bf16
  gradients alone would take the total to 103.6 GB.

One departure of the reference from the published model, which the port
follows: Jamba's attention layers use no explicit positional encoding,
while the reference applies RoPE (theta 1e6) in them.
"""
import dataclasses

from repro_torch.configs import jamba_1p5_large

CONFIG = dataclasses.replace(
    jamba_1p5_large.CONFIG,
    name="jamba-1.5-large-398b-train-1chip",
    n_layers=2,
    block_pattern=(("mamba", "moe"), ("attn", "dense")),
    moe=dataclasses.replace(jamba_1p5_large.CONFIG.moe, expert_share=(0, 4)),
)
