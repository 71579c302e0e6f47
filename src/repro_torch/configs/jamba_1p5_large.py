"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave, MoE 16
experts top-2 every other layer.  [arXiv:2403.19887; hf]

Pattern (one repeat = 8 layers): attention at position 4, Mamba elsewhere;
MoE MLP on odd positions (every other layer), dense on even.
"""
from repro_torch.nn.config import ModelCfg, MoECfg


def _pattern():
    out = []
    for pos in range(8):
        mixer = "attn" if pos == 4 else "mamba"
        mlp = "moe" if pos % 2 == 1 else "dense"
        out.append((mixer, mlp))
    return tuple(out)


CONFIG = ModelCfg(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=24576, vocab=65536,
    moe=MoECfg(n_experts=16, top_k=2),
    tie_embeddings=False, fsdp=True, factored_opt=True,
    block_pattern=_pattern(),
    rope_theta=1e6,
    d_conv=4, d_state=16, expand=2,
    scan_chunk=64,
    sub_quadratic=True,
    accum_steps=8,     # 398B @ 1M-token batch on 256 chips: microbatch to fit
)
