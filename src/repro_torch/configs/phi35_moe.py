"""phi3.5-moe-42b-a6.6b — MoE 16 experts top-2, GQA (kv=8).
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.nn.config import ModelCfg, MoECfg

CONFIG = ModelCfg(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=6400, vocab=32064,
    moe=MoECfg(n_experts=16, top_k=2),
    tie_embeddings=False, fsdp=True,
    block_pattern=(("attn", "moe"),),
    rope_theta=1e4,
)
