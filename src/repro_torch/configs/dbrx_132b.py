"""dbrx-132b — MoE 16 experts top-4 (fine-grained), GQA (kv=8).
[hf:databricks/dbrx-base; unverified]"""
from repro_torch.nn.config import ModelCfg, MoECfg

CONFIG = ModelCfg(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=10752, vocab=100352,
    moe=MoECfg(n_experts=16, top_k=4),
    tie_embeddings=False, fsdp=True, factored_opt=True,
    block_pattern=(("attn", "moe"),),
    rope_theta=5e5,
    accum_steps=4,
)
