"""internvl2-2b — InternViT (stub frontend: precomputed patch embeddings)
+ InternLM2-1.8b backbone.  [arXiv:2404.16821; hf]"""
from repro_torch.nn.config import ModelCfg

CONFIG = ModelCfg(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=92553,
    tie_embeddings=False, frontend="vision",
    block_pattern=(("attn", "dense"),),
    rope_theta=1e6,
)
