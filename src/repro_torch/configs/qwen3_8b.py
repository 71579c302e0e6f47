"""qwen3-8b — dense, GQA (kv=8), qk-norm.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.nn.config import ModelCfg

CONFIG = ModelCfg(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=12288, vocab=151936,
    qk_norm=True, tie_embeddings=False, fsdp=True,
    block_pattern=(("attn", "dense"),),
    rope_theta=1e6,
)
