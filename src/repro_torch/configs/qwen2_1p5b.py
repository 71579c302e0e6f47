"""qwen2-1.5b — dense, GQA (kv=2), QKV bias.  [arXiv:2407.10671; hf]"""
from repro_torch.nn.config import ModelCfg

CONFIG = ModelCfg(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_head=128,
    d_ff=8960, vocab=151936,
    qkv_bias=True, tie_embeddings=True,
    block_pattern=(("attn", "dense"),),
    rope_theta=1e6,
)
