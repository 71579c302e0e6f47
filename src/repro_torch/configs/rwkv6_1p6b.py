"""rwkv6-1.6b (Finch) — attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""
from repro_torch.nn.config import ModelCfg

CONFIG = ModelCfg(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=7168, vocab=65536,
    tie_embeddings=False,
    block_pattern=(("rwkv", "rwkv_cm"),),
    sub_quadratic=True,
)
