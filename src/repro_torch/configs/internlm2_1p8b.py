"""internlm2-1.8b — dense, GQA (kv=8).  [arXiv:2403.17297; hf]"""
from repro_torch.nn.config import ModelCfg

CONFIG = ModelCfg(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=92544,
    tie_embeddings=False,
    block_pattern=(("attn", "dense"),),
    rope_theta=1e6,
)
