"""smollm-360m — llama-arch small, GQA (kv=5).  [hf:HuggingFaceTB/SmolLM; hf]"""
from repro_torch.nn.config import ModelCfg

CONFIG = ModelCfg(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_head=64,
    d_ff=2560, vocab=49152,
    tie_embeddings=True,
    block_pattern=(("attn", "dense"),),
    rope_theta=1e4,
)
