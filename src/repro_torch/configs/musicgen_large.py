"""musicgen-large — decoder-only over EnCodec tokens (audio frontend is a
stub: the backbone consumes codec token ids / frame embeddings).
[arXiv:2306.05284; hf]"""
from repro_torch.nn.config import ModelCfg

CONFIG = ModelCfg(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab=2048,
    tie_embeddings=False, frontend="audio",
    block_pattern=(("attn", "dense"),),
    rope_theta=1e4,
)
