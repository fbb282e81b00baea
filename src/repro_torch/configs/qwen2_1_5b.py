"""qwen2-1.5b [dense] — GQA, QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv=2,
    d_ff=8960, vocab=151936, qkv_bias=True, tie_embeddings=True,
)
REDUCED = CONFIG.scaled(n_layers=2, d_model=96, n_heads=6, n_kv=2, d_ff=192, vocab=512)
