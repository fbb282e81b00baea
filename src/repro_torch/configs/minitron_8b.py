"""minitron-8b [dense] — pruned nemotron [arXiv:2407.14679; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8,
    d_ff=16384, vocab=256000,
)
REDUCED = CONFIG.scaled(n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512)
