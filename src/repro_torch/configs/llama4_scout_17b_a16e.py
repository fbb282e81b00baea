"""llama4-scout-17b-a16e [moe] — 16 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8,
    d_ff=8192, vocab=202048,
    moe=MoEConfig(n_experts=16, top_k=1),
)
REDUCED = CONFIG.scaled(n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=128,
                        vocab=512, moe=MoEConfig(n_experts=4, top_k=1))
