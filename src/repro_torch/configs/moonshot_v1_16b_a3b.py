"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv=16,
    d_ff=1408, vocab=163840,
    moe=MoEConfig(n_experts=64, top_k=6),
)
REDUCED = CONFIG.scaled(n_layers=2, d_model=128, n_heads=4, n_kv=4, d_ff=64,
                        vocab=512, moe=MoEConfig(n_experts=8, top_k=2))
