"""rwkv6-3b [ssm] — Finch, data-dependent decay [arXiv:2404.05892; hf]."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv=40,
    d_ff=8960, vocab=65536, head_dim=64,
    ssm=SSMConfig(chunk=16)  # chunk*|w_clamp| < 88 keeps exp() finite in f32,
)
REDUCED = CONFIG.scaled(n_layers=2, d_model=128, n_heads=2, n_kv=2, d_ff=256,
                        vocab=512, head_dim=64)
