"""zamba2-2.7b [hybrid] — Mamba2 + shared attention [arXiv:2411.15242; hf]."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv=32,
    d_ff=10240, vocab=32000,
    ssm=SSMConfig(d_state=64, chunk=128), shared_period=6,
)
REDUCED = CONFIG.scaled(n_layers=6, d_model=128, n_heads=4, n_kv=4, d_ff=256,
                        vocab=512, shared_period=3, ssm=SSMConfig(d_state=16, chunk=32))
