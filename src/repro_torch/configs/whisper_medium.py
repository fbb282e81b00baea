"""whisper-medium [audio] — enc-dec, conv frontend stubbed [arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv=16,
    d_ff=4096, vocab=51865, enc_layers=24, n_audio_ctx=1500,
    rope_theta=10000.0,
)
REDUCED = CONFIG.scaled(n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv=4,
                        d_ff=128, vocab=512, n_audio_ctx=32)
