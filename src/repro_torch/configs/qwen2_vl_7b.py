"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution (stub patch embeddings)
[arXiv:2409.12191; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv=4,
    d_ff=18944, vocab=152064, qkv_bias=True,
    vision_patches=256, mrope_sections=(16, 24, 24),
)
REDUCED = CONFIG.scaled(n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256,
                        vocab=512, vision_patches=16, mrope_sections=(4, 6, 6))
