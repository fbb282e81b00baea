"""Model configurations for the ten assigned architectures."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    conv_kernel: int = 4
    chunk: int = 128
    n_heads: int = 0        # ssm heads (mamba2) — 0 = derive d_model//64
    expand: int = 2


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str          # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # zamba2: one shared attention block applied every `shared_period` layers
    shared_period: int = 0
    # whisper: encoder stack + audio context (stub frontend embeddings)
    enc_layers: int = 0
    n_audio_ctx: int = 1500
    # qwen2-vl: number of stub vision patch embeddings prepended + M-RoPE
    vision_patches: int = 0
    mrope_sections: tuple[int, ...] = ()
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # perf knob: pad query-head count so it divides the TP axis (extra
    # heads have zero-init output rows — function-preserving at init)
    pad_heads_to: int | None = None

    @property
    def nh_eff(self) -> int:
        return self.pad_heads_to or self.n_heads

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid / linear attention)."""
        return self.family in ("ssm", "hybrid")

    def scaled(self, **overrides) -> "ModelConfig":
        from dataclasses import replace

        return replace(self, **overrides)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + layers), for 6ND roofline."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        mlp = 3 * d * f
        if self.family == "ssm":  # rwkv6: time-mix ~4 d^2 + channel-mix
            per_layer = 4 * d * d + 2 * d * f
        elif self.family == "hybrid":
            ssm = self.ssm or SSMConfig()
            inner = ssm.expand * d
            per_layer = 2 * d * inner + inner * d + inner * 2 * ssm.d_state
            # + amortized shared attention block
            if self.shared_period:
                per_layer += (attn + mlp) / self.shared_period
        elif self.moe:
            per_layer = attn + 3 * d * f * self.moe.n_experts + d * self.moe.n_experts
        else:
            per_layer = attn + mlp
        total = self.n_layers * per_layer
        if self.enc_layers:  # whisper: encoder stack + decoder cross-attn
            total += self.enc_layers * (attn + mlp) + self.n_layers * attn
        total += v * d * (1 if self.tie_embeddings else 2)
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_like = self.param_count() - self.n_layers * 3 * d * f * self.moe.n_experts
        return int(dense_like + self.n_layers * 3 * d * f * self.moe.top_k)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
