"""The dense decoder behind the reference's model interface.

Port of the JAX package's ``models/model.py`` for family ``"dense"``
(qwen2-1.5b, deepseek-coder-33b, minitron-4b, minitron-8b).  ``Model(cfg,
device)`` is an ``nn.Module`` whose parameters have the reference's
pytree names and shapes: every per-layer tensor is stacked along a
leading ``n_layers`` axis (``layers.attn.wq.w`` is ``(L, d, nh * hd)``),
as the reference stacks them for ``lax.scan``.  That keeps the AdamW
decay rule (``p.ndim >= 2``: stacked norm scales and biases decay, the
top-level ``final_norm`` does not), the checkpoint's leaf names and the
converter (``models/convert.py``) equal to the reference's.

* ``init(generator)``  -- fills the parameters from an explicit generator
* ``loss(batch)``      -- causal-LM loss (chunked vocab cross-entropy;
                          each layer recomputed in the backward)
* ``prefill(batch)``   -- last-position logits and the KV cache
* ``decode_step(cache, tokens, pos)`` -- one token for the whole batch
* ``init_cache(B, S)`` -- zeroed ``(L, B, S, nkv, hd)`` keys and values

The other families raise ``NotImplementedError``: ROADMAP.md §1 queues
them.  The reference's ``shard_ctx.constrain`` hints are the identity on
one device and are left out until the mesh slice.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.torch_engine import require_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

ACT_DTYPE = torch.bfloat16
"""Activation dtype, read at call time (tests set it to float32)."""

PORTED_FAMILIES = ("dense",)
_QUEUED = {
    "moe": "item 1 (moe_block, moe_ep.py)",
    "vlm": "item 1 (M-RoPE, vision patches)",
    "ssm": "item 2 (wkv6_chunked)",
    "hybrid": "item 3 (mamba2)",
    "audio": "item 4 (whisper)",
}


def require_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        where = _QUEUED.get(cfg.family, "no item")
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported yet: ROADMAP.md §1, "
            f"the LM substrate's queue, {where}; the port runs {PORTED_FAMILIES} only"
        )


def _params(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})


def _slice(tree, i: int) -> dict:
    """Layer ``i``'s slice of a nested dict of stacked parameters."""
    return {k: (_slice(v, i) if isinstance(v, (dict, nn.ModuleDict, nn.ParameterDict))
                else v[i]) for k, v in tree.items()}


class DecoderStack(nn.Module):
    """The ``n_layers`` decoder layers, each parameter stacked ``(L, ...)``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, hd, nh, nkv, f, n = (cfg.d_model, cfg.hd, cfg.nh_eff, cfg.n_kv, cfg.d_ff,
                                cfg.n_layers)

        def lin(d_in, d_out, bias=False):
            p = {"w": torch.empty((n, d_in, d_out), device=device)}
            if bias:
                p["b"] = torch.empty((n, d_out), device=device)
            return _params(p)

        self.ln1 = _params({"scale": torch.empty((n, d), device=device)})
        self.attn = nn.ModuleDict({
            "wq": lin(d, nh * hd, cfg.qkv_bias),
            "wk": lin(d, nkv * hd, cfg.qkv_bias),
            "wv": lin(d, nkv * hd, cfg.qkv_bias),
            "wo": lin(nh * hd, d),
        })
        self.ln2 = _params({"scale": torch.empty((n, d), device=device)})
        self.mlp = nn.ModuleDict({"wg": lin(d, f), "wu": lin(d, f), "wd": lin(f, d)})

    def layer(self, i: int) -> dict:
        return _slice({"ln1": self.ln1, "attn": self.attn, "ln2": self.ln2,
                       "mlp": self.mlp}, i)


def decoder_layer_train(p, x, cfg, cos, sin):
    h = L.attention_train(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg, cos, sin)
    x = x + h
    h2 = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.mlp_swiglu(p["mlp"], h2)


def decoder_layer_decode(p, x, cache, pos, cfg, cos, sin):
    h, cache = L.attention_decode(
        p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cache, pos, cfg, cos, sin
    )
    x = x + h
    h2 = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.mlp_swiglu(p["mlp"], h2), cache


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        require_family(cfg)
        device = require_device(device, "Model", 'device="cpu"')
        self.cfg = cfg
        d = cfg.d_model
        self.embed = nn.Parameter(torch.empty((cfg.vocab, d), device=device))
        self.final_norm = _params({"scale": torch.empty((d,), device=device)})
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty((d, cfg.vocab), device=device))
        self.layers = DecoderStack(cfg, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def params(self) -> dict[str, nn.Parameter]:
        """Parameters by dotted name (``layers.attn.wq.w``), in the order
        of the reference's pytree leaves (dict keys sorted at every level)."""
        return dict(sorted(self.named_parameters(), key=lambda kv: kv[0].split(".")))

    # ----------------------------------------------------------- init
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Fills every parameter from ``generator`` (on the model's device)
        with the reference's distributions: normal draws scaled by
        ``fan_in ** -0.5`` (the embedding and untied head by ``d ** -0.5``),
        norm scales one, biases zero.  Returns the model."""
        cfg, dev = self.cfg, self.device
        d, V = cfg.d_model, cfg.vocab
        self.embed.copy_(L.dense_init(generator, V, d, scale=d**-0.5, device=dev))
        if not cfg.tie_embeddings:
            self.lm_head.copy_(L.dense_init(generator, d, V, device=dev))
        self.final_norm["scale"].fill_(1.0)
        stack = self.layers
        for norm in (stack.ln1, stack.ln2):
            norm["scale"].fill_(1.0)
        for group in (stack.attn, stack.mlp):
            for p in group.values():
                n, d_in, d_out = p["w"].shape
                for k, t in L.init_linear(generator, d_in, d_out, "b" in p, (n,), dev).items():
                    p[k].copy_(t)
        return self

    # ----------------------------------------------------------- helpers
    def _lm_head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        # gathered in f32, then cast: the reference casts the table first,
        # the same values; its backward sums repeated tokens in bf16, this
        # one in f32
        return nn.functional.embedding(tokens.long(), self.embed).to(ACT_DTYPE)

    def _rope(self, B: int, S_len: int):
        pos = torch.arange(S_len, device=self.device)[None, :].expand(B, S_len)
        return L.rope_angles(pos, self.cfg.hd, self.cfg.rope_theta, self.cfg.mrope_sections)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = L.rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        return (x @ self._lm_head().to(x.dtype)).float()

    # ----------------------------------------------------------- train
    def loss(self, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy + 0.01 x the MoE auxiliary loss
        (zero for the dense family), f32."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        B, S_len = tokens.shape
        x = self._embed(tokens)
        cos, sin = self._rope(B, S_len)
        for i in range(cfg.n_layers):
            if torch.is_grad_enabled():
                x = checkpoint(self._train_layer, i, x, cos, sin, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = self._train_layer(i, x, cos, sin)
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
        nll = L.chunked_softmax_xent(x, self._lm_head(), labels)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return nll + 0.01 * aux

    def _train_layer(self, i, x, cos, sin):
        return decoder_layer_train(self.layers.layer(i), x, self.cfg, cos, sin)

    # ----------------------------------------------------------- serve
    def init_cache(self, B: int, S_len: int, dtype=None) -> dict[str, torch.Tensor]:
        """Zeroed keys and values ``(L, B, S_len, nkv, hd)`` in ``dtype``
        (``ACT_DTYPE`` when None)."""
        cfg = self.cfg
        shape = (cfg.n_layers, B, S_len, cfg.n_kv, cfg.hd)
        dtype = dtype or ACT_DTYPE
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor, pos):
        """tokens (B, 1); pos a scalar, the same for the whole batch.
        Writes slot ``pos`` of every layer's cache in place; returns (f32
        logits (B, 1, V), the cache)."""
        cfg = self.cfg
        B = tokens.shape[0]
        x = self._embed(tokens)
        pos_t = torch.as_tensor(pos, device=self.device)
        cos, sin = L.rope_angles(pos_t.reshape(1, 1).expand(B, 1), cfg.hd, cfg.rope_theta,
                                 cfg.mrope_sections)
        for i in range(cfg.n_layers):
            layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
            x, _ = decoder_layer_decode(self.layers.layer(i), x, layer_cache, pos_t, cfg,
                                        cos, sin)
        return self._head(x), cache

    @torch.no_grad()
    def prefill(self, batch: dict):
        """Forward over the prompt ``batch["tokens"]`` (B, S): f32 logits of
        the last position (B, 1, V) and the KV cache ``(L, B, S, nkv, hd)``."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S_len = tokens.shape
        x = self._embed(tokens)
        cos, sin = self._rope(B, S_len)
        ks, vs = [], []
        for i in range(cfg.n_layers):
            lp = self.layers.layer(i)
            hn = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
            q, k, v = L._qkv(lp["attn"], hn, cfg, cos, sin)
            o = L.flash_attention(q, k, v, causal=True)
            x = x + L.linear(lp["attn"]["wo"], o.reshape(B, S_len, -1))
            x = x + L.mlp_swiglu(lp["mlp"], L.rmsnorm(lp["ln2"], x, cfg.norm_eps))
            ks.append(k)
            vs.append(v)
        return self._head(x[:, -1:]), {"k": torch.stack(ks), "v": torch.stack(vs)}


def get_model(cfg: ModelConfig, device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (CUDA unless the caller asks for
    the CPU), parameters allocated and not yet initialised: call
    ``init(generator)`` or load a state."""
    return Model(cfg, device)
