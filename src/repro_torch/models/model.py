"""The decoder families behind the reference's model interface.

Port of the JAX package's ``models/model.py`` for families ``"dense"``
(qwen2-1.5b, deepseek-coder-33b, minitron-4b, minitron-8b), ``"moe"``
(llama4-scout-17b-a16e, moonshot-v1-16b-a3b: the dense decoder layer
with ``moe_block`` in place of the MLP) and ``"vlm"`` (qwen2-vl-7b: stub
vision patch embeddings prepended to the text, M-RoPE positions).
``Model(cfg, device)`` is an ``nn.Module`` whose parameters have the
reference's pytree names and shapes: every per-layer tensor is stacked
along a leading ``n_layers`` axis (``layers.attn.wq.w`` is ``(L, d, nh *
hd)``, ``layers.moe.wg`` is ``(L, E, d, f)``), as the reference stacks
them for ``lax.scan``.  That keeps the AdamW decay rule (``p.ndim >= 2``:
stacked norm scales and biases decay, the top-level ``final_norm`` does
not), the checkpoint's leaf names and the converter
(``models/convert.py``) equal to the reference's.

* ``init(generator)``  -- fills the parameters from an explicit generator
* ``loss(batch)``      -- causal-LM loss (chunked vocab cross-entropy;
                          each layer recomputed in the backward) + 0.01 x
                          the MoE auxiliary loss (kept as ``last_aux``)
* ``prefill(batch)``   -- last-position logits and the KV cache
* ``decode_step(cache, tokens, pos)`` -- one token for the whole batch
* ``init_cache(B, S)`` -- zeroed ``(L, B, S, nkv, hd)`` keys and values

The other families raise ``NotImplementedError``: ROADMAP.md §1 queues
them.  The reference's ``shard_ctx.constrain`` hints are the identity on
one device and are left out until the mesh slice, with its
expert-parallel ``moe_ep.py``.
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

PORTED_FAMILIES = ("dense", "moe", "vlm")
_QUEUED = {
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
        if cfg.moe:
            E = cfg.moe.n_experts
            self.moe = _params({"router": torch.empty((n, d, E), device=device),
                                "wg": torch.empty((n, E, d, f), device=device),
                                "wu": torch.empty((n, E, d, f), device=device),
                                "wd": torch.empty((n, E, f, d), device=device)})
        else:
            self.mlp = nn.ModuleDict({"wg": lin(d, f), "wu": lin(d, f), "wd": lin(f, d)})

    def layer(self, i: int) -> dict:
        ffn = {"moe": self.moe} if hasattr(self, "moe") else {"mlp": self.mlp}
        return _slice({"ln1": self.ln1, "attn": self.attn, "ln2": self.ln2, **ffn}, i)


def ffn(p, h: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The layer's feed-forward on ``h`` (B, S, d) and its f32 auxiliary
    loss: ``moe_block`` over the flattened ``(B * S, d)`` tokens, or
    SwiGLU and None."""
    if cfg.moe:
        B, S_len, d = h.shape
        y, aux = L.moe_block(p["moe"], h.reshape(B * S_len, d), cfg)
        return y.reshape(B, S_len, d), aux
    return L.mlp_swiglu(p["mlp"], h), None


def decoder_layer_train(p, x, cfg, cos, sin):
    """Returns (x, aux); aux is None without experts."""
    h = L.attention_train(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg, cos, sin)
    x = x + h
    y, aux = ffn(p, L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    return x + y, aux


def decoder_layer_decode(p, x, cache, pos, cfg, cos, sin):
    h, cache = L.attention_decode(
        p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cache, pos, cfg, cos, sin
    )
    x = x + h
    y, _ = ffn(p, L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    return x + y, cache


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
        self.last_aux: torch.Tensor | None = None

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
        ``fan_in ** -0.5`` (the embedding and untied head by ``d ** -0.5``;
        the MoE router and ``wg``/``wu`` by ``d ** -0.5``, ``wd`` by ``f **
        -0.5``), norm scales one, biases zero.  Returns the model."""
        cfg, dev = self.cfg, self.device
        d, V = cfg.d_model, cfg.vocab
        self.embed.copy_(L.dense_init(generator, V, d, scale=d**-0.5, device=dev))
        if not cfg.tie_embeddings:
            self.lm_head.copy_(L.dense_init(generator, d, V, device=dev))
        self.final_norm["scale"].fill_(1.0)
        stack = self.layers
        for norm in (stack.ln1, stack.ln2):
            norm["scale"].fill_(1.0)
        for group in (stack.attn,) if cfg.moe else (stack.attn, stack.mlp):
            for p in group.values():
                n, d_in, d_out = p["w"].shape
                for k, t in L.init_linear(generator, d_in, d_out, "b" in p, (n,), dev).items():
                    p[k].copy_(t)
        if cfg.moe:
            for k, t in L.init_moe(generator, cfg, (cfg.n_layers,), dev).items():
                stack.moe[k].copy_(t)
        return self

    # ----------------------------------------------------------- helpers
    def _lm_head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        # gathered in f32, then cast: the reference casts the table first,
        # the same values; its backward sums repeated tokens in bf16, this
        # one in f32
        return nn.functional.embedding(tokens.long(), self.embed).to(ACT_DTYPE)

    def _positions(self, B: int, S_len: int, offset: int = 0) -> torch.Tensor:
        """(B, S) positions; with M-RoPE (B, S, 3) streams: the first
        ``vision_patches`` positions on a 16-wide grid (t = 0, h = pos //
        16, w = pos % 16), the text after them at ``pos - P + 1`` in all
        three, as the reference's stub does (also when no patches are
        prepended)."""
        cfg = self.cfg
        pos = torch.arange(offset, offset + S_len, device=self.device)[None, :].expand(B, S_len)
        if cfg.mrope_sections:
            P, w = cfg.vision_patches, 16
            patch = pos < P
            text = pos - P + 1
            t = torch.where(patch, 0, text)
            h = torch.where(patch, pos // w, text)
            ww = torch.where(patch, pos % w, text)
            return torch.stack([t, h, ww], dim=-1)
        return pos

    def _rope(self, pos: torch.Tensor):
        return L.rope_angles(pos, self.cfg.hd, self.cfg.rope_theta, self.cfg.mrope_sections)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = L.rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        return (x @ self._lm_head().to(x.dtype)).float()

    # ----------------------------------------------------------- train
    def loss(self, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy + 0.01 x the MoE auxiliary loss
        summed over the layers (zero without experts), f32.  ``vlm``
        prepends ``batch["patches"]`` and scores only the text positions.
        The detached auxiliary sum is kept as ``last_aux``."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        B = tokens.shape[0]
        x = self._embed(tokens)
        if cfg.family == "vlm":
            x = torch.cat([batch["patches"].to(ACT_DTYPE), x], dim=1)
        n_prefix = x.shape[1] - tokens.shape[1]
        cos, sin = self._rope(self._positions(B, x.shape[1]))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.n_layers):
            if torch.is_grad_enabled():
                x, aux = checkpoint(self._train_layer, i, x, aux, cos, sin, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = self._train_layer(i, x, aux, cos, sin)
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
        if n_prefix:
            x = x[:, n_prefix:]
        nll = L.chunked_softmax_xent(x, self._lm_head(), labels)
        self.last_aux = aux.detach()
        return nll + 0.01 * aux

    def _train_layer(self, i, x, aux, cos, sin):
        x, a = decoder_layer_train(self.layers.layer(i), x, self.cfg, cos, sin)
        return x, aux if a is None else aux + a

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
        p1 = pos_t.reshape(1, 1).expand(B, 1)
        # M-RoPE: the raw position in all three streams, as the reference
        # decodes (its prefill gives text pos - P + 1)
        cos, sin = self._rope(torch.stack([p1, p1, p1], dim=-1) if cfg.mrope_sections else p1)
        for i in range(cfg.n_layers):
            layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
            x, _ = decoder_layer_decode(self.layers.layer(i), x, layer_cache, pos_t, cfg,
                                        cos, sin)
        return self._head(x), cache

    @torch.no_grad()
    def prefill(self, batch: dict):
        """Forward over the prompt ``batch["tokens"]`` (B, S), behind
        ``batch["patches"]`` (B, P, d) where given (``vlm``): f32 logits of
        the last position (B, 1, V) and the KV cache ``(L, B, P + S, nkv,
        hd)``.  MoE layers route the call's ``B * (P + S)`` tokens at
        once, so their capacity is that of the whole prompt."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B = tokens.shape[0]
        x = self._embed(tokens)
        if cfg.family == "vlm" and "patches" in batch:
            x = torch.cat([batch["patches"].to(ACT_DTYPE), x], dim=1)
        S_len = x.shape[1]
        cos, sin = self._rope(self._positions(B, S_len))
        ks, vs = [], []
        for i in range(cfg.n_layers):
            lp = self.layers.layer(i)
            hn = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
            q, k, v = L._qkv(lp["attn"], hn, cfg, cos, sin)
            o = L.flash_attention(q, k, v, causal=True)
            x = x + L.linear(lp["attn"]["wo"], o.reshape(B, S_len, -1))
            y, _ = ffn(lp, L.rmsnorm(lp["ln2"], x, cfg.norm_eps), cfg)
            x = x + y
            ks.append(k)
            vs.append(v)
        return self._head(x[:, -1:]), {"k": torch.stack(ks), "v": torch.stack(vs)}


def get_model(cfg: ModelConfig, device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (CUDA unless the caller asks for
    the CPU), parameters allocated and not yet initialised: call
    ``init(generator)`` or load a state."""
    return Model(cfg, device)
