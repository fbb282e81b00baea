"""Every ported family behind the reference's model interface.

Port of the JAX package's ``models/model.py`` for families ``"dense"``
(qwen2-1.5b, deepseek-coder-33b, minitron-4b, minitron-8b), ``"moe"``
(llama4-scout-17b-a16e, moonshot-v1-16b-a3b: the dense decoder layer
with ``moe_block`` in place of the MLP), ``"vlm"`` (qwen2-vl-7b: stub
vision patch embeddings prepended to the text, M-RoPE positions),
``"ssm"`` (rwkv6-3b: RWKV6 blocks, ``models/ssm.py``) and ``"hybrid"``
(zamba2-2.7b: Mamba2 layers, and one shared attention block, the dense
decoder layer, after every ``shared_period`` of them).
``Model(cfg, device)`` is an ``nn.Module`` whose parameters have the
reference's pytree names and shapes: every per-layer tensor is stacked
along a leading ``n_layers`` axis (``layers.attn.wq.w`` is ``(L, d, nh *
hd)``, ``layers.moe.wg`` is ``(L, E, d, f)``, ``layers.mix.wa`` is ``(L,
d, lora)``), the hybrid's Mamba2 tensors along two, ``(n_layers //
shared_period, shared_period, ...)``, beside the unstacked ``shared``
block, as the reference stacks them for ``lax.scan``.  That keeps the
AdamW decay rule (``p.ndim >= 2``: stacked norm scales and biases decay,
the top-level ``final_norm`` and the shared block's norm scales do not),
the checkpoint's leaf names and the converter (``models/convert.py``)
equal to the reference's.

* ``init(generator)``  -- fills the parameters from an explicit generator
* ``loss(batch)``      -- causal-LM loss (chunked vocab cross-entropy;
                          each layer, or each hybrid group of
                          ``shared_period`` Mamba2 layers and the shared
                          block, recomputed in the backward) + 0.01 x the
                          MoE auxiliary loss (kept as ``last_aux``)
* ``prefill(batch)``   -- last-position logits and the cache: keys and
                          values, the recurrent state, or both (hybrid)
* ``decode_step(cache, tokens, pos)`` -- one token for the whole batch
* ``init_cache(B, S)`` -- a zeroed cache of the family's layout

``"audio"`` raises ``NotImplementedError``: ROADMAP.md §1 queues it.  The
reference's ``shard_ctx.constrain`` hints are the identity on one device
and are left out until the mesh slice, with its expert-parallel
``moe_ep.py``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.torch_engine import require_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

ACT_DTYPE = torch.bfloat16
"""Activation dtype, read at call time (tests set it to float32)."""

PORTED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")
RECURRENT_FAMILIES = ("ssm", "hybrid")
_QUEUED = {"audio": "item 4 (whisper)"}


def require_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        where = _QUEUED.get(cfg.family, "no item")
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported yet: ROADMAP.md §1, "
            f"the LM substrate's queue, {where}; the port runs {PORTED_FAMILIES} only"
        )


def _params(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})


def _slice(tree, i) -> dict:
    """Layer ``i``'s slice (an index, or a tuple of indices for the
    hybrid's two leading axes) of a nested dict (or ``Tree``) of stacked
    parameters."""
    if isinstance(tree, Tree):
        tree = tree.tree()
    return {k: (_slice(v, i) if isinstance(v, dict) else v[i]) for k, v in tree.items()}


class Tree(nn.Module):
    """Parameters under the reference's nested names, from a nested dict
    of shapes: a dict becomes a sub-tree, a shape an (uninitialised)
    parameter, so ``{"mix": {"wa": (L, d, r), "wr": {"w": ...}}}`` gives
    ``mix.wa`` and ``mix.wr.w``."""

    def __init__(self, shapes: dict, device):
        super().__init__()
        for k, v in shapes.items():
            if isinstance(v, dict):
                self.add_module(k, Tree(v, device))
            else:
                self.register_parameter(k, nn.Parameter(torch.empty(v, device=device)))

    def tree(self) -> dict:
        """The parameters as nested dicts of tensors."""
        out = {k: m.tree() for k, m in self.named_children()}
        out.update(self.named_parameters(recurse=False))
        return out

    def layer(self, i) -> dict:
        return _slice(self.tree(), i)


def decoder_shapes(cfg: ModelConfig, lead: tuple) -> dict:
    """One decoder layer's parameter shapes (attention, then SwiGLU or
    the MoE block), each behind ``lead``."""
    d, hd, nh, nkv, f = cfg.d_model, cfg.hd, cfg.nh_eff, cfg.n_kv, cfg.d_ff

    def lin(d_in, d_out, bias=False):
        return {"w": (*lead, d_in, d_out), **({"b": (*lead, d_out)} if bias else {})}

    if cfg.moe:
        E = cfg.moe.n_experts
        ffn_ = {"moe": {"router": (*lead, d, E), "wg": (*lead, E, d, f),
                        "wu": (*lead, E, d, f), "wd": (*lead, E, f, d)}}
    else:
        ffn_ = {"mlp": {"wg": lin(d, f), "wu": lin(d, f), "wd": lin(f, d)}}
    return {
        "ln1": {"scale": (*lead, d)},
        "attn": {"wq": lin(d, nh * hd, cfg.qkv_bias), "wk": lin(d, nkv * hd, cfg.qkv_bias),
                 "wv": lin(d, nkv * hd, cfg.qkv_bias), "wo": lin(nh * hd, d)},
        "ln2": {"scale": (*lead, d)},
        **ffn_,
    }


def rwkv6_shapes(cfg: ModelConfig, lead: tuple) -> dict:
    """One RWKV6 block's parameter shapes (``ssm.py:22-49``), each behind
    ``lead``."""
    d, f, nh, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.hd
    lora = max(32, d // 16)

    def lin(d_in, d_out):
        return {"w": (*lead, d_in, d_out)}

    return {
        "ln1": {"scale": (*lead, d)},
        "ln2": {"scale": (*lead, d)},
        "mix": {"mu": (*lead, 5, d), "wr": lin(d, nh * hd), "wk": lin(d, nh * hd),
                "wv": lin(d, nh * hd), "wg": lin(d, nh * hd), "w0": (*lead, nh * hd),
                "wa": (*lead, d, lora), "wb": (*lead, lora, nh * hd), "u": (*lead, nh, hd),
                "wo": lin(nh * hd, d), "gn": {"scale": (*lead, hd)}},
        "cmix": {"mu": (*lead, 2, d), "wk": lin(d, f), "wv": lin(f, d), "wr": lin(d, d)},
    }


def mamba2_shapes(cfg: ModelConfig, lead: tuple) -> dict:
    """One Mamba2 layer's parameter shapes (``ssm.py:149-166``), each
    behind ``lead``."""
    d, N, K = cfg.d_model, cfg.ssm.d_state, cfg.ssm.conv_kernel
    inner, nh, hd = S.mamba2_dims(cfg)
    return {
        "ln": {"scale": (*lead, d)},
        "in_proj": {"w": (*lead, d, 2 * inner + 2 * N + nh)},
        "conv_w": (*lead, K, inner + 2 * N),
        "A_log": (*lead, nh),
        "D": (*lead, nh),
        "dt_bias": (*lead, nh),
        "gn": {"scale": (*lead, hd)},
        "out_proj": {"w": (*lead, inner, d)},
    }


# the reference's draws of a layer's leaves, by leaf name: constants
# (norm scales, biases; ssm.py:26-49, :156-166), normal draws x a scale,
# and for every other leaf normal draws x fan_in ** -0.5, fan_in its
# second-to-last axis (a linear's "w", the MoE router and experts)
_INIT_CONSTANT = {"scale": 1.0, "b": 0.0, "mu": 0.5, "w0": -6.0, "u": 0.0, "A_log": 0.0,
                  "D": 1.0, "dt_bias": 0.0}
_INIT_SCALE = {"wa": 0.01, "wb": 0.01, "conv_w": 0.1}


@torch.no_grad()
def _init_tree(tree: dict, generator: torch.Generator) -> None:
    """Fills ``tree``'s leaves in its order (``Tree.tree``: sub-trees, then
    parameters, each as registered)."""
    for k, p in tree.items():
        if isinstance(p, dict):
            _init_tree(p, generator)
        elif k in _INIT_CONSTANT:
            p.fill_(_INIT_CONSTANT[k])
        else:
            scale = _INIT_SCALE.get(k, p.shape[-2] ** -0.5)
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * scale)


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


def decoder_layer_prefill(p, x, cfg, cos, sin):
    """A decoder layer over the whole prompt; returns (x, its keys and
    values (B, S, nkv, hd))."""
    B, S_len = x.shape[:2]
    hn = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = L._qkv(p["attn"], hn, cfg, cos, sin)
    o = L.flash_attention(q, k, v, causal=True)
    x = x + L.linear(p["attn"]["wo"], o.reshape(B, S_len, -1))
    y, _ = ffn(p, L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    return x + y, k, v


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        require_family(cfg)
        if cfg.family == "hybrid" and (cfg.shared_period < 1
                                       or cfg.n_layers % cfg.shared_period):
            raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a whole number of "
                             f"groups of shared_period {cfg.shared_period}")
        device = require_device(device, "Model", 'device="cpu"')
        self.cfg = cfg
        d = cfg.d_model
        self.embed = nn.Parameter(torch.empty((cfg.vocab, d), device=device))
        self.final_norm = _params({"scale": torch.empty((d,), device=device)})
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty((d, cfg.vocab), device=device))
        if cfg.family == "ssm":
            self.layers = Tree(rwkv6_shapes(cfg, (cfg.n_layers,)), device)
        elif cfg.family == "hybrid":
            self.layers = Tree(mamba2_shapes(cfg, (self.groups, cfg.shared_period)), device)
            self.shared = Tree(decoder_shapes(cfg, ()), device)
        else:
            self.layers = Tree(decoder_shapes(cfg, (cfg.n_layers,)), device)
        self.last_aux: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def recurrent(self) -> bool:
        """The family carries a recurrent state (``ssm``, ``hybrid``)."""
        return self.cfg.family in RECURRENT_FAMILIES

    @property
    def groups(self) -> int:
        """Hybrid: the groups of ``shared_period`` Mamba2 layers, each
        followed by the shared block."""
        return self.cfg.n_layers // self.cfg.shared_period

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
        -0.5``), norm scales one, biases zero, the recurrent layers'
        constants and scaled draws as ``_INIT_CONSTANT`` and
        ``_INIT_SCALE`` list them.  Returns the model."""
        cfg, dev = self.cfg, self.device
        d, V = cfg.d_model, cfg.vocab
        self.embed.copy_(L.dense_init(generator, V, d, scale=d**-0.5, device=dev))
        if not cfg.tie_embeddings:
            self.lm_head.copy_(L.dense_init(generator, d, V, device=dev))
        self.final_norm["scale"].fill_(1.0)
        _init_tree(self.layers.tree(), generator)
        if cfg.family == "hybrid":
            _init_tree(self.shared.tree(), generator)
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
        units = self.groups if cfg.family == "hybrid" else cfg.n_layers
        for i in range(units):
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
        """Layer ``i`` (hybrid: group ``i``, its Mamba2 layers and the
        shared block), the unit the backward recomputes."""
        cfg = self.cfg
        if cfg.family == "ssm":
            x, _ = S.rwkv6_block(self.layers.layer(i), x, cfg)
            return x, aux
        if cfg.family == "hybrid":
            for j in range(cfg.shared_period):
                x, _ = S.mamba2_block(self.layers.layer((i, j)), x, cfg)
            x, _ = decoder_layer_train(self.shared.tree(), x, cfg, cos, sin)
            return x, aux
        x, a = decoder_layer_train(self.layers.layer(i), x, cfg, cos, sin)
        return x, aux if a is None else aux + a

    # ----------------------------------------------------------- serve
    def init_cache(self, B: int, S_len: int, dtype=None) -> dict[str, torch.Tensor]:
        """A zeroed cache for ``B`` rows and ``S_len`` positions, in
        ``dtype`` (``ACT_DTYPE`` when None): keys and values ``(L, B,
        S_len, nkv, hd)``; ``ssm``: the f32 ``wkv`` state ``(L, B, nh,
        hd, hd)`` and the shift carries ``x_tm``, ``x_cm`` ``(L, B, d)``;
        ``hybrid``: the f32 ``ssm`` state ``(G, P, B, nh, hd, N)``, the
        ``conv`` carry ``(G, P, B, K - 1, inner + 2N)`` and the shared
        block's keys and values ``(G, B, S_len, nkv, hd)``, G groups of
        P layers."""
        cfg, dev = self.cfg, self.device
        dtype = dtype or ACT_DTYPE
        f32 = torch.float32

        def zeros(shape, dt):
            return torch.zeros(shape, dtype=dt, device=dev)

        if cfg.family == "ssm":
            L_, nh, hd = cfg.n_layers, cfg.n_heads, cfg.hd
            return {"wkv": zeros((L_, B, nh, hd, hd), f32),
                    "x_tm": zeros((L_, B, cfg.d_model), dtype),
                    "x_cm": zeros((L_, B, cfg.d_model), dtype)}
        if cfg.family == "hybrid":
            G, P, ssm = self.groups, cfg.shared_period, cfg.ssm
            inner, nh, hd = S.mamba2_dims(cfg)
            kv = (G, B, S_len, cfg.n_kv, cfg.hd)
            return {"ssm": zeros((G, P, B, nh, hd, ssm.d_state), f32),
                    "conv": zeros((G, P, B, ssm.conv_kernel - 1, inner + 2 * ssm.d_state),
                                  dtype),
                    "k": zeros(kv, dtype), "v": zeros(kv, dtype)}
        shape = (cfg.n_layers, B, S_len, cfg.n_kv, cfg.hd)
        return {"k": zeros(shape, dtype), "v": zeros(shape, dtype)}

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor, pos):
        """tokens (B, 1); pos a scalar, the same for the whole batch.
        Writes the cache in place (slot ``pos`` of the keys and values,
        the recurrent state and carries, each cast to the cache's dtype);
        returns (f32 logits (B, 1, V), the cache)."""
        cfg = self.cfg
        B = tokens.shape[0]
        x = self._embed(tokens)
        pos_t = torch.as_tensor(pos, device=self.device)
        p1 = pos_t.reshape(1, 1).expand(B, 1)
        # M-RoPE: the raw position in all three streams, as the reference
        # decodes (its prefill gives text pos - P + 1)
        cos, sin = self._rope(torch.stack([p1, p1, p1], dim=-1) if cfg.mrope_sections else p1)
        if cfg.family == "ssm":
            for i in range(cfg.n_layers):
                st = {k: cache[k][i] for k in ("wkv", "x_tm", "x_cm")}
                x, st = S.rwkv6_block(self.layers.layer(i), x, cfg, st)
                for k in ("wkv", "x_tm", "x_cm"):
                    cache[k][i].copy_(st[k])
        elif cfg.family == "hybrid":
            shared = self.shared.tree()
            for g in range(self.groups):
                for j in range(cfg.shared_period):
                    st = {k: cache[k][g, j] for k in ("ssm", "conv")}
                    x, st = S.mamba2_block(self.layers.layer((g, j)), x, cfg, st)
                    for k in ("ssm", "conv"):
                        cache[k][g, j].copy_(st[k])
                x, _ = decoder_layer_decode(shared, x, {"k": cache["k"][g], "v": cache["v"][g]},
                                            pos_t, cfg, cos, sin)
        else:
            for i in range(cfg.n_layers):
                layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
                x, _ = decoder_layer_decode(self.layers.layer(i), x, layer_cache, pos_t, cfg,
                                            cos, sin)
        return self._head(x), cache

    @torch.no_grad()
    def prefill(self, batch: dict):
        """Forward over the prompt ``batch["tokens"]`` (B, S), behind
        ``batch["patches"]`` (B, P, d) where given (``vlm``): f32 logits of
        the last position (B, 1, V) and the cache after it, laid out as
        ``init_cache`` lays it out: keys and values ``(L, B, P + S, nkv,
        hd)``; ``ssm`` the state and carries after the last position;
        ``hybrid`` those and the shared block's keys and values per group
        ``(G, B, S, nkv, hd)``.  MoE layers route the call's ``B * (P +
        S)`` tokens at once, so their capacity is that of the whole
        prompt."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B = tokens.shape[0]
        x = self._embed(tokens)
        if cfg.family == "vlm" and "patches" in batch:
            x = torch.cat([batch["patches"].to(ACT_DTYPE), x], dim=1)
        cos, sin = self._rope(self._positions(B, x.shape[1]))
        if cfg.family == "ssm":
            states = []
            for i in range(cfg.n_layers):
                x, st = S.rwkv6_block(self.layers.layer(i), x, cfg)
                states.append(st)
            cache = {k: torch.stack([st[k] for st in states]) for k in ("wkv", "x_tm", "x_cm")}
        elif cfg.family == "hybrid":
            shared = self.shared.tree()
            groups, ks, vs = [], [], []
            for g in range(self.groups):
                states = []
                for j in range(cfg.shared_period):
                    x, st = S.mamba2_block(self.layers.layer((g, j)), x, cfg)
                    states.append(st)
                groups.append({k: torch.stack([st[k] for st in states])
                               for k in ("ssm", "conv")})
                x, k, v = decoder_layer_prefill(shared, x, cfg, cos, sin)
                ks.append(k)
                vs.append(v)
            cache = {k: torch.stack([grp[k] for grp in groups]) for k in ("ssm", "conv")}
            cache.update(k=torch.stack(ks), v=torch.stack(vs))
        else:
            ks, vs = [], []
            for i in range(cfg.n_layers):
                x, k, v = decoder_layer_prefill(self.layers.layer(i), x, cfg, cos, sin)
                ks.append(k)
                vs.append(v)
            cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
        return self._head(x[:, -1:]), cache


def get_model(cfg: ModelConfig, device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (CUDA unless the caller asks for
    the CPU), parameters allocated and not yet initialised: call
    ``init(generator)`` or load a state."""
    return Model(cfg, device)
