"""Every family of the model zoo behind the reference's model interface.

Port of the JAX package's ``models/model.py`` for families ``"dense"``
(qwen2-1.5b, deepseek-coder-33b, minitron-4b, minitron-8b), ``"moe"``
(llama4-scout-17b-a16e, moonshot-v1-16b-a3b: the dense decoder layer
with ``moe_block`` in place of the MLP), ``"vlm"`` (qwen2-vl-7b: stub
vision patch embeddings prepended to the text, M-RoPE positions),
``"ssm"`` (rwkv6-3b: RWKV6 blocks, ``models/ssm.py``), ``"hybrid"``
(zamba2-2.7b: Mamba2 layers, and one shared attention block, the dense
decoder layer, after every ``shared_period`` of them) and ``"audio"``
(whisper-medium: an encoder over stub frame embeddings, ``batch["frames"]``
(B, n_audio_ctx, d), and a decoder that cross-attends to it; LayerNorm
blocks, GELU MLPs, sinusoidal positions, no RoPE).
``Model(cfg, device)`` is an ``nn.Module`` whose parameters have the
reference's pytree names and shapes: every per-layer tensor is stacked
along a leading ``n_layers`` axis (``layers.attn.wq.w`` is ``(L, d, nh *
hd)``, ``layers.moe.wg`` is ``(L, E, d, f)``, ``layers.mix.wa`` is ``(L,
d, lora)``, whisper's encoder ``enc_layers.mlp.wi.b`` ``(enc_layers,
f)``), the hybrid's Mamba2 tensors along two, ``(n_layers //
shared_period, shared_period, ...)``, beside the unstacked ``shared``
block, as the reference stacks them for ``lax.scan``.  That keeps the
AdamW decay rule (``p.ndim >= 2``: stacked norm scales and biases decay,
the top-level ``final_norm`` and ``enc_norm`` and the shared block's norm
scales do not), the checkpoint's leaf names and the converter
(``models/convert.py``) equal to the reference's.

* ``init(generator)``  -- fills the parameters from an explicit generator
* ``loss(batch)``      -- causal-LM loss (chunked vocab cross-entropy;
                          each layer, each whisper encoder layer, or each
                          hybrid group of ``shared_period`` Mamba2 layers
                          and the shared block, recomputed in the
                          backward) + 0.01 x the MoE auxiliary loss (kept
                          as ``last_aux``)
* ``prefill(batch)``   -- last-position logits and the cache: keys and
                          values (whisper: also the memory's per layer),
                          the recurrent state, or both (hybrid)
* ``decode_step(cache, tokens, pos)`` -- one token for the whole batch
* ``init_cache(B, S)`` -- a zeroed cache of the family's layout
                          (``cache_shapes``)
* ``input_specs(shape)`` -- a cell's inputs as meta tensors

With a mesh installed (``models/shard_ctx.py``; the meshed train step,
``launch/train.py:build_train_step(mesh=)``, installs it and hands each
rank its blocks) the layers split their work over ``model`` where the
reference's ``constrain`` pins cut it (``layers.py``), ``moe_block``
takes the expert-parallel ``moe_ep.py``, and where the vocabulary
divides the axis the embedding is looked up vocabulary-parallel: each
rank its rows' tokens in f32, zeros for the rest, summed over
``model`` (one rank contributes to a token, so the sum is exact), so
every rank holds the whole output, as the reference's ``"btd"`` pin on
it (``model.py:192``) lays it out.  A meshed prefill or decode
(``launch/dryrun.py:build_cell``) runs ``prefill`` and ``decode_step``
the same way, forward only, the recurrent mixers on the rank's heads
(``ssm.py``), the cache holding the rank's blocks (keys and values of a
block of the positions, ``layers.attention_decode``; the recurrent
states of its heads; the shift and conv carries whole), the logits'
vocabulary gathered whole.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.torch_engine import require_device
from repro_torch.launch.mesh import all_gather
from repro_torch.models import layers as L
from repro_torch.models import shard_ctx
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

ACT_DTYPE = torch.bfloat16
"""Activation dtype, read at call time (tests set it to float32)."""

PORTED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")
RECURRENT_FAMILIES = ("ssm", "hybrid")


def require_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported: ROADMAP.md §1 lists "
            f"the LM substrate's families; the port runs {PORTED_FAMILIES} only"
        )


def _sinusoid(S_len: int, d: int, offset: int = 0, device=None) -> torch.Tensor:
    """(S_len, d) f32 sinusoidal positions from ``offset``: sines at the even
    dimensions, cosines at the odd, computed in float64 with numpy and
    rounded to f32, as the reference computes them."""
    pos = np.arange(offset, offset + S_len)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / (10000 ** (dim / d))
    out = np.zeros((S_len, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out).to(device)


def _sinusoid_at(pos, d: int, device=None) -> torch.Tensor:
    """(1, d) f32 sinusoidal embedding of one position (an int or a 0-d
    tensor), computed in f32 on ``device`` as the reference's decode step
    computes it.  The divisor ``10000 ** (dim / d)`` is rounded from
    float64: XLA's f32 power is correctly rounded, torch's is one ulp off
    at some exponents, which moves a sine by 2e-5 at position 1,499."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)
    div = (10000 ** (dim / d).double()).float()
    ang = torch.as_tensor(pos, dtype=torch.float32, device=device) / div
    out = torch.zeros((1, d), dtype=torch.float32, device=device)
    out[0, 0::2] = torch.sin(ang)
    out[0, 1::2] = torch.cos(ang)
    return out


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


def _linear_shapes(lead: tuple, d_in: int, d_out: int, bias: bool = False) -> dict:
    return {"w": (*lead, d_in, d_out), **({"b": (*lead, d_out)} if bias else {})}


def _attention_shapes(cfg: ModelConfig, lead: tuple) -> dict:
    d, hd, nh, nkv = cfg.d_model, cfg.hd, cfg.nh_eff, cfg.n_kv
    return {"wq": _linear_shapes(lead, d, nh * hd, cfg.qkv_bias),
            "wk": _linear_shapes(lead, d, nkv * hd, cfg.qkv_bias),
            "wv": _linear_shapes(lead, d, nkv * hd, cfg.qkv_bias),
            "wo": _linear_shapes(lead, nh * hd, d)}


def decoder_shapes(cfg: ModelConfig, lead: tuple) -> dict:
    """One decoder layer's parameter shapes (attention, then SwiGLU or
    the MoE block), each behind ``lead``."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.moe:
        E = cfg.moe.n_experts
        ffn_ = {"moe": {"router": (*lead, d, E), "wg": (*lead, E, d, f),
                        "wu": (*lead, E, d, f), "wd": (*lead, E, f, d)}}
    else:
        ffn_ = {"mlp": {"wg": _linear_shapes(lead, d, f), "wu": _linear_shapes(lead, d, f),
                        "wd": _linear_shapes(lead, f, d)}}
    return {
        "ln1": {"scale": (*lead, d)},
        "attn": _attention_shapes(cfg, lead),
        "ln2": {"scale": (*lead, d)},
        **ffn_,
    }


def whisper_shapes(cfg: ModelConfig, lead: tuple, cross: bool) -> dict:
    """One whisper layer's parameter shapes (``model.py:147-160``), each
    behind ``lead``: LayerNorms, self-attention and the GELU MLP with its
    biases; a decoder layer (``cross``) also ``lnx`` and the
    cross-attention ``xattn``."""
    d, f = cfg.d_model, cfg.d_ff
    ln = {"scale": (*lead, d), "bias": (*lead, d)}
    shapes = {"ln1": ln, "attn": _attention_shapes(cfg, lead), "ln2": ln,
              "mlp": {"wi": _linear_shapes(lead, d, f, bias=True),
                      "wo": _linear_shapes(lead, f, d, bias=True)}}
    if cross:
        shapes.update(lnx=ln, xattn=_attention_shapes(cfg, lead))
    return shapes


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
# (norm scales, biases, LayerNorm biases; ssm.py:26-49, :156-166,
# layers.py:59-60), normal draws x a scale, and for every other leaf
# normal draws x fan_in ** -0.5, fan_in its second-to-last axis (a
# linear's "w", the MoE router and experts)
_INIT_CONSTANT = {"scale": 1.0, "b": 0.0, "bias": 0.0, "mu": 0.5, "w0": -6.0, "u": 0.0,
                  "A_log": 0.0, "D": 1.0, "dt_bias": 0.0}
_INIT_SCALE = {"wa": 0.01, "wb": 0.01, "conv_w": 0.1}


def _draws(tree: dict, generator: torch.Generator, prefix: str):
    """``(dotted name, whole value)`` of ``tree``'s leaves in its order
    (``Tree.tree``: sub-trees, then parameters, each as registered), each
    drawn when the previous one has been taken, on the generator's device."""
    dev = generator.device
    for k, p in tree.items():
        name = prefix + k
        if isinstance(p, dict):
            yield from _draws(p, generator, name + ".")
        elif k in _INIT_CONSTANT:
            yield name, torch.full(p.shape, _INIT_CONSTANT[k], device=dev)
        else:
            scale = _INIT_SCALE.get(k, p.shape[-2] ** -0.5)
            yield name, torch.randn(p.shape, generator=generator, device=dev) * scale


def _recomputed(fn, *args):
    """``fn(*args)``; while autograd records, its activations are not kept
    but recomputed in the backward."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def ffn(p, h: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The layer's feed-forward on ``h`` (B, S, d) and its f32 auxiliary
    loss: ``moe_block`` over the flattened ``(B * S, d)`` tokens, or
    SwiGLU and None."""
    if cfg.moe:
        B, S_len, d = h.shape
        y, aux = L.moe_block(p["moe"], h.reshape(B * S_len, d), cfg)
        return y.reshape(B, S_len, d), aux
    return L.mlp_swiglu(p["mlp"], h, cfg.d_ff), None


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
    h, k, v = L.attention_prefill(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg, cos,
                                  sin)
    x = x + h
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
        elif cfg.family == "audio":
            self.enc_layers = Tree(whisper_shapes(cfg, (cfg.enc_layers,), cross=False), device)
            self.layers = Tree(whisper_shapes(cfg, (cfg.n_layers,), cross=True), device)
            self.enc_norm = _params({"scale": torch.empty((d,), device=device),
                                     "bias": torch.empty((d,), device=device)})
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
    def init(self, generator: torch.Generator, keep=None) -> "Model":
        """Fills every parameter from ``generator`` (on the model's device)
        with the reference's distributions: normal draws scaled by
        ``fan_in ** -0.5`` (the embedding and untied head by ``d ** -0.5``;
        the MoE router and ``wg``/``wu`` by ``d ** -0.5``, ``wd`` by ``f **
        -0.5``), norm scales one, biases (LayerNorm biases too) zero, the
        recurrent layers' constants and scaled draws as ``_INIT_CONSTANT``
        and ``_INIT_SCALE`` list them.  Returns the model.

        With ``keep(name, whole)``, each parameter is replaced by what
        ``keep`` returns of its whole value, leaf by leaf in the same draw
        order (a rank of a mesh keeps its block: ``launch/train.py:
        shard_model``); the model may then start on the meta device."""
        cfg, dev = self.cfg, generator.device
        d, V = cfg.d_model, cfg.vocab

        def put(name: str, whole: torch.Tensor) -> None:
            if keep is None:
                self.get_parameter(name).copy_(whole)
                return
            owner, _, leaf = name.rpartition(".")
            module = self.get_submodule(owner) if owner else self
            module._parameters[leaf] = nn.Parameter(keep(name, whole))

        put("embed", L.dense_init(generator, V, d, scale=d**-0.5, device=dev))
        if not cfg.tie_embeddings:
            put("lm_head", L.dense_init(generator, d, V, device=dev))
        put("final_norm.scale", torch.ones((d,), device=dev))
        trees = [("layers.", self.layers.tree())]
        if cfg.family == "hybrid":
            trees.append(("shared.", self.shared.tree()))
        if cfg.family == "audio":
            trees += [("enc_layers.", self.enc_layers.tree()), ("enc_norm.", dict(self.enc_norm))]
        for prefix, tree in trees:
            for name, whole in _draws(tree, generator, prefix):
                put(name, whole)
        return self

    # ----------------------------------------------------------- helpers
    def _lm_head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        # gathered in f32, then cast: the reference casts the table first,
        # the same values; its backward sums repeated tokens in bf16, this
        # one in f32
        cut = shard_ctx.model_cut("btf", (*tokens.shape, self.cfg.vocab))
        if cut is None:
            return nn.functional.embedding(tokens.long(), self.embed).to(ACT_DTYPE)
        rows = self.embed.shape[0]  # this rank's block of the vocabulary
        at = tokens.long() - cut.index * rows
        mine = (at >= 0) & (at < rows)
        x = nn.functional.embedding(torch.where(mine, at, 0), self.embed)
        return shard_ctx.model_sum(torch.where(mine[..., None], x, 0.0), cut).to(ACT_DTYPE)

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
        """f32 logits of ``x``; with the vocabulary cut over ``model`` (a
        meshed prefill or decode), the rank's columns gathered whole."""
        x = L.rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        logits = (x @ self._lm_head().to(x.dtype)).float()
        cut = shard_ctx.model_cut("btf", (*x.shape[:-1], self.cfg.vocab))
        return logits if cut is None else all_gather(logits, cut.group, logits.dim() - 1)

    # ----------------------------------------------------------- train
    def loss(self, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy + 0.01 x the MoE auxiliary loss
        summed over the layers (zero without experts), f32.  ``vlm``
        prepends ``batch["patches"]`` and scores only the text positions.
        The detached auxiliary sum is kept as ``last_aux``.  ``audio``
        encodes ``batch["frames"]`` (B, n_audio_ctx, d) first; its decoder
        cross-attends to the encoding and has no auxiliary loss (zero)."""
        cfg = self.cfg
        if cfg.family == "audio":
            return self._loss_whisper(batch)
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
            x, aux = _recomputed(self._train_layer, i, x, aux, cos, sin)
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
        if n_prefix:
            x = x[:, n_prefix:]
        nll = L.chunked_softmax_xent(x, self._lm_head(), labels, vocab=cfg.vocab)
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

    # ----------------------------------------------------------- whisper
    def _loss_whisper(self, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        mem = self._encode(batch["frames"])
        x = self._embed(tokens) + _sinusoid(tokens.shape[1], cfg.d_model,
                                            device=self.device).to(ACT_DTYPE)
        for i in range(cfg.n_layers):
            x = _recomputed(self._whisper_train_layer, i, x, mem)
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
        self.last_aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return L.chunked_softmax_xent(x, self._lm_head(), labels, vocab=cfg.vocab)

    def _encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The encoder over ``frames`` (B, M, d) behind sinusoidal positions,
        each layer recomputed in the backward; LayerNorm ``enc_norm`` last."""
        cfg = self.cfg
        x = frames.to(ACT_DTYPE) + _sinusoid(frames.shape[1], cfg.d_model,
                                             device=self.device).to(ACT_DTYPE)
        for i in range(cfg.enc_layers):
            x = _recomputed(self._encoder_layer, i, x)
        return L.layernorm(self.enc_norm, x, cfg.norm_eps)

    def _encoder_layer(self, i: int, h: torch.Tensor) -> torch.Tensor:
        cfg, lp = self.cfg, self.enc_layers.layer(i)
        h = h + L.attention_train(lp["attn"], L.layernorm(lp["ln1"], h, cfg.norm_eps), cfg,
                                  None, None, rope=False, causal=False)
        return h + L.mlp_gelu(lp["mlp"], L.layernorm(lp["ln2"], h, cfg.norm_eps), cfg.d_ff)

    def _memory_kv(self, lp: dict, mem: torch.Tensor):
        """A decoder layer's keys and values (B, M, nkv, hd) of the
        encoding ``mem`` (B, M, d); with the cross-attention's heads cut
        over ``model``, projected whole on every rank, each rank's share
        of ``mem``'s gradient summed over ``model``."""
        cfg = self.cfg
        B, M = mem.shape[:2]
        mem = shard_ctx.model_copy(mem, L.head_cut(mem, cfg))
        mk = L.linear(lp["xattn"]["wk"], mem).reshape(B, M, cfg.n_kv, cfg.hd)
        mv = L.linear(lp["xattn"]["wv"], mem).reshape(B, M, cfg.n_kv, cfg.hd)
        return mk, mv

    def _cross_and_mlp(self, lp: dict, h: torch.Tensor, mk, mv,
                       cached: bool = False) -> torch.Tensor:
        """The rest of a decoder layer after its self-attention: the
        cross-attention to the memory's keys and values (``cached``: as a
        decode's cache holds them, ``layers.cross_attention_decode``), then
        the MLP."""
        eps = self.cfg.norm_eps
        cross = L.cross_attention_decode if cached else L.cross_attention_train
        h = h + cross(lp["xattn"], L.layernorm(lp["lnx"], h, eps), (mk, mv), self.cfg)
        return h + L.mlp_gelu(lp["mlp"], L.layernorm(lp["ln2"], h, eps), self.cfg.d_ff)

    def _whisper_train_layer(self, i: int, h: torch.Tensor, mem: torch.Tensor) -> torch.Tensor:
        """Decoder layer ``i`` over the whole sequence (causal), attending to
        the encoding ``mem``: the unit the backward recomputes."""
        cfg, lp = self.cfg, self.layers.layer(i)
        h = h + L.attention_train(lp["attn"], L.layernorm(lp["ln1"], h, cfg.norm_eps), cfg,
                                  None, None, rope=False, causal=True)
        return self._cross_and_mlp(lp, h, *self._memory_kv(lp, mem))

    def _whisper_prefill_layer(self, i: int, h: torch.Tensor, mem: torch.Tensor):
        """Decoder layer ``i`` over the prompt; returns (h, its keys and
        values, the memory's keys and values)."""
        cfg, lp = self.cfg, self.layers.layer(i)
        a, k, v = L.attention_prefill(lp["attn"], L.layernorm(lp["ln1"], h, cfg.norm_eps), cfg,
                                      None, None, rope=False)
        h = h + a
        mk, mv = self._memory_kv(lp, mem)
        return self._cross_and_mlp(lp, h, mk, mv), k, v, mk, mv

    # ----------------------------------------------------------- serve
    def init_cache(self, B: int, S_len: int, dtype=None) -> dict[str, torch.Tensor]:
        """A zeroed cache for ``B`` rows and ``S_len`` positions, in
        ``dtype`` (``ACT_DTYPE`` when None), laid out as
        :meth:`cache_shapes` says."""
        return {name: torch.zeros(shape, dtype=dt, device=self.device)
                for name, (shape, dt) in self.cache_shapes(B, S_len, dtype).items()}

    def cache_shapes(self, B: int, S_len: int, dtype=None) -> dict[str, tuple]:
        """Each cache leaf's (shape, dtype) for ``B`` rows and ``S_len``
        positions, ``dtype`` (``ACT_DTYPE`` when None) but for the f32
        recurrent states: keys and values ``(L, B, S_len, nkv, hd)``;
        ``ssm``: the ``wkv`` state ``(L, B, nh, hd, hd)`` and the shift
        carries ``x_tm``, ``x_cm`` ``(L, B, d)``; ``hybrid``: the ``ssm``
        state ``(G, P, B, nh, hd, N)``, the ``conv`` carry ``(G, P, B, K -
        1, inner + 2N)`` and the shared block's keys and values ``(G, B,
        S_len, nkv, hd)``, G groups of P layers; ``audio``: also the
        memory's keys and values ``mem_k``, ``mem_v`` ``(L, B,
        n_audio_ctx, nkv, hd)``."""
        cfg = self.cfg
        dtype = dtype or ACT_DTYPE
        f32 = torch.float32
        if cfg.family == "ssm":
            L_, nh, hd = cfg.n_layers, cfg.n_heads, cfg.hd
            return {"wkv": ((L_, B, nh, hd, hd), f32), "x_tm": ((L_, B, cfg.d_model), dtype),
                    "x_cm": ((L_, B, cfg.d_model), dtype)}
        if cfg.family == "hybrid":
            G, P, ssm = self.groups, cfg.shared_period, cfg.ssm
            inner, nh, hd = S.mamba2_dims(cfg)
            kv = (G, B, S_len, cfg.n_kv, cfg.hd)
            return {"ssm": ((G, P, B, nh, hd, ssm.d_state), f32),
                    "conv": ((G, P, B, ssm.conv_kernel - 1, inner + 2 * ssm.d_state), dtype),
                    "k": (kv, dtype), "v": (kv, dtype)}
        shape = (cfg.n_layers, B, S_len, cfg.n_kv, cfg.hd)
        cache = {"k": (shape, dtype), "v": (shape, dtype)}
        if cfg.family == "audio":
            mem = (cfg.n_layers, B, cfg.n_audio_ctx, cfg.n_kv, cfg.hd)
            cache.update(mem_k=(mem, dtype), mem_v=(mem, dtype))
        return cache

    def input_specs(self, shape) -> dict:
        """The inputs of a cell of ``shape`` (``models/config.py:SHAPES``) as
        tensors on the meta device, the reference's ``input_specs``: for
        ``"train"`` int32 ``tokens`` and ``labels`` (B, S); for
        ``"prefill"`` ``tokens``; both with ``patches`` (vlm) or ``frames``
        (audio) in ``ACT_DTYPE``; for ``"decode"`` ``tokens`` (B, 1), the
        ``cache`` of ``S`` positions and the int32 scalar ``pos``."""
        cfg = self.cfg
        B, S_len = shape.global_batch, shape.seq_len

        def meta(dims, dtype):
            return torch.empty(dims, dtype=dtype, device="meta")

        if shape.kind == "decode":
            return {"tokens": meta((B, 1), torch.int32),
                    "cache": {name: meta(dims, dt)
                              for name, (dims, dt) in self.cache_shapes(B, S_len).items()},
                    "pos": meta((), torch.int32)}
        specs = {"tokens": meta((B, S_len), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = meta((B, S_len), torch.int32)
        if cfg.family == "vlm":
            specs["patches"] = meta((B, cfg.vision_patches, cfg.d_model), ACT_DTYPE)
        if cfg.family == "audio":
            specs["frames"] = meta((B, cfg.n_audio_ctx, cfg.d_model), ACT_DTYPE)
        return specs

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor, pos):
        """tokens (B, 1); pos a scalar, the same for the whole batch.
        Writes the cache in place (slot ``pos`` of the keys and values,
        the recurrent state and carries, each cast to the cache's dtype);
        returns (f32 logits (B, 1, V), the cache).  ``audio`` attends to the
        memory's keys and values in the cache, left as the prefill wrote
        them."""
        cfg = self.cfg
        B = tokens.shape[0]
        x = self._embed(tokens)
        pos_t = torch.as_tensor(pos, device=self.device)
        if cfg.family == "audio":
            x = x + _sinusoid_at(pos_t, cfg.d_model, device=self.device).to(ACT_DTYPE)
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
            cut = S.mamba2_cut(x, cfg)
            for g in range(self.groups):
                for j in range(cfg.shared_period):
                    st = {"ssm": cache["ssm"][g, j],
                          "conv": S.conv_block(cache["conv"][g, j], cfg, cut)}
                    x, st = S.mamba2_block(self.layers.layer((g, j)), x, cfg, st)
                    cache["ssm"][g, j].copy_(st["ssm"])
                    cache["conv"][g, j].copy_(S.conv_whole(st["conv"], cfg, cut))
                x, _ = decoder_layer_decode(shared, x, {"k": cache["k"][g], "v": cache["v"][g]},
                                            pos_t, cfg, cos, sin)
        elif cfg.family == "audio":
            for i in range(cfg.n_layers):
                lp = self.layers.layer(i)
                a, _ = L.attention_decode(
                    lp["attn"], L.layernorm(lp["ln1"], x, cfg.norm_eps),
                    {"k": cache["k"][i], "v": cache["v"][i]}, pos_t, cfg, None, None, rope=False)
                x = self._cross_and_mlp(lp, x + a, cache["mem_k"][i], cache["mem_v"][i],
                                        cached=True)
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
        ``(G, B, S, nkv, hd)``; ``audio`` (the prompt after the encoding of
        ``batch["frames"]``) also the memory's keys and values per layer.
        MoE layers route the call's ``B * (P + S)`` tokens at once, so
        their capacity is that of the whole prompt."""
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
            cut = S.mamba2_cut(x, cfg)
            groups, ks, vs = [], [], []
            for g in range(self.groups):
                states = []
                for j in range(cfg.shared_period):
                    x, st = S.mamba2_block(self.layers.layer((g, j)), x, cfg)
                    states.append({"ssm": st["ssm"], "conv": S.conv_whole(st["conv"], cfg, cut)})
                groups.append({k: torch.stack([st[k] for st in states])
                               for k in ("ssm", "conv")})
                x, k, v = decoder_layer_prefill(shared, x, cfg, cos, sin)
                ks.append(k)
                vs.append(v)
            cache = {k: torch.stack([grp[k] for grp in groups]) for k in ("ssm", "conv")}
            cache.update(k=torch.stack(ks), v=torch.stack(vs))
        elif cfg.family == "audio":
            mem = self._encode(batch["frames"])
            x = x + _sinusoid(x.shape[1], cfg.d_model, device=self.device).to(ACT_DTYPE)
            parts = []
            for i in range(cfg.n_layers):
                x, *kv = self._whisper_prefill_layer(i, x, mem)
                parts.append(kv)
            cache = {key: torch.stack(leaf) for key, leaf in
                     zip(("k", "v", "mem_k", "mem_v"), zip(*parts))}
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
