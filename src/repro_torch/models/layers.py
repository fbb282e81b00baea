"""Transformer building blocks of the decoder families, as functions on tensors.

Port of the JAX package's ``models/layers.py``: RMSNorm and LayerNorm,
RoPE with M-RoPE sections, flash attention and cross-attention, the
SwiGLU and GELU MLPs and the token-choice MoE block.  Conventions, as
in the reference:

* parameters are nested dicts of tensors (``{"w": ..., "b": ...}``), one
  layer's slice of the model's stacked ``(n_layers, ...)`` parameters;
* activations are bf16 by default (``models/model.py:ACT_DTYPE``) with
  f32 softmax, norm and cross-entropy accumulations; weights are f32 and
  cast to the activations' dtype where they are used;
* attention is the reference's flash formulation in plain PyTorch: one
  einsum up to 2,048 positions, an online softmax over 512-query and
  1,024-key chunks above that.  No library attention
  (``scaled_dot_product_attention``, cuDNN) stands in for it: those sum
  in another order and are not what the reference computes.

The reference's ``shard_ctx.constrain`` calls pin activation layouts for
GSPMD.  The port has no GSPMD: at those sites the layers ask
``shard_ctx.model_cut`` whether the pin cuts a dimension over ``model``
and, with a mesh installed, split the work as the pin lays it out
(Megatron-style; the parameters are then this rank's blocks, as the
meshed train step hands them over):

* attention (``"bthd"``, ``layers.py:117``): q for the rank's
  ``nh / model`` heads from its columns of ``wq``, k and v whole
  (``"bthd_rep"``, ``:120-121``) and cut to the heads' GQA groups, the
  output through the rank's rows of ``wo`` summed over ``model``
  (``"btd"``, ``:249``);
* the MLPs (``"btf"``, ``:301-302``, ``:311-312``): the rank's columns of
  the up-projections, its rows of the down-projection, summed; a
  down-projection's bias added once, after the sum;
* the cross-entropy (``"btf"`` on the logits, ``:399``): f32 logits of
  the rank's vocabulary rows, their max and sum of exponentials taken
  over ``model``, the gold logit from the rank that holds it.

Without a mesh, or where a pin does not cut (heads or widths the axis
does not divide), a layer runs whole, as the reference's does.

A meshed prefill or decode (``launch/dryrun.py``) splits the same way:
the prefill's attention projects every key head whole for the cache
(:func:`attention_prefill`); a decode attends over the block of the
cache's positions the rank holds, its q gathered whole over ``model``,
and combines the blocks' softmax by the log-sum-exp
(:func:`attend_cached`); ``moe_block`` routes every token of the call at
once, as the reference's serving cells (no mesh installed) do.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import all_gather, all_reduce
from repro_torch.models import shard_ctx
from repro_torch.models.shard_ctx import Cut, model_copy, model_sum


def causal_skip() -> bool:
    """``REPRO_CAUSAL_SKIP=1``: a causal chunked attention scans, for each
    query chunk, only the key chunks at or before it (the same values:
    the skipped chunks add exact zeros).  Read at call time; off by
    default, as in the reference."""
    return os.environ.get("REPRO_CAUSAL_SKIP") == "1"


# ---------------------------------------------------------------- init


def dense_init(generator: torch.Generator, d_in: int, d_out: int, scale=None,
               device=None) -> torch.Tensor:
    """f32 normal draws of shape ``(d_in, d_out)`` times ``scale`` (``d_in
    ** -0.5`` by default)."""
    scale = scale if scale is not None else d_in**-0.5
    return torch.randn((d_in, d_out), generator=generator, device=device) * scale


def linear(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Computed in f32, cast back to ``x``'s dtype."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * p["scale"]).to(x.dtype)


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 mean and biased variance, then ``scale`` and ``bias``; cast back
    to ``x``'s dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


# ---------------------------------------------------------------- RoPE


def rope_angles(pos: torch.Tensor, hd: int, theta: float, sections=()):
    """pos (..., S) int -> f32 cos/sin (..., S, hd // 2).

    With ``sections`` (M-RoPE), pos is (..., S, n_sections) and frequency
    group ``i`` (``sections[i]`` consecutive frequencies) is driven by
    position stream ``i`` (Qwen2-VL)."""
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=pos.device) / half)
    if sections:
        assert sum(sections) == half, (sections, half)
        # each frequency's stream, from the static sections (no data-dependent shape)
        sec_id = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)],
                              device=pos.device)
        ang = pos.float()[..., sec_id] * freqs  # (..., S, half)
    else:
        ang = pos.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, n, hd); cos/sin (..., S, hd // 2), broadcast over heads;
    the rotate-half layout."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------- attention


def head_cut(x: torch.Tensor, cfg) -> Cut | None:
    """The installed mesh's cut of an attention's heads over ``model``
    (the reference's ``"bthd"`` pin on q), for the input ``x`` (B, S, d)."""
    return shard_ctx.model_cut("bthd", (*x.shape[:2], cfg.nh_eff, cfg.hd))


def rank_kv(t: torch.Tensor, cut: Cut, nh: int, cfg) -> torch.Tensor:
    """The key (or value) heads of ``t`` (B, S, nkv, hd) that this rank's
    ``nh`` query heads read, ``g`` query heads to a key head: a block of
    whole GQA groups, the one group the rank's heads fall in, or else a
    key head for each query head."""
    g = cfg.nh_eff // cfg.n_kv
    h0 = cut.index * nh
    if nh % g == 0:
        return t[:, :, h0 // g:(h0 + nh) // g]
    if g % nh == 0:
        return t[:, :, h0 // g:h0 // g + 1]
    return t.repeat_interleave(g, dim=2)[:, :, h0:h0 + nh]


def _qkv(p, x: torch.Tensor, cfg, cos, sin, rope: bool = True, cut: Cut | None = None,
         whole_kv: bool = False):
    """q, k and v of ``x``; with ``cut``, q of this rank's heads from its
    columns of ``wq``, k and v projected whole and cut to the key heads
    those heads read (:func:`rank_kv`), or left whole with ``whole_kv``
    (a cache keeps them all)."""
    B, S, _ = x.shape
    hd, nh, nkv = cfg.hd, cfg.nh_eff, cfg.n_kv
    if cut is not None:
        nh //= cut.size
    q = linear(p["wq"], x).reshape(B, S, nh, hd)
    k = linear(p["wk"], x).reshape(B, S, nkv, hd)
    v = linear(p["wv"], x).reshape(B, S, nkv, hd)
    if cut is not None and not whole_kv:
        k, v = rank_kv(k, cut, nh, cfg), rank_kv(v, cut, nh, cfg)
    if rope:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """q (B, Sq, nh, hd), k/v (B, Sk, nkv, hd); GQA by head grouping
    (g = nh / nkv query heads share a key head).

    At ``Sq, Sk <= 2048`` one einsum, softmax in f32, cast to ``v``'s
    dtype.  Above, an online softmax over ``q_chunk`` queries and
    ``kv_chunk`` keys, both padded to whole chunks, with f32 running max,
    sum and accumulator."""
    B, Sq, nh, hd = q.shape
    _, Sk, nkv, _ = k.shape
    g = nh // nkv
    q = (q * hd**-0.5).reshape(B, Sq, nkv, g, hd)

    if Sq <= 2048 and Sk <= 2048:
        s = torch.einsum("bqkgh,bskh->bkgqs", q, k).float()
        if causal:
            mask = (torch.arange(Sk, device=q.device)[None, :]
                    <= torch.arange(Sq, device=q.device)[:, None])
            s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bkgqs,bskh->bqkgh", p, v)
        return o.reshape(B, Sq, nh, hd)

    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    q_pad = -Sq % q_chunk
    k_pad = -Sk % kv_chunk
    if q_pad:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, q_pad))
    if k_pad:
        k = F.pad(k, (0, 0, 0, 0, 0, k_pad))
        v = F.pad(v, (0, 0, 0, 0, 0, k_pad))
    nq, nk = (Sq + q_pad) // q_chunk, (Sk + k_pad) // kv_chunk
    skip = causal and causal_skip()
    outs = []
    for qi in range(nq):
        # with the causal skip, chunk qi scans only its causal key prefix
        n_i = min(nk, ((qi + 1) * q_chunk + kv_chunk - 1) // kv_chunk) if skip else nk
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        outs.append(_flash_one_q(qi, qc, k, v, n_i, q_chunk, kv_chunk, Sk, causal))
    o = torch.stack(outs, dim=3)  # (B, nkv, g, nq, Cq, hd)
    o = o.reshape(B, nkv, g, nq * q_chunk, hd).permute(0, 3, 1, 2, 4)
    return o.reshape(B, nq * q_chunk, nh, hd)[:, :Sq].to(v.dtype)


def _flash_one_q(qi, qc, k, v, n_kv, q_chunk, kv_chunk, Sk, causal):
    """One query chunk (B, Cq, nkv, g, hd) against the first ``n_kv`` key
    chunks: the reference's ``kv_step`` scan, unrolled."""
    B, Cq, nkv, g, hd = qc.shape
    dev = qc.device
    qpos = qi * q_chunk + torch.arange(q_chunk, device=dev)
    m = torch.full((B, nkv, g, q_chunk), float("-inf"), device=dev)
    l = torch.zeros((B, nkv, g, q_chunk), device=dev)
    acc = torch.zeros((B, nkv, g, q_chunk, hd), device=dev)
    for ki in range(n_kv):
        kc = k[:, ki * kv_chunk:(ki + 1) * kv_chunk]
        vc = v[:, ki * kv_chunk:(ki + 1) * kv_chunk]
        s = torch.einsum("bqkgh,bskh->bkgqs", qc, kc).float()
        kpos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
        mask = kpos[None, :] < Sk  # padded key slots never attend
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        s = s.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", p.to(vc.dtype), vc
        ).float()
        m = m_new
    return acc / torch.clamp(l, min=1e-20)[..., None]


def out_proj(p, h: torch.Tensor, cut: Cut | None) -> torch.Tensor:
    """``linear(p, h)`` of a region's output: with ``cut``, ``h`` times the
    rank's rows of ``p["w"]`` summed over ``model``, the bias added once
    after the sum."""
    y = model_sum(h @ p["w"].to(h.dtype), cut)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def attention_train(p, x: torch.Tensor, cfg, cos, sin, rope: bool = True,
                    causal: bool = True) -> torch.Tensor:
    cut = head_cut(x, cfg)
    q, k, v = _qkv(p, model_copy(x, cut), cfg, cos, sin, rope, cut)
    o = flash_attention(q, k, v, causal=causal)
    B, S = x.shape[:2]
    return out_proj(p["wo"], o.reshape(B, S, -1), cut)


def attention_prefill(p, x: torch.Tensor, cfg, cos, sin, rope: bool = True):
    """The causal self-attention over a prompt ``x`` (B, S, d): (out, k, v),
    the keys and values (B, S, nkv, hd) of every key head, as a cache
    keeps them.  With the heads cut over ``model``, q of the rank's heads,
    k and v projected whole (the rank attends with those its heads read)
    and ``wo``'s rows summed, as :func:`attention_train`."""
    B, S = x.shape[:2]
    cut = head_cut(x, cfg)
    q, k, v = _qkv(p, model_copy(x, cut), cfg, cos, sin, rope, cut, whole_kv=True)
    ka, va = (k, v) if cut is None else (rank_kv(k, cut, q.shape[2], cfg),
                                         rank_kv(v, cut, q.shape[2], cfg))
    o = flash_attention(q, ka, va, causal=True)
    return out_proj(p["wo"], o.reshape(B, S, -1), cut), k, v


def cross_attention_train(p, x: torch.Tensor, mem_kv, cfg) -> torch.Tensor:
    """x (B, S, d) attends, without a mask, to the memory's keys and values
    ``mem_kv`` = (k, v), each (B, M, nkv, hd), projected beforehand (whole,
    on every rank, with a mesh installed)."""
    B, S, _ = x.shape
    cut = head_cut(x, cfg)
    nh = cfg.nh_eff if cut is None else cfg.nh_eff // cut.size
    q = linear(p["wq"], model_copy(x, cut)).reshape(B, S, nh, cfg.hd)
    k, v = mem_kv
    if cut is not None:
        k, v = rank_kv(k, cut, nh, cfg), rank_kv(v, cut, nh, cfg)
    o = flash_attention(q, k, v, causal=False)
    return out_proj(p["wo"], o.reshape(B, S, -1), cut)


def attention_decode(p, x: torch.Tensor, cache: dict, pos, cfg, cos, sin,
                     rope: bool = True):
    """One decode step.  cache: ``{"k": (B, S, nkv, hd), "v": ...}``; pos a
    scalar (int or 0-d tensor), the same for the whole batch.

    Writes this step's key and value into slot ``pos`` of the cache in
    place and masks every slot after ``pos``.  Returns (out (B, 1, d),
    the cache).

    While a meshed decode serves (``shard_ctx.serving``), ``cache`` may
    hold a block of the positions (``seq_cut("k")``): the rank that owns
    slot ``pos`` writes it, and each rank attends over its slots
    (:func:`attend_cached`); with the heads cut over ``model``, q of the
    rank's heads is gathered whole first and ``wo``'s rows are summed
    after."""
    cut = head_cut(x, cfg)
    seq = shard_ctx.seq_cut("k")
    if cut is not None or seq is not None:
        return _attention_decode_meshed(p, x, cache, pos, cfg, cos, sin, rope, cut, seq)
    B = x.shape[0]
    hd, nh, nkv = cfg.hd, cfg.nh_eff, cfg.n_kv
    q = linear(p["wq"], x).reshape(B, 1, nh, hd)
    k = linear(p["wk"], x).reshape(B, 1, nkv, hd)
    v = linear(p["wv"], x).reshape(B, 1, nkv, hd)
    if rope:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    ck, cv = cache["k"], cache["v"]
    slot = torch.as_tensor(pos, device=ck.device).reshape(1)
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))
    g = nh // nkv
    S = ck.shape[1]
    qh = (q * hd**-0.5).reshape(B, 1, nkv, g, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qh, ck).float()
    valid = torch.arange(S, device=ck.device) <= slot
    s = s.masked_fill(~valid, float("-inf"))
    pr = torch.softmax(s, dim=-1).to(cv.dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", pr, cv).reshape(B, 1, nh * hd)
    return linear(p["wo"], o), cache


def _attention_decode_meshed(p, x, cache, pos, cfg, cos, sin, rope, cut, seq):
    B = x.shape[0]
    q, k, v = _qkv(p, x, cfg, cos, sin, rope, cut, whole_kv=True)
    ck, cv = cache["k"], cache["v"]
    S_blk = ck.shape[1]
    start = 0 if seq is None else seq.index * S_blk
    pos = torch.as_tensor(pos, device=ck.device)
    # the owner of slot ``pos`` writes it; the others write a slot back as
    # it was (no host sync on ``pos``)
    at = torch.clamp(pos - start, 0, S_blk - 1).reshape(1)
    mine = (pos >= start) & (pos < start + S_blk)
    ck.index_copy_(1, at, torch.where(mine, k.to(ck.dtype), ck.index_select(1, at)))
    cv.index_copy_(1, at, torch.where(mine, v.to(cv.dtype), cv.index_select(1, at)))
    valid = start + torch.arange(S_blk, device=ck.device) <= pos
    o = attend_cached(q, ck, cv, valid, cfg, cut, seq)
    return out_proj(p["wo"], o, cut), cache


def attend_cached(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid, cfg,
                  cut: Cut | None, seq) -> torch.Tensor:
    """One query position ``q`` (B, 1, nh_r, hd) (with ``cut``, the rank's
    heads) against cached keys and values (B, S_blk, nkv, hd), ``valid``
    (S_blk,) the slots it may read (None: all).  Returns the output of the
    heads the rank computes with, (B, 1, nh_r * hd) in ``v``'s dtype.

    With ``cut``, q is gathered over ``model`` (every head, for every key
    head of the slots).  Without ``seq``, the softmax over the slots is
    the reference's decode (f32, cast to ``v``'s dtype before the
    product).  With ``seq`` (a block of the positions, ``shard_ctx.
    SeqCut``), each rank takes its slots' f32 partial max, sum of
    exponentials and product with ``v``; the blocks' partials are gathered
    over ``seq.axes`` and combined by the log-sum-exp in block order, the
    same sums on every rank."""
    B, _, nh_r, hd = q.shape
    if cut is not None:
        q = all_gather(q, cut.group, 2)
    nh, nkv = q.shape[2], k.shape[2]
    g = nh // nkv
    qh = (q * hd**-0.5).reshape(B, 1, nkv, g, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qh, k).float()
    if valid is not None:
        s = s.masked_fill(~valid, float("-inf"))
    if seq is None:
        pr = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bkgqs,bskh->bqkgh", pr, v)
    else:
        m = s.amax(dim=-1, keepdim=True)  # -inf where every slot is masked
        e = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
        part = torch.cat([m, e.sum(dim=-1, keepdim=True),
                          torch.einsum("bkgqs,bskh->bkgqh", e, v.float())], dim=-1)
        parts = shard_ctx.gather_over(part[None], seq.axes, 0)
        top = parts[..., :1].amax(dim=0)  # finite: block 0 holds slot 0
        w = torch.exp(parts[..., :1] - top)
        o = (w * parts[..., 2:]).sum(dim=0) / (w * parts[..., 1:2]).sum(dim=0)
        o = o.to(v.dtype).permute(0, 3, 1, 2, 4)  # (B, 1, nkv, g, hd)
    o = o.reshape(B, 1, nh, hd)
    if cut is not None:
        o = o[:, :, cut.index * nh_r:(cut.index + 1) * nh_r]
    return o.reshape(B, 1, nh_r * hd)


def cross_attention_decode(p, x: torch.Tensor, mem_kv, cfg) -> torch.Tensor:
    """Decode's cross-attention of ``x`` (B, 1, d) to the memory's keys
    and values the cache holds: :func:`cross_attention_train`, or, while
    a meshed decode serves a cache whose memory positions are cut
    (``seq_cut("mem_k")``), the rank's block of them (:func:`attend_cached`)."""
    seq = shard_ctx.seq_cut("mem_k")
    if seq is None:
        return cross_attention_train(p, x, mem_kv, cfg)
    B = x.shape[0]
    cut = head_cut(x, cfg)
    nh = cfg.nh_eff if cut is None else cfg.nh_eff // cut.size
    q = linear(p["wq"], x).reshape(B, 1, nh, cfg.hd)
    o = attend_cached(q, *mem_kv, None, cfg, cut, seq)
    return out_proj(p["wo"], o, cut)


# ---------------------------------------------------------------- MLP


def ffn_cut(x: torch.Tensor, d_ff: int) -> Cut | None:
    """The installed mesh's cut of an MLP's hidden width ``d_ff`` over
    ``model`` (the reference's ``"btf"`` pin), for the input ``x``."""
    return shard_ctx.model_cut("btf", (*x.shape[:-1], d_ff))


def mlp_swiglu(p, x: torch.Tensor, d_ff: int | None = None) -> torch.Tensor:
    """``d_ff``: the whole hidden width, where ``p`` may hold this rank's
    columns of ``wg``/``wu`` and rows of ``wd`` (a mesh installed); None
    takes ``p``'s own."""
    cut = ffn_cut(x, d_ff or p["wg"]["w"].shape[-1])
    x = model_copy(x, cut)
    h = F.silu(linear(p["wg"], x)) * linear(p["wu"], x)
    return out_proj(p["wd"], h, cut)


def mlp_gelu(p, x: torch.Tensor, d_ff: int | None = None) -> torch.Tensor:
    """``wi`` and ``wo`` with their biases around the tanh form of GELU,
    ``jax.nn.gelu``'s default (the erf form differs by up to ~1e-3).
    ``d_ff`` as :func:`mlp_swiglu`'s; cut, the rank has its columns of
    ``wi`` and of its bias and its rows of ``wo``."""
    cut = ffn_cut(x, d_ff or p["wi"]["w"].shape[-1])
    return out_proj(p["wo"], F.gelu(linear(p["wi"], model_copy(x, cut)), approximate="tanh"),
                    cut)


# ---------------------------------------------------------------- MoE


class Routing(NamedTuple):
    """One ``moe_block`` call's routing of ``T`` tokens to ``E`` experts of
    ``capacity`` slots each."""

    probs: torch.Tensor  # (T, E) f32 router softmax
    gate: torch.Tensor  # (T, k) f32, renormalised over the k choices
    eid: torch.Tensor  # (T, k) int64 chosen experts, best first
    onehot: torch.Tensor  # (T * k, E) int32, choice j of token t in row t * k + j
    slot: torch.Tensor  # (T * k,) int64 row of the (E * C, d) buffer; E * C if dropped
    valid: torch.Tensor  # (T * k,) bool: the choice found a free slot
    capacity: int


def moe_route(p, x: torch.Tensor, cfg) -> Routing:
    """Token-choice top-k routing with a static capacity, as the
    reference's ``moe_block`` routes: ``C = max(1, int(capacity_factor *
    k * T / E))`` (``T`` this call's tokens); a choice's rank in its
    expert is the number of earlier choices of that expert in token-major
    order (an exclusive cumsum), and a rank ``>= C`` is dropped.

    ``torch.topk`` leaves the order of tied probabilities unspecified, as
    ``jax.lax.top_k`` does not; a tie at the k-th choice can pick another
    expert than the reference (the parity tests assert a margin first)."""
    T = x.shape[0]
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    C = max(1, int(cfg.moe.capacity_factor * k * T / E))
    logits = (x @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, eid = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_e = eid.reshape(-1)
    onehot = F.one_hot(flat_e, E).to(torch.int32)
    rank = (torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot).gather(
        1, flat_e[:, None])[:, 0]
    valid = rank < C
    slot = torch.where(valid, flat_e * C + rank, E * C)
    return Routing(probs, gate, eid, onehot, slot, valid, C)


def moe_block(p, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE with static capacity (overflow dropped).

    x (T, d) -> (y (T, d), aux): each kept choice's token row is scattered
    into its expert's slot of an ``(E * C, d)`` buffer, the experts'
    SwiGLU runs as batched products in ``x``'s dtype, and each token sums
    its kept choices' outputs weighted by their gates.  ``aux`` is the
    Switch load-balancing term ``E * Σ_e frac_e * mean_prob_e``, f32.

    The reference's single-device path, in plain PyTorch (it computes this
    outside any Pallas kernel).  With a mesh installed (``shard_ctx``) and
    the experts divisible by its data axis, dispatch runs expert-parallel
    over ``all_to_all`` (``moe_ep.py``), under the reference's four
    conditions; ``p`` then holds this rank's experts.  A meshed prefill or
    decode (``shard_ctx.serving``) takes ``moe_ep.moe_block_served``: this
    function's values over every token of the call."""
    from repro_torch.models import shard_ctx as _ctx

    if _ctx.serving() is not None:
        from repro_torch.models.moe_ep import moe_block_served

        return moe_block_served(p, x, cfg)
    if (
        _ctx._MESH is not None
        and _ctx._MODE in ("all", "ep")
        and "data" in _ctx._MESH.axis_names
        and cfg.moe.n_experts % _ctx._MESH.shape["data"] == 0
    ):
        from repro_torch.models.moe_ep import moe_block_ep

        return moe_block_ep(p, x, cfg)
    T, d = x.shape
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    r = moe_route(p, x, cfg)
    C = r.capacity
    xr = x.repeat_interleave(k, dim=0)  # (T * k, d)
    # one spare row takes the dropped choices, as mode="drop" does
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device).index_add(0, r.slot, xr)
    eb = buf[:E * C].reshape(E, C, d)
    h = F.silu(torch.bmm(eb, p["wg"].to(x.dtype))) * torch.bmm(eb, p["wu"].to(x.dtype))
    ob = torch.bmm(h, p["wd"].to(x.dtype)).reshape(E * C, d)
    y = torch.where(r.valid[:, None], ob[r.slot.clamp(max=E * C - 1)], 0.0)
    y = y * r.gate.reshape(-1)[:, None].to(y.dtype)
    y = y.reshape(T, k, d).sum(dim=1)
    frac = (r.onehot > 0).float().mean(dim=0)
    aux = E * torch.sum(frac * r.probs.mean(dim=0))
    return y, aux


# ---------------------------------------------------------------- loss


def _xent_chunk(hc: torch.Tensor, w: torch.Tensor, lc: torch.Tensor) -> torch.Tensor:
    logits = (hc @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None])[..., 0]
    return (lse - gold).sum()


def _xent_chunk_cut(hc: torch.Tensor, w: torch.Tensor, lc: torch.Tensor,
                    cut: Cut) -> torch.Tensor:
    """One chunk's summed cross-entropy from this rank's vocabulary rows
    ``w`` (d, V / model): the logits' max over ``model`` (a constant of
    the gradient: the log-sum-exp does not depend on it), their sum of
    exponentials summed over ``model``, and the gold logit from the rank
    whose rows hold the label (zero from the others)."""
    logits = (hc @ w).float()
    top = all_reduce(logits.detach().amax(dim=-1), cut.group, "max")
    sumexp = model_sum(torch.exp(logits - top[..., None]).sum(dim=-1), cut)
    at = lc - cut.index * w.shape[-1]
    mine = (at >= 0) & (at < w.shape[-1])
    gold = torch.gather(logits, -1, torch.where(mine, at, 0)[..., None])[..., 0]
    gold = model_sum(torch.where(mine, gold, 0.0), cut)
    return (top + torch.log(sumexp) - gold).sum()


def chunked_softmax_xent(h: torch.Tensor, w_head: torch.Tensor, labels: torch.Tensor,
                         chunk: int = 512, vocab: int | None = None) -> torch.Tensor:
    """Mean cross-entropy over a large vocabulary without the whole
    (B, S, V) logits: f32 logits one ``chunk`` of positions at a time.

    h (B, S, d), w_head (d, V), labels (B, S) int -> f32 scalar.  Under
    autograd each chunk's logits are recomputed in the backward instead
    of kept (a chunk of 4 x 512 positions over 151,936 tokens is 1.2 GB
    in f32).  ``vocab``: the whole vocabulary, where ``w_head`` may be this
    rank's columns (a mesh installed, the ``"btf"`` pin cutting ``V``);
    None takes ``w_head``'s own."""
    B, S, d = h.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {chunk}")
    cut = shard_ctx.model_cut("btf", (B, chunk, vocab or w_head.shape[-1]))
    h = model_copy(h, cut)
    w = w_head.to(h.dtype)
    labels = labels.long()
    fn, extra = (_xent_chunk, ()) if cut is None else (_xent_chunk_cut, (cut,))
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(S // chunk):
        hc, lc = h[:, c * chunk:(c + 1) * chunk], labels[:, c * chunk:(c + 1) * chunk]
        if torch.is_grad_enabled():
            part = checkpoint(fn, hc, w, lc, *extra, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            part = fn(hc, w, lc, *extra)
        tot = tot + part
    return tot / (B * S)
