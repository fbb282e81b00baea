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
GSPMD; the port's meshed train step lays them out by construction, so
its ``shard_ctx.constrain`` is the identity and the call sites are left
out (``models/shard_ctx.py``).
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


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
        sec_id = torch.repeat_interleave(torch.arange(len(sections)), torch.tensor(sections))
        ang = pos.float()[..., sec_id.to(pos.device)] * freqs  # (..., S, half)
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


def _qkv(p, x: torch.Tensor, cfg, cos, sin, rope: bool = True):
    B, S, _ = x.shape
    hd, nh, nkv = cfg.hd, cfg.nh_eff, cfg.n_kv
    q = linear(p["wq"], x).reshape(B, S, nh, hd)
    k = linear(p["wk"], x).reshape(B, S, nkv, hd)
    v = linear(p["wv"], x).reshape(B, S, nkv, hd)
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


def attention_train(p, x: torch.Tensor, cfg, cos, sin, rope: bool = True,
                    causal: bool = True) -> torch.Tensor:
    q, k, v = _qkv(p, x, cfg, cos, sin, rope)
    o = flash_attention(q, k, v, causal=causal)
    B, S = x.shape[:2]
    return linear(p["wo"], o.reshape(B, S, -1))


def cross_attention_train(p, x: torch.Tensor, mem_kv, cfg) -> torch.Tensor:
    """x (B, S, d) attends, without a mask, to the memory's keys and values
    ``mem_kv`` = (k, v), each (B, M, nkv, hd), projected beforehand."""
    B, S, _ = x.shape
    q = linear(p["wq"], x).reshape(B, S, cfg.nh_eff, cfg.hd)
    k, v = mem_kv
    o = flash_attention(q, k, v, causal=False)
    return linear(p["wo"], o.reshape(B, S, -1))


def attention_decode(p, x: torch.Tensor, cache: dict, pos, cfg, cos, sin,
                     rope: bool = True):
    """One decode step.  cache: ``{"k": (B, S, nkv, hd), "v": ...}``; pos a
    scalar (int or 0-d tensor), the same for the whole batch.

    Writes this step's key and value into slot ``pos`` of the cache in
    place and masks every slot after ``pos``.  Returns (out (B, 1, d),
    the cache)."""
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


# ---------------------------------------------------------------- MLP


def mlp_swiglu(p, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(linear(p["wg"], x)) * linear(p["wu"], x)
    return linear(p["wd"], h)


def mlp_gelu(p, x: torch.Tensor) -> torch.Tensor:
    """``wi`` and ``wo`` with their biases around the tanh form of GELU,
    ``jax.nn.gelu``'s default (the erf form differs by up to ~1e-3)."""
    return linear(p["wo"], F.gelu(linear(p["wi"], x), approximate="tanh"))


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
    conditions; ``p`` then holds this rank's experts."""
    from repro_torch.models import shard_ctx as _ctx

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


def chunked_softmax_xent(h: torch.Tensor, w_head: torch.Tensor, labels: torch.Tensor,
                         chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy over a large vocabulary without the whole
    (B, S, V) logits: f32 logits one ``chunk`` of positions at a time.

    h (B, S, d), w_head (d, V), labels (B, S) int -> f32 scalar.  Under
    autograd each chunk's logits are recomputed in the backward instead
    of kept (a chunk of 4 x 512 positions over 151,936 tokens is 1.2 GB
    in f32)."""
    B, S, d = h.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {chunk}")
    w = w_head.to(h.dtype)
    labels = labels.long()
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(S // chunk):
        hc, lc = h[:, c * chunk:(c + 1) * chunk], labels[:, c * chunk:(c + 1) * chunk]
        if torch.is_grad_enabled():
            part = checkpoint(_xent_chunk, hc, w, lc, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            part = _xent_chunk(hc, w, lc)
        tot = tot + part
    return tot / (B * S)
