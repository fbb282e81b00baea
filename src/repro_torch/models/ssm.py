"""Attention-free sequence mixers: RWKV6 (Finch) and Mamba2 (SSD).

Port of the JAX package's ``models/ssm.py`` as plain functions on
tensors, in the style of ``models/layers.py``: ``p`` is one layer's slice
of the model's stacked parameters.  Both mixers are linear recurrences
computed by the chunked-parallel algorithm: matmuls within a chunk of
``cfg.ssm.chunk`` positions, then a state carried from chunk to chunk.
Decode runs the same code on one position (a chunk of 1).

Where this differs from the reference, on purpose:

* the terms within a chunk do not depend on the carried state, so they
  are computed for all chunks at once; only the state carry (one multiply
  and one add per chunk) runs chunk after chunk, where the reference's
  ``lax.scan`` runs the whole chunk body serially.  The same products,
  summed in another grouping: values agree to f32 rounding;
* Mamba2 masks the decay exponent before the ``exp`` (``where(s <= t,
  ca_t - ca_s, -inf)``).  The reference takes ``exp(ca_t - ca_s)`` for
  every pair and masks the product after (``ssm.py:216-220``): for
  ``s > t`` the exponent is a positive sum of ``dt`` that passes
  ln(f32 max) within a chunk of 128 at zamba2-2.7b's width, and the
  ``exp`` backward then multiplies the masked zero cotangent by inf.
  The forward values are the reference's wherever those are finite; the
  gradients stay finite;
* the recurrences' f32 products run in full FP32 (``full_fp32_matmul``),
  as the reference computes them on the CPU; the caller's TF32 setting
  is restored after each.  Their backward runs under the caller's
  setting: ``launch/train.py``'s step runs it inside the same guard.

The JAX package promotes a bf16 x f32 product to f32; torch refuses a
mixed product, so every such operand is cast to what JAX computes.  Masks
are selects (``torch.where``), never a multiply: a multiply by a zero
mask turns an overflowed inf into NaN.

With a mesh installed (``models/shard_ctx.py``) the mixers split their
heads over ``model`` where the axis divides them (the reference has no
pin in this module; its parameter rules cut the projections' head
columns over ``model``, ``launch/sharding.py:57-60``, and ``cache_spec``
the recurrent states' heads, ``:121-146``), Megatron-style between
``model_copy`` and ``model_sum``, ``p`` then holding the blocks the
meshed step hands over (``launch/train.py:leaf_layouts``):

* RWKV6's time mix: r, k, v, g and the decay of the rank's heads from its
  columns of ``wr``, ``wk``, ``wv``, ``wg``, ``w0`` and ``wb`` (``mu``
  and ``wa`` whole), ``u`` of its heads, the recurrence on its heads (no
  collective: heads are independent), ``gn`` whole (per head), and the
  rank's rows of ``wo`` summed over ``model``;
* RWKV6's channel mix: the rank's ffn columns of ``cmix.wk`` and rows of
  ``cmix.wv``, summed over ``model``, gated by ``sigmoid(wr · xr)``
  computed whole on every rank;
* Mamba2: z, x and dt of the rank's heads and B and C whole from its
  selection of ``in_proj``'s columns ``[z | x | B | C | dt]``, the
  depthwise conv on its x channels and all of B's and C's, ``dt_bias``,
  ``A_log`` and ``D`` of its heads, ``gn`` whole, and its rows of
  ``out_proj`` summed over ``model``.  The conv carry a serving cache
  holds stays whole on every rank: :func:`conv_block` selects the rank's
  channels of it, :func:`conv_whole` gathers them back.

Where the axis does not divide the heads, a mixer runs whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.torch_engine import full_fp32_matmul
from repro_torch.launch.mesh import all_gather
from repro_torch.models import shard_ctx
from repro_torch.models.layers import linear, out_proj, rmsnorm
from repro_torch.models.shard_ctx import Cut, model_copy


def heads_cut(x: torch.Tensor, nh: int, hd: int) -> Cut | None:
    """The installed mesh's cut of a mixer's ``nh`` heads of ``hd`` over
    ``model``, for its input ``x`` (B, S, d): the ``"bthd"`` pin's rule."""
    return shard_ctx.model_cut("bthd", (*x.shape[:2], nh, hd))


def _chunks(S: int, chunk: int) -> tuple[int, int]:
    """(chunk, number of chunks): ``chunk`` is cut to ``S``, and ``S``
    must be a whole number of chunks, as the reference asserts."""
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {chunk}")
    return chunk, S // chunk


def _carry(S0: torch.Tensor, decay: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """The state at the start of every chunk: ``S_{c+1} = S_c * decay_c +
    local_c`` from ``S0`` (B, ...); ``decay`` broadcasts against ``local``
    (B, nc, ...).  Returns (B, nc + 1, ...): entry ``c`` enters chunk
    ``c``, the last one leaves the sequence."""
    states = [S0]
    for c in range(local.shape[1]):
        states.append(states[-1] * decay[:, c] + local[:, c])
    return torch.stack(states, dim=1)


# ---------------------------------------------------------------- RWKV6


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor | None) -> torch.Tensor:
    """Shift right by one along S; the first position mixes with
    ``x_prev`` (B, d), zeros when None."""
    pad = x_prev[:, None, :] if x_prev is not None else torch.zeros_like(x[:, :1])
    return torch.cat([pad, x[:, :-1]], dim=1)


def _rwkv6_rkvwg(p, x: torch.Tensor, x_prev, cfg, cut: Cut | None = None):
    """r, k, v, the log decay w and g of ``x``; with ``cut``, of this rank's
    heads (``p`` holding their columns)."""
    B, S, d = x.shape
    nh, hd = cfg.n_heads // (cut.size if cut else 1), cfg.hd
    xs = _token_shift(x, x_prev)
    mu = p["mu"].to(x.dtype)
    feats = [x + (xs - x) * mu[i] for i in range(5)]
    r = linear(p["wr"], feats[0]).reshape(B, S, nh, hd)
    k = linear(p["wk"], feats[1]).reshape(B, S, nh, hd)
    v = linear(p["wv"], feats[2]).reshape(B, S, nh, hd)
    # data-dependent per-channel decay (Finch): w = exp(-exp(w0 + lora)),
    # the low-rank product in f32 (the reference promotes bf16 x f32)
    with full_fp32_matmul():
        wlog = p["w0"] + (feats[3].float() @ p["wa"]) @ p["wb"]
    w = -torch.exp(torch.clamp(wlog, -12.0, 1.0))  # log decay < 0
    # clamped so chunk * |w| stays below f32 exp overflow (see wkv6_chunked)
    w = torch.clamp(w, -5.0, -1e-5).reshape(B, S, nh, hd)
    g = F.silu(linear(p["wg"], feats[4])).reshape(B, S, nh, hd)
    return r, k, v, w, g


def wkv6_chunked(r, k, v, w, u, state, chunk: int):
    """Chunked linear recurrence.  r, k, v, w (B, S, nh, hd); w the
    per-channel log decay (< 0); u the current-token bonus (nh, hd);
    state (B, nh, hd, hd) [k-dim x v-dim].  Returns (y in r's dtype, the
    f32 state after the last position)."""
    B, S, nh, hd = r.shape
    chunk, nc = _chunks(S, chunk)

    def split(t):
        return t.float().reshape(B, nc, chunk, nh, hd)

    rc, kc, vc, wc = split(r), split(k), split(v), split(w)
    with full_fp32_matmul():
        cw = torch.cumsum(wc, dim=2)  # inclusive cumulative log decay
        cw_prev = cw - wc  # exclusive (the decay applied before step t)
        r_dec = rc * torch.exp(cw_prev)  # r_t * prod_{s<t} decay
        k_dec = kc * torch.exp(-cw)  # k_s / prod_{s'<=s} decay
        # intra-chunk scores, s < t strictly
        scores = torch.einsum("bctnh,bcsnh->bcnts", r_dec, k_dec)
        mask = torch.ones((chunk, chunk), dtype=torch.bool, device=r.device).tril(-1)
        scores = torch.where(mask, scores, 0.0)
        y = torch.einsum("bcnts,bcsnh->bctnh", scores, vc)
        # current-token bonus: y_t += (r_t . (u * k_t)) v_t
        y = y + (rc * kc * u).sum(-1, keepdim=True) * vc
        # the state entering each chunk, then its contribution
        decay_to_end = torch.exp(cw[:, :, -1:] - cw)  # k-dim decay to the chunk's end
        local = torch.einsum("bctnk,bctnh->bcnkh", kc * decay_to_end, vc)
        states = _carry(state.float(), torch.exp(cw[:, :, -1])[..., None], local)
        y = y + torch.einsum("bctnk,bcnkh->bctnh", r_dec, states[:, :-1])
    return y.reshape(B, S, nh, hd).to(r.dtype), states[:, -1]


def rwkv6_block(p, x: torch.Tensor, cfg, state: dict | None = None):
    """The full block: time-mix, then channel-mix.  ``state``: a dict with
    ``"wkv"`` (B, nh, hd, hd) and the shift carries ``"x_tm"``, ``"x_cm"``
    (B, d); None for training (zeros: the sequence starts at position
    0).  Returns (x, the state after the last position).  With the heads
    cut over ``model``, ``"wkv"`` holds this rank's heads."""
    B, S, d = x.shape
    cut = heads_cut(x, cfg.n_heads, cfg.hd)
    nh, hd = cfg.n_heads // (cut.size if cut else 1), cfg.hd
    st = state or {"wkv": torch.zeros((B, nh, hd, hd), dtype=torch.float32, device=x.device),
                   "x_tm": None, "x_cm": None}
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    r, k, v, w, g = _rwkv6_rkvwg(p["mix"], model_copy(h, cut), st["x_tm"], cfg, cut)
    u = p["mix"]["u"].float()
    y, wkv = wkv6_chunked(r, k, v, w, u, st["wkv"], cfg.ssm.chunk if cfg.ssm else 128)
    y = rmsnorm(p["mix"]["gn"], y, cfg.norm_eps) * g
    x = x + out_proj(p["mix"]["wo"], y.reshape(B, S, nh * hd), cut)

    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    hs = _token_shift(h2, st["x_cm"])
    mu = p["cmix"]["mu"].to(x.dtype)
    xk = h2 + (hs - h2) * mu[0]
    xr = h2 + (hs - h2) * mu[1]
    ffn = shard_ctx.model_cut("btf", (B, S, cfg.d_ff))
    kk = torch.square(F.relu(linear(p["cmix"]["wk"], model_copy(xk, ffn))))
    out = torch.sigmoid(linear(p["cmix"]["wr"], xr)) * out_proj(p["cmix"]["wv"], kk, ffn)
    x = x + out
    return x, {"wkv": wkv, "x_tm": h[:, -1], "x_cm": h2[:, -1]}


# ---------------------------------------------------------------- Mamba2


def mamba2_dims(cfg) -> tuple[int, int, int]:
    """(inner width, SSD heads, head width) of ``cfg``'s Mamba2 layers."""
    inner = cfg.ssm.expand * cfg.d_model
    nh = cfg.ssm.n_heads or max(1, inner // 64)
    return inner, nh, inner // nh


def _causal_conv(x: torch.Tensor, w: torch.Tensor, carry: torch.Tensor | None = None):
    """Depthwise causal conv, kernel K: y_t = sum_i w_i x_{t-K+1+i}, summed
    in ``x``'s dtype in the reference's order.  ``carry`` (B, K-1, C)
    holds the previous tokens for decode.  Returns (silu(y), the carry
    after the last position)."""
    K = w.shape[0]
    pad = carry if carry is not None else x.new_zeros((x.shape[0], K - 1) + x.shape[2:])
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    return F.silu(y), xp[:, -(K - 1):]


def mamba2_mix(p, h: torch.Tensor, cfg, state: dict):
    """The SSD core on the pre-normed input h (B, S, d).  ``state``: a
    dict that may hold ``"ssm"`` (B, nh, hd, N) and ``"conv"`` (B, K-1,
    inner + 2N).  Returns (out (B, S, d), the state after the last
    position).  With the heads cut over ``model``, ``p`` holds this rank's
    blocks, and ``"ssm"`` and ``"conv"`` its heads and its channels
    (:func:`conv_block`)."""
    B, S, d = h.shape
    inner, nh, hd = mamba2_dims(cfg)
    N = cfg.ssm.d_state
    cut = mamba2_cut(h, cfg)
    if cut is not None:
        nh //= cut.size
        inner = nh * hd

    zxbcdt = linear(p["in_proj"], model_copy(h, cut))
    z, xbc, dt = torch.split(zxbcdt, [inner, inner + 2 * N, nh], dim=-1)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], state.get("conv"))
    x, Bm, Cm = torch.split(xbc, [inner, N, N], dim=-1)
    x = x.reshape(B, S, nh, hd)
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, S, nh)
    A = -torch.exp(p["A_log"])  # (nh,) negative
    loga = dt * A  # (B, S, nh) log decay per head
    xdt = x.float() * dt[..., None]

    chunk, nc = _chunks(S, cfg.ssm.chunk)

    def split(t):
        return t.reshape((B, nc, chunk) + t.shape[2:])

    xc, bc, cc, lc = split(xdt), split(Bm.float()), split(Cm.float()), split(loga)
    S0 = state.get("ssm")
    if S0 is None:
        S0 = torch.zeros((B, nh, hd, N), dtype=torch.float32, device=h.device)
    with full_fp32_matmul():
        ca = torch.cumsum(lc, dim=2)  # (B, nc, C, nh)
        # intra-chunk: y_t = sum_{s<=t} (C_t . B_s) exp(ca_t - ca_s) x_s dt_s,
        # the exponent masked before the exp (see the module docstring)
        cat = ca.transpose(2, 3)  # (B, nc, nh, C)
        mask = torch.ones((chunk, chunk), dtype=torch.bool, device=h.device).tril()
        gap = torch.where(mask, cat[..., :, None] - cat[..., None, :], float("-inf"))
        cb = torch.einsum("bctn,bcsn->bcts", cc, bc)
        scores = cb[:, :, None] * torch.exp(gap)  # (B, nc, nh, t, s)
        y = torch.einsum("bchts,bcshd->bcthd", scores, xc)
        # the state entering each chunk, decayed from the chunk's start to t
        local = torch.einsum("bcthd,bctn->bchdn",
                             xc * torch.exp(ca[:, :, -1:] - ca)[..., None], bc)
        states = _carry(S0.float(), torch.exp(ca[:, :, -1])[..., None, None], local)
        cross = torch.einsum("bctn,bchdn->bcthd", cc, states[:, :-1])
        y = y + cross * torch.exp(ca)[..., None]
    y = y.reshape(B, S, nh, hd)
    y = y + p["D"][None, None, :, None] * x.float()
    y = rmsnorm(p["gn"], y.to(h.dtype), cfg.norm_eps)
    y = (y * F.silu(z).reshape(B, S, nh, hd)).reshape(B, S, inner)
    out = out_proj(p["out_proj"], y, cut)
    return out, {"ssm": states[:, -1], "conv": conv_state}


def mamba2_cut(x: torch.Tensor, cfg) -> Cut | None:
    """The installed mesh's cut of the Mamba2 heads over ``model`` for the
    input ``x`` (B, S, d)."""
    _, nh, hd = mamba2_dims(cfg)
    return heads_cut(x, nh, hd)


def conv_block(carry: torch.Tensor, cfg, cut: Cut | None) -> torch.Tensor:
    """This rank's channels ``[x | B | C]`` of a whole conv carry (B, K-1,
    inner + 2N): its heads' x channels and all of B's and C's."""
    if cut is None:
        return carry
    inner = mamba2_dims(cfg)[0]
    size = inner // cut.size
    return torch.cat([carry[..., cut.index * size:(cut.index + 1) * size],
                      carry[..., inner:]], dim=-1)


def conv_whole(carry: torch.Tensor, cfg, cut: Cut | None) -> torch.Tensor:
    """The whole conv carry from this rank's channels (:func:`conv_block`'s
    inverse): the x channels gathered over ``model``, B's and C's (alike on
    every rank) its own."""
    if cut is None:
        return carry
    size = mamba2_dims(cfg)[0] // cut.size
    return torch.cat([all_gather(carry[..., :size], cut.group, carry.dim() - 1),
                      carry[..., size:]], dim=-1)


def mamba2_block(p, x: torch.Tensor, cfg, state: dict | None = None):
    """Pre-norm residual Mamba2 layer; ``state`` as for ``mamba2_mix``
    (None or empty for training).  Returns (x, the state)."""
    out, new_state = mamba2_mix(p, rmsnorm(p["ln"], x, cfg.norm_eps), cfg, state or {})
    return x + out, new_state
