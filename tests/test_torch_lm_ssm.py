"""The port's recurrent families (``repro_torch.models.ssm``, the ``ssm``
and ``hybrid`` branches of ``models/model.py``) against the JAX package's,
on the CPU.

The same inputs, drawn with numpy from a seed, go through both packages;
model parameters come from the reference's ``Model.init`` and cross with
``convert.from_numpy``.  The bounds are ``tests/test_torch_lm_model.py``'s:
f32 values within ``F32_RTOL`` relative (with an absolute floor of
``F32_RTOL`` x the largest value), gradients within ``GRAD_RTOL``, bf16
activations within the reference's own bound (rtol = atol = 0.15) and
losses within ``BF16_LOSS_RTOL``.

The port computes a layer's within-chunk terms for all chunks at once and
carries only the state chunk by chunk (the reference scans whole chunks),
and it masks Mamba2's decay exponent before the ``exp``: where the
reference's gradients are finite the two agree to the bounds above, and
where a chunk's ``dt`` sum passes ln(f32 max) only the port's stay finite
(``test_mamba2_gradient_stays_finite_where_the_reference_overflows``).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import train as j_train
from repro.models import layers as j_layers
from repro.models import model as j_model
from repro.models import ssm as j_ssm
from repro.train import checkpoint as j_checkpoint
from repro.train import optimizer as j_opt
from repro.train.pipeline import DataPipeline as JPipeline
from repro.train.pipeline import PipelineConfig as JPipelineConfig
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.models import convert, ssm
from repro_torch.models import model as t_model
from repro_torch.train import optimizer as t_opt
from repro_torch.train.checkpoint import Checkpointer

F32_RTOL = 1e-5
GRAD_RTOL = 1e-4
BF16_RTOL = BF16_ATOL = 0.15  # the reference's bound for bf16 activations
BF16_LOSS_RTOL = 2e-2  # about five bf16 roundings (2**-8 each) of the loss
UPD_RTOL = 1e-4
ARCHS = ["rwkv6-3b", "zamba2-2.7b"]
B = 2
# a whole number of chunks of both reduced configs (16 and 32), 2 of zamba2's
S = 64
STATES = ("wkv", "ssm")  # the f32 recurrent states of a cache
LN_F32_MAX = float(np.log(np.finfo(np.float32).max))  # 88.72


@pytest.fixture(params=["f32", "bf16"])
def mode(request, monkeypatch):
    if request.param == "f32":
        monkeypatch.setattr(j_model, "ACT_DTYPE", jnp.float32)
        monkeypatch.setattr(t_model, "ACT_DTYPE", torch.float32)
    return request.param


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(j_model, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(t_model, "ACT_DTYPE", torch.float32)


def _dtypes(mode):
    return (jnp.float32, torch.float32) if mode == "f32" else (jnp.bfloat16, torch.bfloat16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _both(a: np.ndarray, mode):
    jd, td = _dtypes(mode)
    return jnp.asarray(a, jd), torch.tensor(a).to(td)


def _close(got, want, mode, rtol=F32_RTOL, state=False):
    """f32: within ``rtol`` (absolute floor ``rtol`` x the largest value);
    bf16: within the reference's bound.  A recurrent ``state`` is an f32
    sum over the prompt of products of bf16 activations, not of size 1 as
    activations and logits are (rms 0.011 for the reduced zamba2's SSD
    state): its bf16 absolute floor is
    ``BF16_ATOL`` x its largest element, as the f32 floor is ``rtol`` x
    the largest."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if mode == "f32":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())
    else:
        floor = float(np.abs(want).max()) if state else 1.0
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL * floor)


def _reference(arch: str, seed: int):
    """(reference config, its parameters as numpy, the port's model
    holding them), reduced."""
    jcfg = j_get_config(arch, reduced=True)
    params = jax.tree.map(np.asarray, j_model.get_model(jcfg).init(jax.random.PRNGKey(seed)))
    model = t_model.get_model(get_config(arch, reduced=True), device="cpu")
    model.load_state_dict(convert.from_numpy(model.cfg, params))
    return jcfg, params, model


def _tokens(vocab: int, seed: int, b=B, s=S) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _layer(params, *index) -> dict:
    """One layer's slice of the reference's stacked parameters (numpy)."""
    return jax.tree.map(lambda a: a[index], params["layers"])


def _torch_tree(tree) -> dict:
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.tensor(np.asarray(v))
            for k, v in tree.items()}


# ---------------------------------------------------------------- RWKV6


def _wkv_inputs(seed: int, b=B, s=64, nh=2, hd=16):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, nh, hd)).astype(np.float32) for _ in "rkv")
    # log decays over the reference's clamp range [-5, -1e-5]
    w = -np.exp(rng.uniform(-12.0, np.log(5.0), size=(b, s, nh, hd))).astype(np.float32)
    u = rng.normal(size=(nh, hd)).astype(np.float32) * 0.5
    state = rng.normal(size=(b, nh, hd, hd)).astype(np.float32)
    return r, k, v, w, u, state


def test_wkv6_chunked(mode):
    """Four chunks of 16 from a nonzero state: outputs and the final state."""
    r, k, v, w, u, state = _wkv_inputs(0)
    (jr, tr), (jk, tk), (jv, tv) = _both(r, mode), _both(k, mode), _both(v, mode)
    want_y, want_s = j_ssm.wkv6_chunked(jr, jk, jv, jnp.asarray(w), jnp.asarray(u),
                                        jnp.asarray(state), 16)
    got_y, got_s = ssm.wkv6_chunked(tr, tk, tv, torch.tensor(w), torch.tensor(u),
                                    torch.tensor(state), 16)
    assert got_y.dtype == tr.dtype and got_s.dtype == torch.float32
    _close(got_y, want_y, mode)
    _close(got_s, want_s, mode, state=True)


def test_wkv6_chunked_gradients():
    """f32 gradients of a weighted sum of the outputs and the final state
    to every input."""
    r, k, v, w, u, state = _wkv_inputs(1, s=48)
    rng = np.random.default_rng(2)
    wy = rng.normal(size=r.shape).astype(np.float32)
    ws = rng.normal(size=state.shape).astype(np.float32)

    def j_obj(*a):
        y, s_ = j_ssm.wkv6_chunked(*a, 16)
        return jnp.sum(y * wy) + jnp.sum(s_ * ws)

    want = jax.grad(j_obj, argnums=tuple(range(6)))(*map(jnp.asarray, (r, k, v, w, u, state)))
    ts = [torch.tensor(a, requires_grad=True) for a in (r, k, v, w, u, state)]
    y, s_ = ssm.wkv6_chunked(*ts, 16)
    ((y * torch.tensor(wy)).sum() + (s_ * torch.tensor(ws)).sum()).backward()
    for t, ref in zip(ts, want):
        _close(t.grad, ref, "f32", GRAD_RTOL)


@pytest.mark.parametrize("carried", [False, True], ids=["from-zero", "carried-state"])
def test_rwkv6_block(carried, mode):
    cfg = get_config("rwkv6-3b", reduced=True)
    jcfg, params, _ = _reference("rwkv6-3b", 1)
    lp = _layer(params, 1)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, 32, cfg.d_model)).astype(np.float32)
    jx, tx = _both(x, mode)
    jst = tst = None
    if carried:
        nh, hd, d = cfg.n_heads, cfg.hd, cfg.d_model
        wkv = rng.normal(size=(B, nh, hd, hd)).astype(np.float32)
        xtm, xcm = (rng.normal(size=(B, d)).astype(np.float32) for _ in "tc")
        (jtm, ttm), (jcm, tcm) = _both(xtm, mode), _both(xcm, mode)
        jst = {"wkv": jnp.asarray(wkv), "x_tm": jtm, "x_cm": jcm}
        tst = {"wkv": torch.tensor(wkv), "x_tm": ttm, "x_cm": tcm}
    want, wst = j_ssm.rwkv6_block(jax.tree.map(jnp.asarray, lp), jx, jcfg, jst)
    got, gst = ssm.rwkv6_block(_torch_tree(lp), tx, cfg, tst)
    assert got.dtype == tx.dtype
    _close(got, want, mode)
    for key in ("wkv", "x_tm", "x_cm"):
        assert gst[key].dtype == (torch.float32 if key == "wkv" else tx.dtype)
        _close(gst[key], wst[key], mode, state=key == "wkv")


def test_token_shift():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    prev = -np.ones((2, 4), np.float32)
    for p in (None, prev):
        want = j_ssm._token_shift(jnp.asarray(x), None if p is None else jnp.asarray(p))
        got = ssm._token_shift(torch.tensor(x), None if p is None else torch.tensor(p))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- Mamba2


@pytest.mark.parametrize("carried", [False, True], ids=["zero-pad", "carry"])
def test_causal_conv(carried, mode):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, 10, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    carry = rng.normal(size=(B, 3, 24)).astype(np.float32) if carried else None
    jx, tx = _both(x, mode)
    jc, tc = _both(carry, mode) if carried else (None, None)
    want, wcarry = j_ssm._causal_conv(jx, jnp.asarray(w), jc)
    got, gcarry = ssm._causal_conv(tx, torch.tensor(w), tc)
    assert got.dtype == tx.dtype and gcarry.dtype == tx.dtype
    _close(got, want, mode)
    np.testing.assert_array_equal(_np(gcarry), _np(wcarry))  # a slice, no arithmetic


def _mamba_case(seed: int, s: int):
    """The reduced zamba2 config, a layer of the reference's parameters
    with normal A_log, D and dt_bias (init leaves them constant), and x."""
    cfg = get_config("zamba2-2.7b", reduced=True)
    jcfg, params, _ = _reference("zamba2-2.7b", seed)
    lp = _layer(params, 1, 2)
    rng = np.random.default_rng(seed)
    nh = lp["A_log"].shape[0]
    lp.update(A_log=rng.normal(size=nh).astype(np.float32) * 0.5,
              D=rng.normal(size=nh).astype(np.float32),
              dt_bias=rng.normal(size=nh).astype(np.float32) * 0.5)
    x = rng.normal(size=(B, s, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, lp, x


@pytest.mark.parametrize("carried", [False, True], ids=["from-zero", "carried-state"])
def test_mamba2_mix(carried, mode):
    """Three chunks of 32, from zero or from a carried SSD state and conv
    carry: the output and both parts of the state."""
    cfg, jcfg, lp, h = _mamba_case(5, 96)
    inner, nh, hd = ssm.mamba2_dims(cfg)
    rng = np.random.default_rng(6)
    jh, th = _both(h, mode)
    jst, tst = {}, {}
    if carried:
        s0 = rng.normal(size=(B, nh, hd, cfg.ssm.d_state)).astype(np.float32)
        conv = rng.normal(size=(B, cfg.ssm.conv_kernel - 1,
                                inner + 2 * cfg.ssm.d_state)).astype(np.float32)
        jc, tc = _both(conv, mode)
        jst, tst = {"ssm": jnp.asarray(s0), "conv": jc}, {"ssm": torch.tensor(s0), "conv": tc}
    want, wst = j_ssm.mamba2_mix(jax.tree.map(jnp.asarray, lp), jh, jcfg, jst)
    got, gst = ssm.mamba2_mix(_torch_tree(lp), th, cfg, tst)
    assert got.dtype == th.dtype and gst["ssm"].dtype == torch.float32
    _close(got, want, mode)
    _close(gst["ssm"], wst["ssm"], mode, state=True)
    _close(gst["conv"], wst["conv"], mode)


def test_mamba2_block_gradients():
    """f32 gradients of a weighted sum of the block's output to its input
    and every parameter, over two chunks."""
    cfg, jcfg, lp, x = _mamba_case(7, 64)
    wy = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)

    def j_obj(p_, x_):
        return jnp.sum(j_ssm.mamba2_block(p_, x_, jcfg)[0] * wy)

    wp, wx = jax.grad(j_obj, argnums=(0, 1))(jax.tree.map(jnp.asarray, lp), jnp.asarray(x))
    tp = _torch_tree(lp)
    leaves = convert.flat(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    (ssm.mamba2_block(tp, tx, cfg)[0] * torch.tensor(wy)).sum().backward()
    _close(tx.grad, wx, "f32", GRAD_RTOL)
    for name, ref in convert.flat(jax.tree.map(np.asarray, wp)).items():
        _close(leaves[name].grad, ref, "f32", GRAD_RTOL)


def test_mamba2_gradient_stays_finite_where_the_reference_overflows():
    """A reduced zamba2 layer with the published chunk of 128 and
    ``dt_bias`` raised so that a chunk's ``dt`` sum passes ln(f32 max):
    the reference's forward is finite and its gradient is not (the ``exp``
    backward of the masked pairs, ``ssm.py:216-220``); the port's forward
    equals it and the port's gradient is finite."""
    cfg = get_config("zamba2-2.7b", reduced=True)
    cfg = cfg.scaled(ssm=dataclasses.replace(cfg.ssm, chunk=128))
    jcfg = j_get_config("zamba2-2.7b", reduced=True)
    jcfg = jcfg.scaled(ssm=dataclasses.replace(jcfg.ssm, chunk=128))
    lp = jax.tree.map(np.asarray, j_ssm.init_mamba2_block(jax.random.PRNGKey(0), jcfg))
    lp["dt_bias"] = np.full_like(lp["dt_bias"], 1.0)
    x = np.random.default_rng(9).normal(size=(1, 128, cfg.d_model)).astype(np.float32)
    wy = np.random.default_rng(10).normal(size=x.shape).astype(np.float32)
    # the hazard is there: the largest per-head dt sum within the chunk
    inner, nh, _ = ssm.mamba2_dims(cfg)
    hn = np.asarray(j_layers.rmsnorm(jax.tree.map(jnp.asarray, lp["ln"]), jnp.asarray(x),
                                     cfg.norm_eps))
    dt_raw = (hn @ lp["in_proj"]["w"])[..., -nh:]
    dt = np.asarray(jax.nn.softplus(jnp.asarray(dt_raw) + lp["dt_bias"]))
    assert dt.sum(axis=1).max() > LN_F32_MAX

    def j_obj(p_):
        return jnp.sum(j_ssm.mamba2_block(p_, jnp.asarray(x), jcfg)[0] * wy)

    want_y = j_ssm.mamba2_block(jax.tree.map(jnp.asarray, lp), jnp.asarray(x), jcfg)[0]
    want_g = jax.grad(j_obj)(jax.tree.map(jnp.asarray, lp))
    assert bool(np.isfinite(np.asarray(want_y)).all())
    ref_finite = [bool(np.isfinite(np.asarray(g)).all()) for g in jax.tree.leaves(want_g)]
    assert not all(ref_finite), "the reference's gradient is finite: no overflow exercised"

    tp = _torch_tree(lp)
    leaves = convert.flat(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    got_y = ssm.mamba2_block(tp, torch.tensor(x), cfg)[0]
    _close(got_y, want_y, "f32")
    (got_y * torch.tensor(wy)).sum().backward()
    for name, t in leaves.items():
        assert bool(torch.isfinite(t.grad).all()), name
        assert float(t.grad.abs().max()) > 0, name


def test_the_reference_overflows_at_full_width():
    """One ``mamba2_block`` of zamba2-2.7b's published config (chunk 128,
    ``init_mamba2_block(PRNGKey(0))``, x ~ N(0, 1) of shape (1, 128,
    2,560) from ``PRNGKey(1)``): its largest per-head ``dt`` sum within
    the chunk, 120.6, passes ln(f32 max); the reference's loss is finite
    (1.3565) and 5 of its 8 gradient leaves are not; the port's loss is
    the same and every gradient leaf finite."""
    cfg, jcfg = get_config("zamba2-2.7b"), j_get_config("zamba2-2.7b")
    lp = j_ssm.init_mamba2_block(jax.random.PRNGKey(0), jcfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (1, 128, jcfg.d_model))
    _, nh, _ = ssm.mamba2_dims(cfg)
    hn = j_layers.rmsnorm(lp["ln"], x, jcfg.norm_eps)
    dt = jax.nn.softplus((hn @ lp["in_proj"]["w"])[..., -nh:] + lp["dt_bias"])
    assert float(dt.sum(axis=1).max()) == pytest.approx(120.6, abs=0.05)

    def j_loss(p_):
        return jnp.mean(j_ssm.mamba2_block(p_, x, jcfg)[0] ** 2)

    want, grads = jax.value_and_grad(j_loss)(lp)
    assert float(want) == pytest.approx(1.3565, abs=5e-5)
    assert sum(not bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(grads)) == 5
    tp = _torch_tree(jax.tree.map(np.asarray, lp))
    leaves = convert.flat(tp)
    assert len(leaves) == 8
    for t in leaves.values():
        t.requires_grad_(True)
    got = (ssm.mamba2_block(tp, torch.tensor(np.asarray(x)), cfg)[0] ** 2).mean()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=F32_RTOL)
    got.backward()
    for name, t in leaves.items():
        assert bool(torch.isfinite(t.grad).all()), name


@pytest.mark.parametrize("fn", ["wkv6", "mamba2"])
def test_a_partial_chunk_is_refused(fn):
    """S must be a whole number of chunks, as the reference asserts."""
    if fn == "wkv6":
        a = np.zeros((1, 24, 1, 4), np.float32)
        with pytest.raises(AssertionError):
            j_ssm.wkv6_chunked(*(jnp.asarray(a),) * 4, jnp.zeros((1, 4)), jnp.zeros((1, 1, 4, 4)),
                               16)
        t = torch.tensor(a)
        with pytest.raises(ValueError, match="not a multiple of the chunk 16"):
            ssm.wkv6_chunked(t, t, t, t, torch.zeros(1, 4), torch.zeros(1, 1, 4, 4), 16)
    else:
        cfg, jcfg, lp, x = _mamba_case(11, 40)
        with pytest.raises(AssertionError):
            j_ssm.mamba2_mix(jax.tree.map(jnp.asarray, lp), jnp.asarray(x), jcfg, {})
        with pytest.raises(ValueError, match="not a multiple of the chunk 32"):
            ssm.mamba2_mix(_torch_tree(lp), torch.tensor(x), cfg, {})


# ---------------------------------------------------------------- the models


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient(arch, mode):
    jcfg, params, model = _reference(arch, 0)
    tokens, labels = _tokens(jcfg.vocab, 0), _tokens(jcfg.vocab, 100)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    jm = j_model.get_model(jcfg)
    want, wgrads = jax.value_and_grad(lambda p: jm.loss(p, jb))(jax.tree.map(jnp.asarray, params))
    got = model.loss({"tokens": torch.tensor(tokens), "labels": torch.tensor(labels)})
    assert got.dtype == torch.float32 and float(model.last_aux) == 0.0
    if mode == "bf16":
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=BF16_LOSS_RTOL)
        return
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=F32_RTOL)
    got.backward()
    wflat = convert.flat(jax.tree.map(np.asarray, wgrads))
    gflat = {n: p.grad for n, p in model.params().items()}
    assert list(gflat) == list(wflat)  # the reference's leaf order
    for name, g in gflat.items():
        _close(g, wflat[name], "f32", GRAD_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill(arch, mode):
    """Last logits and every part of the cache: the recurrent state, the
    shift or conv carries and, for the hybrid, the shared block's keys
    and values per group."""
    jcfg, params, model = _reference(arch, 2)
    tokens = _tokens(jcfg.vocab, 2)
    want, wcache = j_model.get_model(jcfg).prefill(jax.tree.map(jnp.asarray, params),
                                                   {"tokens": jnp.asarray(tokens)})
    got, gcache = model.prefill({"tokens": torch.tensor(tokens)})
    assert got.shape == (B, 1, jcfg.vocab) and got.dtype == torch.float32
    _close(got, want, mode)
    assert sorted(gcache) == sorted(wcache)
    for key in wcache:
        assert gcache[key].shape == wcache[key].shape, key
        _close(gcache[key], wcache[key], mode, state=key in STATES)


def _grown(model, cache: dict, prompt: int, total: int) -> dict:
    """A prefill's cache in an ``init_cache(B, total)`` one: the keys and
    values copied into its first ``prompt`` slots, the recurrent state as
    it is."""
    out = model.init_cache(B, total)
    for key, t in cache.items():
        if key in ("k", "v"):
            out[key][:, :, :prompt] = t
        else:
            out[key].copy_(t)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_the_reference(arch, mode):
    """Three decode steps from ``init_cache``, logits and the whole cache."""
    jcfg, params, model = _reference(arch, 3)
    jd, td = _dtypes(mode)
    jm = j_model.get_model(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    jcache, tcache = jm.init_cache(B, 8, dtype=jd), model.init_cache(B, 8)
    assert sorted(tcache) == sorted(jcache)
    for key in jcache:
        assert tcache[key].shape == jcache[key].shape, key
        assert tcache[key].dtype == (torch.float32 if jcache[key].dtype == jnp.float32 else td)
    rng = np.random.default_rng(3)
    for pos in range(3):
        tok = rng.integers(0, jcfg.vocab, (B, 1)).astype(np.int32)
        want, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        got, tcache = model.decode_step(tcache, torch.tensor(tok), pos)
        assert got.shape == (B, 1, jcfg.vocab) and got.dtype == torch.float32
        _close(got, want, mode)
    for key in jcache:
        _close(tcache[key], jcache[key], mode, state=key in STATES)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_matches_the_reference(arch, mode):
    """A prefill of 64 tokens, then 4 decode steps on its cache, in both
    packages (the reference's cache grown the same way)."""
    jcfg, params, model = _reference(arch, 4)
    jd, _ = _dtypes(mode)
    jm = j_model.get_model(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    tokens = _tokens(jcfg.vocab, 4, s=S + 4)
    _, wcache = jm.prefill(jp, {"tokens": jnp.asarray(tokens[:, :S])})
    _, gcache = model.prefill({"tokens": torch.tensor(tokens[:, :S])})
    jcache = jm.init_cache(B, S + 4, dtype=jd)
    for key, t in wcache.items():
        jcache[key] = (jcache[key].at[:, :, :S].set(t) if key in ("k", "v")
                       else t.astype(jcache[key].dtype))
    tcache = _grown(model, gcache, S, S + 4)
    for pos in range(S, S + 4):
        tok = tokens[:, pos:pos + 1]
        want, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        got, tcache = model.decode_step(tcache, torch.tensor(tok), pos)
        _close(got, want, mode)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_a_prefill(arch, mode):
    """Prefill S - D tokens, decode D = the config's chunk more on its
    cache: the last logits equal a prefill of all S (chip_smoke's leg 20
    check, at reduced width).  In f32 a chunk's terms are summed in
    another grouping than one position at a time: 1.1e-6 of the largest
    logit apart on these seeds."""
    cfg = get_config(arch, reduced=True)
    model = t_model.get_model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    D = cfg.ssm.chunk
    total = 2 * D + S
    toks = torch.tensor(_tokens(cfg.vocab, 5, s=total))
    full, _ = model.prefill({"tokens": toks})
    _, cache = model.prefill({"tokens": toks[:, :total - D]})
    cache = _grown(model, cache, total - D, total)
    for pos in range(total - D, total):
        logits, cache = model.decode_step(cache, toks[:, pos:pos + 1], pos)
    _close(logits, full, mode)


# ---------------------------------------------------------------- structure


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_reference_distributions(arch):
    """Shapes as the reference's ``Model.init`` (through
    ``jax.eval_shape``, two leading axes for the hybrid's Mamba2 stack);
    the constants of ``ssm.py:26-49``/``:156-166``; the normal draws'
    scales; the generator alone decides."""
    cfg = get_config(arch, reduced=True)
    a = t_model.get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    b = t_model.get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(lambda: j_model.get_model(cfg).init(jax.random.PRNGKey(0)))
    want = {n: tuple(s.shape) for n, s in convert.flat(shapes).items()}
    assert {n: tuple(p.shape) for n, p in a.params().items()} == want
    assert convert.param_shapes(cfg) == want
    constants = {"scale": 1.0, "mu": 0.5, "w0": -6.0, "u": 0.0, "A_log": 0.0, "D": 1.0,
                 "dt_bias": 0.0}
    scales = {"wa": 0.01, "wb": 0.01, "conv_w": 0.1}
    for name, p in a.params().items():
        assert torch.equal(p, b.params()[name])
        leaf = name.split(".")[-1]
        if leaf in constants:
            assert bool((p == constants[leaf]).all()), name
            continue
        if leaf in scales:
            scale = scales[leaf]
        elif name in ("embed", "lm_head"):
            scale = cfg.d_model**-0.5
        else:
            scale = p.shape[-2] ** -0.5
        assert float(p.detach().std()) == pytest.approx(scale, rel=0.1), name


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip(arch):
    """Reference parameters through the port and back, leaf for leaf, in
    the reference's order; the stacked leaves have ``ndim >= 2`` (AdamW
    decays them), the hybrid's shared norms ``ndim == 1`` (it does not)."""
    jcfg, params, model = _reference(arch, 5)
    assert list(model.params()) == list(convert.flat(params))
    back = convert.to_numpy(jcfg, model.params())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, want)
    stacked = {n: p for n, p in model.params().items() if n.startswith("layers.")}
    assert all(p.ndim >= 2 for p in stacked.values())
    if jcfg.family == "hybrid":
        G = jcfg.n_layers // jcfg.shared_period
        assert all(p.shape[:2] == (G, jcfg.shared_period) for p in stacked.values())
        assert model.params()["shared.ln1.scale"].ndim == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_decay_follows_the_reference(arch):
    cfg, params, model = _reference(arch, 6)
    acfg = j_opt.AdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.5)
    zero = jax.tree.map(np.zeros_like, params)
    jp, _, _ = j_opt.adamw_update(jax.tree.map(jnp.asarray, params),
                                  jax.tree.map(jnp.asarray, zero), j_opt.adamw_init(params), acfg)
    tp = model.params()
    t_opt.adamw_update(tp, convert.from_numpy(cfg, zero), t_opt.adamw_init(tp),
                       t_opt.AdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.5))
    for name, want in convert.flat(jax.tree.map(np.asarray, jp)).items():
        np.testing.assert_allclose(tp[name].detach().numpy(), want, rtol=1e-6, err_msg=name)


def test_an_uneven_hybrid_depth_is_refused():
    cfg = get_config("zamba2-2.7b", reduced=True).scaled(n_layers=7)
    with pytest.raises(ValueError, match="n_layers 7 .* shared_period 3"):
        t_model.get_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="n_layers 7 .* shared_period 3"):
        convert.param_shapes(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_model_runs_on_cuda_unless_asked(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        t_model.get_model(get_config(arch))
    assert t_model.get_model(get_config(arch, reduced=True), device="cpu").recurrent


def test_counted_parameters_of_the_published_configs():
    """The leg's N: the reference's own leaves counted (through
    ``jax.eval_shape``) equal the port's, at full and at cut depth; the
    analytic ``param_count`` is not that count for these two families."""
    for arch, cut, want_full, want_cut in (("rwkv6-3b", 4, 3_088_962_048, 679_723_776),
                                           ("zamba2-2.7b", 12, 2_422_113_824, 747_240_512)):
        for n_layers, want in ((None, want_full), (cut, want_cut)):
            cfg = get_config(arch)
            cfg = cfg.scaled(n_layers=n_layers) if n_layers else cfg
            shapes = jax.eval_shape(lambda: j_model.get_model(cfg).init(jax.random.PRNGKey(0)))
            counted = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
            port = sum(int(np.prod(s)) for s in convert.param_shapes(cfg).values())
            assert counted == port == want
            assert cfg.param_count() != counted


# ---------------------------------------------------------------- training


ARGS = ["--reduced", "--global-batch", "2", "--seq-len", str(S), "--log-every", "1",
        "--device", "cpu"]


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_steps_match_the_reference(arch, accum, f32):
    """Three steps of ``launch/train.main`` (f32 activations) against the
    reference's ``build_train_step`` from the same initial parameters
    (the launcher's seed-0 draw, converted) on the same pipeline batches."""
    steps = 3
    run = train.main(["--arch", arch, "--steps", str(steps), "--accum", str(accum), *ARGS])
    cfg = get_config(arch, reduced=True)
    start = t_model.get_model(cfg, device="cpu").init(
        torch.Generator(device="cpu").manual_seed(0))
    jp = jax.tree.map(jnp.asarray, convert.to_numpy(cfg, start.params()))
    acfg = j_opt.AdamWConfig(lr=3e-4, total_steps=steps, warmup_steps=max(1, steps // 20))
    j_step = j_train.build_train_step(j_model.get_model(j_get_config(arch, reduced=True)), acfg,
                                      accum)
    jo = j_opt.adamw_init(jp)
    pipe = JPipeline(JPipelineConfig(cfg.vocab, S, 2))
    want_l, want_g = [], []
    for step in range(steps):
        jp, jo, jl, jm = j_step(jp, jo, {k: jnp.asarray(v)
                                         for k, v in pipe.local_batch_at(step).items()})
        want_l.append(float(jl))
        want_g.append(float(jm["grad_norm"]))
    assert run["steps"] == list(range(steps)) and run["aux"] == [0.0] * steps
    np.testing.assert_allclose(run["losses"], want_l, rtol=F32_RTOL)
    np.testing.assert_allclose(run["grad_norms"], want_g, rtol=UPD_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_bf16_as_shipped(arch):
    """One AdamW step with bf16 activations: the loss within
    ``BF16_LOSS_RTOL`` of the reference's; zamba2's gradient norm too.

    rwkv6's bf16 gradient norm is not determined by its inputs to any
    such bound, in either package.  At init ``u`` = 0 and the state is 0,
    so each sequence's first wkv output is exactly 0 and the next few are
    single products ``r_t . k_s`` that cancel to near 0; the per-head
    RMSNorm that follows has a Jacobian of up to rsqrt(eps) = 316 there,
    and bf16 rounding of r and k moves those outputs by their own size,
    in each package differently, while the f32 norms agree
    (``test_launcher_steps_match_the_reference``).  So rwkv6's bf16 norm
    is only held finite here."""
    cfg, params, model = _reference(arch, 7)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=2)
    j_step = j_train.build_train_step(j_model.get_model(cfg), j_opt.AdamWConfig(**kw))
    t_step = train.build_train_step(model, t_opt.AdamWConfig(**kw))
    batch = JPipeline(JPipelineConfig(cfg.vocab, S, 2)).local_batch_at(0)
    _, _, jl, jm = j_step(jax.tree.map(jnp.asarray, params), j_opt.adamw_init(params),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm = t_step(t_opt.adamw_init(model.params()),
                    {k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=BF16_LOSS_RTOL)
    assert np.isfinite(float(tm["grad_norm"])) and np.isfinite(float(jm["grad_norm"]))
    if cfg.family == "hybrid":
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=BF16_LOSS_RTOL)


def _random_opt(model, seed: int) -> dict:
    opt = t_opt.adamw_init(model.params())
    gen = torch.Generator().manual_seed(seed)
    for k in ("m", "v"):
        for t in opt[k].values():
            t.copy_(torch.rand(t.shape, generator=gen))
    opt["step"].fill_(7)
    return opt


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_both_ways(arch, tmp_path):
    """A port step directory holds the reference's files byte for byte and
    restores into the reference; a reference step restores into a fresh
    port model and its AdamW state."""
    cfg, params, model = _reference(arch, 8)
    opt = _random_opt(model, 9)
    Checkpointer(str(tmp_path / "port")).save(4, train.state_tree(model.params(), opt),
                                              blocking=True)
    ref_tree = convert.to_numpy(cfg, model.params(), opt)
    j_checkpoint.Checkpointer(str(tmp_path / "ref")).save(4, ref_tree, blocking=True)
    got, want = tmp_path / "port" / "step_4", tmp_path / "ref" / "step_4"
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    assert json.loads((got / "manifest.json").read_text()) == json.loads(
        (want / "manifest.json").read_text())
    for name in os.listdir(want):
        assert (got / name).read_bytes() == (want / name).read_bytes(), name
    (rp, ro), step = j_checkpoint.Checkpointer(str(tmp_path / "port")).restore(
        (params, j_opt.adamw_init(params)))
    assert step == 4 and int(ro["step"]) == 7
    for a, b in zip(jax.tree.leaves((rp, ro)), jax.tree.leaves(ref_tree)):
        np.testing.assert_array_equal(np.asarray(a), b)

    fresh = t_model.get_model(model.cfg, device="cpu")
    fresh_opt = t_opt.adamw_init(fresh.params())
    restored, step = Checkpointer(str(tmp_path / "ref")).restore(
        train.state_tree(fresh.params(), fresh_opt))
    train.load_state(fresh.params(), fresh_opt, restored)
    assert step == 4 and int(fresh_opt["step"]) == 7
    for name, p in fresh.params().items():
        np.testing.assert_array_equal(p.detach().numpy(), convert.flat(params)[name])
        np.testing.assert_array_equal(fresh_opt["m"][name].numpy(), opt["m"][name].numpy())

