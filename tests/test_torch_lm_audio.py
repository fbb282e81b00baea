"""The port's audio family (``layernorm``, ``mlp_gelu`` and
``cross_attention_train`` of ``repro_torch.models.layers``, the sinusoids
and the ``audio`` branches of ``models/model.py``: whisper-medium's
encoder and decoder) against the JAX package's, on the CPU.

The same inputs, drawn with numpy from a seed, go through both packages;
model parameters come from the reference's ``Model.init`` and cross with
``convert.from_numpy``.  The bounds are ``tests/test_torch_lm_model.py``'s:
f32 values within ``F32_RTOL`` relative (with an absolute floor of
``F32_RTOL`` x the largest value), gradients within ``GRAD_RTOL``, bf16
activations within the reference's own bound (rtol = atol = 0.15) and
losses within ``BF16_LOSS_RTOL``.

Two sizes: whisper's ``REDUCED`` (every attention on the one-einsum
path), and ``WIDE``, whisper's head width (hd 64) with 2,100 audio
frames and 2,560 text tokens, so that the encoder's self-attention, the
decoder's causal self-attention and its cross-attention all take
``flash_attention``'s chunked path, the memory's 2,100 keys padded to
3,072 (three chunks of 1,024, 972 masked slots).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as j_get_config
from repro.launch import train as j_train
from repro.models import layers as j_layers
from repro.models import model as j_model
from repro.train import checkpoint as j_checkpoint
from repro.train import optimizer as j_opt
from repro.train.pipeline import DataPipeline as JPipeline
from repro.train.pipeline import PipelineConfig as JPipelineConfig
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.models import convert, layers
from repro_torch.models import model as t_model
from repro_torch.train import optimizer as t_opt
from repro_torch.train.checkpoint import Checkpointer

F32_RTOL = 1e-5
GRAD_RTOL = 1e-4
BF16_RTOL = BF16_ATOL = 0.15  # the reference's bound for bf16 activations
BF16_LOSS_RTOL = 2e-2  # about five bf16 roundings (2**-8 each) of the loss
UPD_RTOL = 1e-4
ARCH = "whisper-medium"
B, S = 2, 32
WIDE = dict(n_layers=1, enc_layers=1, d_model=128, n_heads=2, n_kv=2, d_ff=256,
            n_audio_ctx=2100)
# (rows, text tokens) a size runs at; WIDE's 2,560 is a whole number of
# the cross-entropy's 512-position chunks past 2,048
SIZES = {"reduced": (B, S), "wide": (1, 2560)}
CACHE = ("k", "v", "mem_k", "mem_v")


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


def _close(got, want, mode, rtol=F32_RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if mode == "f32":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)


def _configs(size: str):
    """(reference config, port config) of ``size``."""
    jcfg, cfg = j_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    if size == "wide":
        jcfg, cfg = jcfg.scaled(**WIDE), cfg.scaled(**WIDE)
    return jcfg, cfg


def _reference(size: str, seed: int):
    """(reference config, its parameters as numpy, the port's model
    holding them)."""
    jcfg, cfg = _configs(size)
    params = jax.tree.map(np.asarray, j_model.get_model(jcfg).init(jax.random.PRNGKey(seed)))
    model = t_model.get_model(cfg, device="cpu")
    model.load_state_dict(convert.from_numpy(cfg, params))
    return jcfg, params, model


def _batch(cfg, seed: int, rows: int, seq: int, labels: bool = True) -> dict:
    """Tokens (and labels) and normal f32 frames (rows, n_audio_ctx, d),
    as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (rows, seq)).astype(np.int32),
           "frames": rng.normal(size=(rows, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab, (rows, seq)).astype(np.int32)
    return out


def _feed(batch: dict) -> tuple[dict, dict]:
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.tensor(v) for k, v in batch.items()})


# ---------------------------------------------------------------- layers


def test_layernorm(mode):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3 + 1.5
    p = {"scale": rng.normal(size=48).astype(np.float32),
         "bias": rng.normal(size=48).astype(np.float32)}
    jx, tx = _both(x, mode)
    got = layers.layernorm({k: torch.tensor(v) for k, v in p.items()}, tx, 1e-5)
    want = j_layers.layernorm(jax.tree.map(jnp.asarray, p), jx, 1e-5)
    assert got.dtype == tx.dtype
    _close(got, want, mode)


def test_mlp_gelu(mode):
    """The tanh form, ``jax.nn.gelu``'s default: in f32 the erf form would
    miss the reference's values on these inputs (by up to ~1e-3)."""
    rng = np.random.default_rng(1)
    p = {"wi": {"w": rng.normal(size=(32, 64)).astype(np.float32) * 0.3,
                "b": rng.normal(size=64).astype(np.float32)},
         "wo": {"w": rng.normal(size=(64, 32)).astype(np.float32) * 0.2,
                "b": rng.normal(size=32).astype(np.float32)}}
    x = rng.normal(size=(2, 6, 32)).astype(np.float32)
    jx, tx = _both(x, mode)
    tp = {k: {n: torch.tensor(a) for n, a in v.items()} for k, v in p.items()}
    got = layers.mlp_gelu(tp, tx)
    want = j_layers.mlp_gelu(jax.tree.map(jnp.asarray, p), jx)
    assert got.dtype == tx.dtype
    _close(got, want, mode)
    if mode == "f32":
        h = F.gelu(layers.linear(tp["wi"], tx))  # the erf form
        erf, ref = _np(layers.linear(tp["wo"], h)), _np(want)
        assert not np.allclose(erf, ref, rtol=F32_RTOL, atol=F32_RTOL * np.abs(ref).max())


@pytest.mark.parametrize("S_len, M", [(24, 20), (2100, 1500)], ids=["one-einsum", "chunked"])
def test_cross_attention_train(S_len, M, mode):
    """``x`` attends to projected memory keys and values: at 2,100 queries
    the chunked path, its 1,500 keys padded to 2,048."""
    _, cfg = _configs("reduced")
    _, params, model = _reference("reduced", 2)
    lp = jax.tree.map(lambda a: a[1], params["layers"])["xattn"]
    rng = np.random.default_rng(S_len)
    x = rng.normal(size=(1, S_len, cfg.d_model)).astype(np.float32)
    mk, mv = (rng.normal(size=(1, M, cfg.n_kv, cfg.hd)).astype(np.float32) for _ in "kv")
    (jx, tx), (jk, tk), (jv, tv) = _both(x, mode), _both(mk, mode), _both(mv, mode)
    got = layers.cross_attention_train(t_model._slice(model.layers.xattn, 1), tx, (tk, tv), cfg)
    want = j_layers.cross_attention_train(lp, jx, (jk, jv), cfg)
    assert got.dtype == tx.dtype
    _close(got, want, mode)


@pytest.mark.parametrize("nh, nkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_flash_attention_unmasked_padded_chunks(nh, nkv, mode):
    """causal=False with 2,100 queries (chunked, padded to 2,560) over
    1,500 keys (padded to 2,048: 548 masked slots), as the decoder's
    cross-attention runs at 4,096 tokens."""
    rng = np.random.default_rng(nh + nkv)
    q = rng.normal(size=(1, 2100, nh, 16)).astype(np.float32)
    k, v = (rng.normal(size=(1, 1500, nkv, 16)).astype(np.float32) for _ in "kv")
    (jq, tq), (jk, tk), (jv, tv) = _both(q, mode), _both(k, mode), _both(v, mode)
    got = layers.flash_attention(tq, tk, tv, causal=False)
    want = j_layers.flash_attention(jq, jk, jv, causal=False)
    assert got.shape == want.shape == (1, 2100, nh, 16) and got.dtype == tv.dtype
    _close(got, want, mode)


@pytest.mark.parametrize("S_len, d, offset", [(32, 64, 0), (1500, 1024, 0), (8, 1024, 4088)],
                         ids=["reduced", "audio-frames", "offset"])
def test_sinusoid(S_len, d, offset):
    """The table: float64 in numpy, rounded to f32, bit for bit."""
    got = t_model._sinusoid(S_len, d, offset)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_model._sinusoid(S_len, d, offset)))


@pytest.mark.parametrize("d", [64, 1024])
def test_sinusoid_at(d):
    """One position in f32 on the device, against the reference's own
    ``_sinusoid_at``: within F32_RTOL.  The two sinusoids are different
    functions: at position 1,499 they differ by more than that."""
    for pos in (0, 1, 31, 447, 1499, 4095):
        got = t_model._sinusoid_at(torch.tensor(pos), d)
        want = np.asarray(j_model._sinusoid_at(jnp.asarray(pos, jnp.int32), d))
        assert got.shape == (1, d) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL, atol=F32_RTOL)
    table = np.asarray(j_model._sinusoid(1500, d))[1499]
    assert np.abs(t_model._sinusoid_at(1499, d).numpy()[0] - table).max() > F32_RTOL


# ---------------------------------------------------------------- the model


@pytest.mark.parametrize("size", SIZES)
def test_encoder(size, mode):
    jcfg, params, model = _reference(size, 0)
    rows, _ = SIZES[size]
    frames = _batch(jcfg, 0, rows, 8)["frames"]
    jf, tf = _both(frames, mode)
    want = j_model.get_model(jcfg)._encode(jax.tree.map(jnp.asarray, params), jf)
    with torch.no_grad():
        got = model._encode(tf)
    assert got.dtype == _dtypes(mode)[1]
    _close(got, want, mode)


@pytest.mark.parametrize("size", SIZES)
def test_loss_and_every_gradient(size, mode):
    jcfg, params, model = _reference(size, 1)
    jb, tb = _feed(_batch(jcfg, 1, *SIZES[size]))
    jm = j_model.get_model(jcfg)
    want, wgrads = jax.value_and_grad(lambda p: jm.loss(p, jb))(jax.tree.map(jnp.asarray, params))
    got = model.loss(tb)
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


@pytest.mark.parametrize("size", SIZES)
def test_prefill(size, mode):
    """Last logits and all four cache leaves: the decoder's keys and
    values and the memory's, per layer."""
    jcfg, params, model = _reference(size, 2)
    rows, seq = SIZES[size]
    jb, tb = _feed(_batch(jcfg, 2, rows, seq, labels=False))
    want, wcache = j_model.get_model(jcfg).prefill(jax.tree.map(jnp.asarray, params), jb)
    got, gcache = model.prefill(tb)
    assert got.shape == (rows, 1, jcfg.vocab) and got.dtype == torch.float32
    _close(got, want, mode)
    assert sorted(gcache) == sorted(wcache) == sorted(CACHE)
    for key in CACHE:
        _close(gcache[key], wcache[key], mode)


def _grown_reference(jm, wcache: dict, rows: int, prompt: int, total: int, dtype) -> dict:
    """The reference's prefilled cache in an ``init_cache(rows, total)``
    one: keys and values in the first ``prompt`` slots, the memory's as
    they are."""
    grown = jm.init_cache(rows, total, dtype=dtype)
    for key, t in wcache.items():
        grown[key] = (grown[key].at[:, :, :prompt].set(t) if key in ("k", "v")
                      else t.astype(dtype))
    return grown


@pytest.mark.parametrize("size", SIZES)
def test_decode_steps_from_the_reference_prefill(size, mode):
    """Both packages decode 3 steps from the reference's prefilled cache
    (grown by 3 slots): logits every step and the whole cache after."""
    jcfg, params, model = _reference(size, 3)
    rows, seq = SIZES[size]
    jd, td = _dtypes(mode)
    jm = j_model.get_model(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    batch = _batch(jcfg, 3, rows, seq + 3, labels=False)
    jb, _ = _feed({"tokens": batch["tokens"][:, :seq], "frames": batch["frames"]})
    _, wcache = jm.prefill(jp, jb)
    jcache = _grown_reference(jm, wcache, rows, seq, seq + 3, jd)
    tcache = model.init_cache(rows, seq + 3)
    assert sorted(tcache) == sorted(jcache)
    for key in CACHE:
        assert tcache[key].shape == jcache[key].shape and tcache[key].dtype == td, key
        tcache[key].copy_(torch.tensor(_np(jcache[key])))
    for pos in range(seq, seq + 3):
        tok = batch["tokens"][:, pos:pos + 1]
        want, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        got, tcache = model.decode_step(tcache, torch.tensor(tok), pos)
        assert got.shape == (rows, 1, jcfg.vocab) and got.dtype == torch.float32
        _close(got, want, mode)
    for key in CACHE:
        _close(tcache[key], jcache[key], mode)


def test_decode_continues_a_prefill(f32):
    """Prefill S - 4 tokens, decode 4 more on its cache: the last logits
    equal a prefill of all S within F32_RTOL (chip_smoke's leg 21 check,
    at reduced width).  The decode steps' positions are ``_sinusoid_at``'s
    f32 angles, the prefill's the float64 table's."""
    cfg = get_config(ARCH, reduced=True)
    model = t_model.get_model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    _, tb = _feed(_batch(cfg, 5, B, S, labels=False))
    full, _ = model.prefill(tb)
    prompt = S - 4
    _, cache = model.prefill({"tokens": tb["tokens"][:, :prompt], "frames": tb["frames"]})
    dec = model.init_cache(B, S)
    for key, t in cache.items():
        if key in ("k", "v"):
            dec[key][:, :, :prompt] = t
        else:
            dec[key].copy_(t)
    for pos in range(prompt, S):
        logits, dec = model.decode_step(dec, tb["tokens"][:, pos:pos + 1], pos)
    assert dec["mem_k"].data_ptr() != cache["mem_k"].data_ptr()
    torch.testing.assert_close(dec["mem_k"], cache["mem_k"], rtol=0, atol=0)  # read, not written
    _close(logits, full, "f32")


# ---------------------------------------------------------------- structure


def test_init_draws_the_reference_distributions():
    """Shapes as the reference's ``Model.init`` (through
    ``jax.eval_shape``); norm scales one, norm and MLP biases zero; the
    normal draws' scales; the generator alone decides."""
    cfg = get_config(ARCH, reduced=True)
    a = t_model.get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    b = t_model.get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(lambda: j_model.get_model(cfg).init(jax.random.PRNGKey(0)))
    want = {n: tuple(s.shape) for n, s in convert.flat(shapes).items()}
    assert {n: tuple(p.shape) for n, p in a.params().items()} == want
    assert convert.param_shapes(cfg) == want
    assert {n.split(".")[0] for n in want} == {"embed", "lm_head", "final_norm", "enc_norm",
                                               "enc_layers", "layers"}
    for name, p in a.params().items():
        assert torch.equal(p, b.params()[name])
        leaf = name.split(".")[-1]
        if leaf in ("scale", "b", "bias"):
            assert bool((p == (1.0 if leaf == "scale" else 0.0)).all()), name
            continue
        scale = cfg.d_model**-0.5 if name in ("embed", "lm_head") else p.shape[-2] ** -0.5
        assert float(p.detach().std()) == pytest.approx(scale, rel=0.1), name


def test_convert_round_trip():
    """Reference parameters through the port and back, leaf for leaf, in
    the reference's order, ``enc_layers.*`` and ``enc_norm.*`` among them."""
    jcfg, params, model = _reference("reduced", 5)
    assert list(model.params()) == list(convert.flat(params))
    assert "enc_norm.bias" in model.params() and "enc_layers.mlp.wi.b" in model.params()
    back = convert.to_numpy(jcfg, model.params())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, want)


def test_weight_decay_follows_the_reference():
    """AdamW's ``p.ndim >= 2`` rule decays the stacked LayerNorm scales and
    biases and the stacked MLP biases, not ``enc_norm`` or ``final_norm``,
    in both packages."""
    cfg, params, model = _reference("reduced", 6)
    tp = model.params()
    for name in ("layers.ln1.bias", "layers.lnx.scale", "enc_layers.mlp.wi.b",
                 "layers.mlp.wo.b"):
        assert tp[name].ndim == 2, name
    for name in ("enc_norm.scale", "enc_norm.bias", "final_norm.scale"):
        assert tp[name].ndim == 1, name
    acfg = j_opt.AdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.5)
    zero = jax.tree.map(np.zeros_like, params)
    jp, _, _ = j_opt.adamw_update(jax.tree.map(jnp.asarray, params),
                                  jax.tree.map(jnp.asarray, zero), j_opt.adamw_init(params), acfg)
    before = {n: p.detach().clone() for n, p in tp.items()}
    t_opt.adamw_update(tp, convert.from_numpy(cfg, zero), t_opt.adamw_init(tp),
                       t_opt.AdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.5))
    for name, want in convert.flat(jax.tree.map(np.asarray, jp)).items():
        np.testing.assert_allclose(tp[name].detach().numpy(), want, rtol=1e-6, err_msg=name)
    assert torch.equal(tp["enc_norm.scale"], before["enc_norm.scale"])
    assert not torch.equal(tp["layers.ln1.scale"], before["layers.ln1.scale"])


def test_counted_parameters_of_the_published_config():
    """811,357,184: the reference's own leaves counted (through
    ``jax.eval_shape``) equal the port's; the analytic ``param_count``
    counts a SwiGLU MLP (3 d f) where whisper's GELU MLP has 2 d f."""
    cfg = get_config(ARCH)
    shapes = jax.eval_shape(lambda: j_model.get_model(cfg).init(jax.random.PRNGKey(0)))
    counted = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    port = sum(int(np.prod(s)) for s in convert.param_shapes(cfg).values())
    assert counted == port == 811_357_184
    assert cfg.param_count() == 1_012_189_184


def test_the_model_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        t_model.get_model(get_config(ARCH))
    assert t_model.get_model(get_config(ARCH), device="cpu").cfg.family == "audio"


# ---------------------------------------------------------------- training


ARGS = ["--reduced", "--global-batch", "2", "--seq-len", str(S), "--log-every", "1",
        "--device", "cpu"]


def _reference_batch(cfg, step: int) -> dict:
    """The reference launcher's batch: the pipeline's tokens and labels
    and zero bf16 frames (``launch/train.py:118-121``)."""
    batch = {k: jnp.asarray(v)
             for k, v in JPipeline(JPipelineConfig(cfg.vocab, S, 2)).local_batch_at(step).items()}
    batch["frames"] = jnp.zeros((2, cfg.n_audio_ctx, cfg.d_model), jnp.bfloat16)
    return batch


@pytest.mark.parametrize("accum", [1, 2])
def test_launcher_steps_match_the_reference(accum, f32):
    """Three steps of ``launch/train.main`` (f32 activations, zero frames)
    against the reference's ``build_train_step`` from the same initial
    parameters (the launcher's seed-0 draw, converted) on the same
    batches."""
    steps = 3
    run = train.main(["--arch", ARCH, "--steps", str(steps), "--accum", str(accum), *ARGS])
    cfg = get_config(ARCH, reduced=True)
    start = t_model.get_model(cfg, device="cpu").init(
        torch.Generator(device="cpu").manual_seed(0))
    jp = jax.tree.map(jnp.asarray, convert.to_numpy(cfg, start.params()))
    acfg = j_opt.AdamWConfig(lr=3e-4, total_steps=steps, warmup_steps=max(1, steps // 20))
    jcfg = j_get_config(ARCH, reduced=True)
    j_step = j_train.build_train_step(j_model.get_model(jcfg), acfg, accum)
    jo = j_opt.adamw_init(jp)
    want_l, want_g = [], []
    for step in range(steps):
        jp, jo, jl, jm = j_step(jp, jo, _reference_batch(jcfg, step))
        want_l.append(float(jl))
        want_g.append(float(jm["grad_norm"]))
    assert run["steps"] == list(range(steps)) and run["aux"] == [0.0] * steps
    np.testing.assert_allclose(run["losses"], want_l, rtol=F32_RTOL)
    np.testing.assert_allclose(run["grad_norms"], want_g, rtol=UPD_RTOL)


def test_train_step_bf16_as_shipped():
    """One AdamW step with bf16 activations and normal frames: the loss
    and the gradient norm within ``BF16_LOSS_RTOL`` of the reference's."""
    cfg, params, model = _reference("reduced", 7)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=2)
    j_step = j_train.build_train_step(j_model.get_model(cfg), j_opt.AdamWConfig(**kw))
    t_step = train.build_train_step(model, t_opt.AdamWConfig(**kw))
    jb, tb = _feed(_batch(cfg, 7, B, S))
    _, _, jl, jm = j_step(jax.tree.map(jnp.asarray, params), j_opt.adamw_init(params), jb)
    tl, tm = t_step(t_opt.adamw_init(model.params()), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=BF16_LOSS_RTOL)
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


def test_checkpoints_cross_both_ways(tmp_path):
    """A port step directory holds the reference's files byte for byte and
    restores into the reference; a reference step restores into a fresh
    port model and its AdamW state."""
    cfg, params, model = _reference("reduced", 8)
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
