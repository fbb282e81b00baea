"""The port's dense decoder (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's, on the CPU.

The same inputs, drawn with numpy from a seed, go through both packages;
parameters come from the reference's ``Model.init`` and cross with
``convert.from_numpy``.  Two modes:

* f32: both packages' ``ACT_DTYPE`` set to float32.  Values agree to
  ``F32_RTOL`` relative, gradients to ``GRAD_RTOL`` relative with an
  absolute floor of ``GRAD_RTOL`` x the leaf's largest gradient
  (different summation orders, nothing else);
* bf16, as shipped: logits and attention outputs within the reference's
  own bound for bf16 activations (``tests/test_arch_smoke.py``: rtol =
  atol = 0.15), losses within ``BF16_LOSS_RTOL`` relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.models import config as j_config
from repro.models import layers as j_layers
from repro.models import model as j_model
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import config, convert, layers
from repro_torch.models import model as t_model

F32_RTOL = 1e-5
GRAD_RTOL = 1e-4
BF16_RTOL = BF16_ATOL = 0.15  # the reference's bound for bf16 activations
BF16_LOSS_RTOL = 2e-2  # about five bf16 roundings (2**-8 each) of the loss
DENSE = ["qwen2-1.5b", "deepseek-coder-33b", "minitron-4b", "minitron-8b"]
B, S = 2, 32


@pytest.fixture(params=["f32", "bf16"])
def mode(request, monkeypatch):
    if request.param == "f32":
        monkeypatch.setattr(j_model, "ACT_DTYPE", jnp.float32)
        monkeypatch.setattr(t_model, "ACT_DTYPE", torch.float32)
    return request.param


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
    if mode == "f32":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)


def _reference(arch: str, seed: int):
    cfg = j_get_config(arch, reduced=True)
    params = jax.tree.map(np.asarray, j_model.get_model(cfg).init(jax.random.PRNGKey(seed)))
    model = t_model.get_model(get_config(arch, reduced=True), device="cpu")
    model.load_state_dict(convert.from_numpy(model.cfg, params))
    return cfg, params, model


def _batch(vocab: int, seed: int, b=B, s=S) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", J_ARCHS)
def test_config_equals_the_reference(arch):
    assert ARCHS == J_ARCHS
    for reduced in (False, True):
        got, want = get_config(arch, reduced), j_get_config(arch, reduced)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert (got.nh_eff, got.hd, got.attention_free, got.sub_quadratic) == (
            want.nh_eff, want.hd, want.attention_free, want.sub_quadratic)


def test_shapes_and_registry_errors():
    assert {k: dataclasses.asdict(v) for k, v in config.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in j_config.SHAPES.items()}
    assert get_config("qwen2-1.5b").param_count() == 1_543_569_408
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


# ---------------------------------------------------------------- layers


def test_rmsnorm(mode):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3
    scale = rng.normal(size=48).astype(np.float32)
    jx, tx = _both(x, mode)
    got = layers.rmsnorm({"scale": torch.tensor(scale)}, tx, 1e-5)
    want = j_layers.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-5)
    assert got.dtype == tx.dtype
    _close(got, want, mode)


def test_rope(mode):
    rng = np.random.default_rng(1)
    pos = np.broadcast_to(np.arange(4090, 4106, dtype=np.int32), (2, 16))
    jc, js = j_layers.rope_angles(jnp.asarray(pos), 64, 1e6)
    tc, ts = layers.rope_angles(torch.tensor(pos), 64, 1e6)
    assert tc.dtype == torch.float32
    # f32 cos/sin of angles up to 4,105 rad: a few ulps of the angle
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    x = rng.normal(size=(2, 16, 3, 64)).astype(np.float32)
    jx, tx = _both(x, mode)
    _close(layers.apply_rope(tx, torch.tensor(np.asarray(jc)), torch.tensor(np.asarray(js))),
           j_layers.apply_rope(jx, jc, js), mode)


def test_mrope_sections_are_refused():
    with pytest.raises(NotImplementedError, match="vlm"):
        layers.rope_angles(torch.zeros((1, 4, 3), dtype=torch.int32), 32, 1e4, (4, 6, 6))


FLASH_CASES = [
    # (Sq = Sk, nh, nkv, hd, causal, causal skip)
    pytest.param(64, 4, 2, 16, True, False, id="one-einsum-causal-gqa"),
    pytest.param(64, 4, 2, 16, False, False, id="one-einsum-full-gqa"),
    pytest.param(48, 3, 3, 8, True, False, id="one-einsum-causal-mha"),
    pytest.param(2560, 2, 1, 8, True, False, id="chunked-causal-gqa"),
    pytest.param(2560, 2, 1, 8, False, False, id="chunked-full-gqa"),
    pytest.param(2560, 2, 1, 8, True, True, id="chunked-causal-skip-gqa"),
]


@pytest.mark.parametrize("S_len, nh, nkv, hd, causal, skip", FLASH_CASES)
def test_flash_attention(S_len, nh, nkv, hd, causal, skip, mode, monkeypatch):
    monkeypatch.setenv("REPRO_CAUSAL_SKIP", "1" if skip else "0")
    rng = np.random.default_rng(S_len + nh)
    q, k, v = (rng.normal(size=(1, S_len, n, hd)).astype(np.float32)
               for n in (nh, nkv, nkv))
    (jq, tq), (jk, tk), (jv, tv) = _both(q, mode), _both(k, mode), _both(v, mode)
    got = layers.flash_attention(tq, tk, tv, causal=causal)
    want = j_layers.flash_attention(jq, jk, jv, causal=causal)
    assert got.shape == want.shape and got.dtype == tv.dtype
    _close(got, want, mode)


@pytest.mark.parametrize("S_len", [64, 2560], ids=["one-einsum", "chunked"])
def test_flash_attention_gradients(S_len):
    rng = np.random.default_rng(7)
    q, k, v, w = (rng.normal(size=(1, S_len, n, 8)).astype(np.float32) for n in (2, 1, 1, 2))

    def j_loss(q, k, v):
        return jnp.sum(j_layers.flash_attention(q, k, v, causal=True) * w)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    (layers.flash_attention(tq, tk, tv, causal=True) * torch.tensor(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, ref, "f32", GRAD_RTOL)


def test_attention_decode(mode):
    cfg = get_config("qwen2-1.5b", reduced=True)
    _, params, model = _reference("qwen2-1.5b", 4)
    lp = jax.tree.map(lambda a: a[1], params["layers"])["attn"]
    rng = np.random.default_rng(4)
    cap, pos = 12, 7
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.normal(size=(2, cap, cfg.n_kv, cfg.hd)).astype(np.float32) for _ in "kv")
    jx, tx = _both(x, mode)
    (jk, tk), (jv, tv) = _both(ck, mode), _both(cv, mode)
    jcos, jsin = j_layers.rope_angles(jnp.full((2, 1), pos, jnp.int32), cfg.hd, cfg.rope_theta)
    tcos, tsin = layers.rope_angles(torch.full((2, 1), pos), cfg.hd, cfg.rope_theta)
    want, wcache = j_layers.attention_decode(lp, jx, {"k": jk, "v": jv}, pos, cfg, jcos, jsin)
    tlp = t_model._slice(model.layers.attn, 1)
    got, gcache = layers.attention_decode(tlp, tx, {"k": tk, "v": tv}, torch.tensor(pos), cfg,
                                          tcos, tsin)
    _close(got, want, mode)
    for key in "kv":
        _close(gcache[key], wcache[key], mode)
    assert gcache["k"] is tk  # written in place


def test_mlp_swiglu(mode):
    rng = np.random.default_rng(5)
    p = {k: {"w": rng.normal(size=shape).astype(np.float32) * 0.2}
         for k, shape in (("wg", (32, 64)), ("wu", (32, 64)), ("wd", (64, 32)))}
    x = rng.normal(size=(2, 6, 32)).astype(np.float32)
    jx, tx = _both(x, mode)
    got = layers.mlp_swiglu({k: {"w": torch.tensor(v["w"])} for k, v in p.items()}, tx)
    _close(got, j_layers.mlp_swiglu(jax.tree.map(jnp.asarray, p), jx), mode)


def test_chunked_softmax_xent(mode):
    rng = np.random.default_rng(6)
    h = rng.normal(size=(2, 1024, 32)).astype(np.float32)
    w = rng.normal(size=(32, 300)).astype(np.float32) * 0.3
    lab = rng.integers(0, 300, (2, 1024)).astype(np.int32)
    jh, th = _both(h, mode)
    want = j_layers.chunked_softmax_xent(jh, jnp.asarray(w), jnp.asarray(lab))
    tw = torch.tensor(w, requires_grad=True)
    got = layers.chunked_softmax_xent(th, tw, torch.tensor(lab))
    assert got.dtype == torch.float32 and got.shape == ()
    if mode == "f32":
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=F32_RTOL)
        got.backward()
        gw = jax.grad(lambda w_: j_layers.chunked_softmax_xent(jh, w_, jnp.asarray(lab)))(
            jnp.asarray(w))
        _close(tw.grad, gw, "f32", GRAD_RTOL)
    else:
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=BF16_LOSS_RTOL)


def test_chunked_softmax_xent_needs_whole_chunks():
    with pytest.raises(ValueError, match="multiple of the chunk"):
        layers.chunked_softmax_xent(torch.zeros(1, 600, 4), torch.zeros(4, 8),
                                    torch.zeros(1, 600, dtype=torch.int64))


# ---------------------------------------------------------------- the model


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_every_gradient(arch, mode):
    cfg, params, model = _reference(arch, 0)
    batch = _batch(cfg.vocab, 0)
    jb = jax.tree.map(jnp.asarray, batch)
    jm = j_model.get_model(cfg)
    want, wgrads = jax.value_and_grad(lambda p: jm.loss(p, jb))(jax.tree.map(jnp.asarray, params))
    got = model.loss({k: torch.tensor(v) for k, v in batch.items()})
    assert got.dtype == torch.float32
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


@pytest.mark.parametrize("arch", DENSE)
def test_prefill(arch, mode):
    cfg, params, model = _reference(arch, 2)
    batch = _batch(cfg.vocab, 2)
    want, wcache = j_model.get_model(cfg).prefill(jax.tree.map(jnp.asarray, params),
                                                  {"tokens": jnp.asarray(batch["tokens"])})
    got, gcache = model.prefill({"tokens": torch.tensor(batch["tokens"])})
    assert got.shape == (B, 1, cfg.vocab) and got.dtype == torch.float32
    _close(got, want, mode)
    for key in "kv":
        assert gcache[key].shape == wcache[key].shape
        _close(gcache[key], wcache[key], mode)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_after_init_cache(arch, mode):
    cfg, params, model = _reference(arch, 3)
    jd, td = _dtypes(mode)
    rng = np.random.default_rng(3)
    jm = j_model.get_model(cfg)
    jp = jax.tree.map(jnp.asarray, params)
    jcache, tcache = jm.init_cache(B, 10, dtype=jd), model.init_cache(B, 10)
    assert tcache["k"].shape == jcache["k"].shape == (cfg.n_layers, B, 10, cfg.n_kv, cfg.hd)
    assert tcache["k"].dtype == td
    for pos in range(3):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        want, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        got, tcache = model.decode_step(tcache, torch.tensor(tok), pos)
        assert got.shape == (B, 1, cfg.vocab) and got.dtype == torch.float32
        _close(got, want, mode)
    for key in "kv":
        _close(tcache[key], jcache[key], mode)


def test_decode_matches_prefill_dense():
    """The reference's own check (``tests/test_arch_smoke.py``) on the port:
    step-by-step decode agrees with a full forward, bf16 as shipped."""
    cfg = get_config("qwen2-1.5b", reduced=True)
    model = t_model.get_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (1, 8)), dtype=torch.int32)
    logits_full, _ = model.prefill({"tokens": toks})
    cache = model.init_cache(1, 8)
    for t in range(8):
        logits_step, cache = model.decode_step(cache, toks[:, t:t + 1], t)
    np.testing.assert_allclose(logits_step[:, 0].numpy(), logits_full[:, 0].numpy(),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("arch", [a for a in J_ARCHS if j_get_config(a).family != "dense"])
def test_families_not_ported_raise(arch):
    cfg = get_config(arch, reduced=True)
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1"):
        t_model.get_model(cfg, device="cpu")


def test_the_model_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        t_model.get_model(get_config("qwen2-1.5b", reduced=True))


def test_init_draws_the_reference_distributions():
    cfg = get_config("minitron-8b", reduced=True).scaled(n_layers=3)
    a = t_model.get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    b = t_model.get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    c = t_model.get_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    shapes = jax.eval_shape(lambda: j_model.get_model(cfg).init(jax.random.PRNGKey(0)))
    want = {n: tuple(s.shape) for n, s in convert.flat(shapes).items()}
    assert {n: tuple(p.shape) for n, p in a.params().items()} == want
    for name, p in a.params().items():
        assert torch.equal(p, b.params()[name])  # the generator alone decides
        if name.endswith("scale"):
            assert bool((p == 1).all())
        else:
            assert not torch.equal(p, c.params()[name])
            fan_in = cfg.d_model if name in ("embed", "lm_head") else p.shape[-2]
            assert float(p.detach().std()) == pytest.approx(fan_in**-0.5, rel=0.1)


def test_convert_round_trip_and_refusals():
    cfg, params, model = _reference("qwen2-1.5b", 5)
    back = convert.to_numpy(cfg, model.params())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, want)
    broken = dict(params, final_norm={"scale": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="final_norm.scale"):
        convert.from_numpy(cfg, broken)
    with pytest.raises(ValueError, match="lm_head"):
        convert.from_numpy(cfg, dict(params, lm_head=np.zeros((cfg.d_model, cfg.vocab))))
