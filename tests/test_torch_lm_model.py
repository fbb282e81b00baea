"""The port's decoder families (``repro_torch.models``, ``repro_torch.configs``:
dense, moe, vlm) against the JAX package's, on the CPU.

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

MoE routing is discontinuous: a rounding difference at a top-k tie flips
a token's expert and moves its output by O(1).  So every f32 MoE parity
check first asserts, on the reference's own router probabilities of every
``moe_block`` call, that the k-th and the (k+1)-th choice of every token
lie more than ``MARGIN`` apart (a seed that gives a near-tie fails there,
loudly), and ``moe_block``'s own tests then hold experts, slots and the
drop mask equal before any value.  Under bf16 the MoE models' prefill and
decode logits are not compared elementwise: the tests report the share of
routing decisions that agree and hold it above ``BF16_ROUTE_AGREE``.
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
MOE = ["llama4-scout-17b-a16e", "moonshot-v1-16b-a3b"]
DECODERS = DENSE + MOE + ["qwen2-vl-7b"]
MARGIN = 1e-4  # f32 probabilities differ by ~1e-7 between the packages
BF16_ROUTE_AGREE = 0.8
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


def _inputs(cfg, seed: int, mode, keys=("tokens", "labels")) -> tuple[dict, dict]:
    """``(jax batch, port batch)`` of ``_batch``'s ``keys`` and, for
    ``vlm``, normal vision patches (B, P, d) in the activation dtype."""
    batch = {k: v for k, v in _batch(cfg.vocab, seed).items() if k in keys}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    if cfg.family == "vlm":
        rng = np.random.default_rng(seed + 100)
        patches = rng.normal(size=(B, cfg.vision_patches, cfg.d_model)).astype(np.float32)
        jb["patches"], tb["patches"] = _both(patches, mode)
    return jb, tb


def _ref_routing(p, x, cfg):
    """The routing lines of the reference's ``moe_block``
    (``src/repro/models/layers.py:358-370``), in jnp: probabilities,
    experts, slots and the kept choices."""
    T = x.shape[0]
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    C = max(1, int(cfg.moe.capacity_factor * k * T / E))
    logits = (x @ p["router"].astype(x.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, eid = jax.lax.top_k(probs, k)
    flat_e = eid.reshape(-1)
    onehot = (flat_e[:, None] == jnp.arange(E)[None, :]).astype(jnp.int32)
    rank = (jnp.cumsum(onehot, axis=0) - onehot)[jnp.arange(T * k), flat_e]
    valid = rank < C
    return probs, eid, jnp.where(valid, flat_e * C + rank, E * C), valid


def _margin(probs: np.ndarray, k: int) -> float:
    """The smallest gap between a token's k-th and (k+1)-th probability."""
    top = -np.sort(-probs, axis=-1)
    return float((top[:, k - 1] - top[:, k]).min())


@pytest.fixture
def routes(monkeypatch):
    """Records every ``moe_block`` call's routing: ``"ref"`` the
    reference's (probs, eid, slot, valid) as numpy, in call order;
    ``"port"`` the port's ``Routing``."""
    rec = {"ref": [], "port": []}
    j_block, t_route = j_layers.moe_block, layers.moe_route

    def j_spy(p, x, cfg):
        jax.debug.callback(lambda *a: rec["ref"].append(tuple(np.asarray(v) for v in a)),
                           *_ref_routing(p, x, cfg), ordered=True)
        return j_block(p, x, cfg)

    def t_spy(p, x, cfg):
        r = t_route(p, x, cfg)
        rec["port"].append(r)
        return r

    monkeypatch.setattr(j_layers, "moe_block", j_spy)
    monkeypatch.setattr(layers, "moe_route", t_spy)
    return rec


def _guard(rec: dict, cfg) -> None:
    """The margin guard on every recorded reference call."""
    assert rec["ref"], "no moe_block call recorded"
    for probs, *_ in rec["ref"]:
        margin = _margin(probs, cfg.moe.top_k)
        assert margin > MARGIN, f"a near-tie in the reference's routing: margin {margin:.3g}"


def _agreement(rec: dict) -> float:
    """Share of (token, choice) experts on which the port's calls agree
    with the reference's, call by call."""
    assert len(rec["port"]) == len(rec["ref"]) > 0
    same = [np.asarray(r.eid) == ref[1] for r, ref in zip(rec["port"], rec["ref"])]
    return float(np.mean(np.concatenate([a.ravel() for a in same])))


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
    """Sections that do not cover ``hd // 2`` frequencies are refused, as
    the reference's assertion refuses them."""
    pos = np.zeros((1, 4, 3), dtype=np.int32)
    with pytest.raises(AssertionError):
        j_layers.rope_angles(jnp.asarray(pos), 32, 1e4, (4, 6, 7))
    with pytest.raises(AssertionError):
        layers.rope_angles(torch.tensor(pos), 32, 1e4, (4, 6, 7))


@pytest.mark.parametrize("arch", ["qwen2-vl-7b"])
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "published"])
def test_rope_with_mrope_sections(arch, reduced, mode):
    """``rope_angles`` with M-RoPE sections: (4, 6, 6) over hd 32 reduced,
    (16, 24, 24) over hd 128 as published; three independent position
    streams, then ``apply_rope`` on them."""
    cfg = get_config(arch, reduced)
    rng = np.random.default_rng(11)
    pos = rng.integers(0, 5000, (2, 16, 3)).astype(np.int32)
    jc, js = j_layers.rope_angles(jnp.asarray(pos), cfg.hd, cfg.rope_theta, cfg.mrope_sections)
    tc, ts = layers.rope_angles(torch.tensor(pos), cfg.hd, cfg.rope_theta, cfg.mrope_sections)
    assert tc.shape == jc.shape == (2, 16, cfg.hd // 2) and tc.dtype == torch.float32
    # the frequencies' f32 powers may differ in the last bit: at angles up
    # to 5,000 rad that moves cos and sin by a few ulps of the angle
    atol = 4 * float(np.spacing(np.float32(5000)))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=atol)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=atol)
    x = rng.normal(size=(2, 16, 3, cfg.hd)).astype(np.float32)
    jx, tx = _both(x, mode)
    _close(layers.apply_rope(tx, torch.tensor(np.asarray(jc)), torch.tensor(np.asarray(js))),
           j_layers.apply_rope(jx, jc, js), mode)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "qwen2-1.5b"])
@pytest.mark.parametrize("S_len, offset", [(10, 0), (40, 0), (12, 9)],
                         ids=["inside-the-patches", "past-the-patches", "offset"])
def test_positions(arch, S_len, offset):
    """``Model._positions``: the M-RoPE streams on the 16-wide patch grid
    for positions below ``vision_patches`` (16 reduced) and the text's
    ``pos - P + 1`` past them; the plain positions without sections."""
    cfg = get_config(arch, reduced=True)
    got = t_model.get_model(cfg, device="cpu")._positions(2, S_len, offset)
    want = np.asarray(j_model.get_model(j_get_config(arch, reduced=True))._positions(
        2, S_len, offset))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


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


def _moe_case(arch: str, capacity_factor, seed: int):
    """``(cfg, layer-1 MoE parameters as numpy, x (T, d))`` for one of the
    reduced MoE configs; ``capacity_factor`` None keeps the published one."""
    cfg = get_config(arch, reduced=True)
    if capacity_factor is not None:
        cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))
    _, params, _ = _reference(arch, seed)
    p = {k: v[1] for k, v in params["layers"]["moe"].items()}
    x = np.random.default_rng(seed).normal(size=(2 * S, cfg.d_model)).astype(np.float32)
    return cfg, p, x


MOE_CASES = [pytest.param(arch, cf, id=f"{arch}-{tag}") for arch in MOE
             for cf, tag in ((None, "published"), (0.5, "capacity-0.5"))]


@pytest.mark.parametrize("arch, capacity_factor", MOE_CASES)
def test_moe_block(arch, capacity_factor, mode):
    """Routing (experts, slots, drop mask) equal after the margin guard,
    then the output and ``aux``; at capacity factor 0.5 choices drop."""
    cfg, p, x = _moe_case(arch, capacity_factor, 21)
    jx, tx = _both(x, mode)
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    probs, eid, slot, valid = (np.asarray(a) for a in _ref_routing(jp, jx, cfg))
    r = layers.moe_route(tp, tx, cfg)
    want, waux = j_layers.moe_block(jp, jx, cfg)
    got, gaux = layers.moe_block(tp, tx, cfg)
    assert got.shape == want.shape and got.dtype == tx.dtype and gaux.dtype == torch.float32
    if capacity_factor is not None:
        assert not valid.all()  # the case drops choices
    if mode == "bf16":
        agree = float((r.eid.numpy() == eid).mean())
        print(f"{arch}: bf16 routing agreement {agree:.4f}")
        assert agree >= BF16_ROUTE_AGREE
        np.testing.assert_allclose(float(gaux), float(waux), rtol=BF16_LOSS_RTOL)
        return
    assert _margin(probs, cfg.moe.top_k) > MARGIN
    np.testing.assert_array_equal(r.eid.numpy(), eid)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.valid.numpy(), valid)
    assert r.capacity == max(1, int(cfg.moe.capacity_factor * cfg.moe.top_k * len(x)
                                    / cfg.moe.n_experts))
    _close(r.probs, probs, mode)
    _close(got, want, mode)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=F32_RTOL)


@pytest.mark.parametrize("arch, capacity_factor", MOE_CASES)
def test_moe_block_gradients(arch, capacity_factor):
    """f32 gradients of a weighted sum of the output plus ``aux``, to the
    input and every MoE parameter (the router through the gates and
    ``aux``)."""
    cfg, p, x = _moe_case(arch, capacity_factor, 22)
    w = np.random.default_rng(23).normal(size=x.shape).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    assert _margin(np.asarray(_ref_routing(jp, jnp.asarray(x), cfg)[0]), cfg.moe.top_k) > MARGIN

    def j_obj(p_, x_):
        y, aux = j_layers.moe_block(p_, x_, cfg)
        return jnp.sum(y * w) + 3.0 * aux

    wp, wx = jax.grad(j_obj, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = layers.moe_block(tp, tx, cfg)
    ((y * torch.tensor(w)).sum() + 3.0 * aux).backward()
    _close(tx.grad, wx, "f32", GRAD_RTOL)
    for k in p:
        _close(tp[k].grad, wp[k], "f32", GRAD_RTOL)


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


@pytest.mark.parametrize("arch", DECODERS)
def test_loss_and_every_gradient(arch, mode, routes):
    cfg, params, model = _reference(arch, 0)
    jb, tb = _inputs(cfg, 0, mode)
    jm = j_model.get_model(cfg)
    want, wgrads = jax.value_and_grad(lambda p: jm.loss(p, jb))(jax.tree.map(jnp.asarray, params))
    got = model.loss(tb)
    assert got.dtype == torch.float32
    if mode == "bf16":
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=BF16_LOSS_RTOL)
        return
    if cfg.moe:
        _guard(routes, cfg)
        assert float(model.last_aux) > 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=F32_RTOL)
    got.backward()
    wflat = convert.flat(jax.tree.map(np.asarray, wgrads))
    gflat = {n: p.grad for n, p in model.params().items()}
    assert list(gflat) == list(wflat)  # the reference's leaf order
    for name, g in gflat.items():
        _close(g, wflat[name], "f32", GRAD_RTOL)


def _moe_logits(got, want, cfg, mode, routes):
    """MoE logits: f32 elementwise after the margin guard; bf16 finite,
    with the share of agreeing routing decisions reported and bounded."""
    if mode == "f32":
        _guard(routes, cfg)
        _close(got, want, mode)
        return
    assert bool(torch.isfinite(got).all())
    agree = _agreement(routes)
    print(f"{cfg.name}: bf16 routing agreement {agree:.4f}")
    assert agree >= BF16_ROUTE_AGREE


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill(arch, mode, routes):
    cfg, params, model = _reference(arch, 2)
    jb, tb = _inputs(cfg, 2, mode, keys=("tokens",))
    want, wcache = j_model.get_model(cfg).prefill(jax.tree.map(jnp.asarray, params), jb)
    got, gcache = model.prefill(tb)
    assert got.shape == (B, 1, cfg.vocab) and got.dtype == torch.float32
    if cfg.moe:
        _moe_logits(got, want, cfg, mode, routes)
    else:
        _close(got, want, mode)
    for key in "kv":
        assert gcache[key].shape == wcache[key].shape
        if not (cfg.moe and mode == "bf16"):
            _close(gcache[key], wcache[key], mode)


def test_vlm_prefill_without_patches(mode):
    """A ``vlm`` prompt without patches: the first ``vision_patches`` text
    positions still take the grid's coordinates, as in the reference."""
    cfg, params, model = _reference("qwen2-vl-7b", 6)
    tokens = _batch(cfg.vocab, 6)["tokens"]
    want, wcache = j_model.get_model(cfg).prefill(jax.tree.map(jnp.asarray, params),
                                                  {"tokens": jnp.asarray(tokens)})
    got, gcache = model.prefill({"tokens": torch.tensor(tokens)})
    assert gcache["k"].shape == wcache["k"].shape == (cfg.n_layers, B, S, cfg.n_kv, cfg.hd)
    _close(got, want, mode)
    _close(gcache["k"], wcache["k"], mode)


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_step_after_init_cache(arch, mode, routes):
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
        if cfg.moe:
            _moe_logits(got, want, cfg, mode, routes)
        else:
            _close(got, want, mode)
    for key in "kv":
        if not (cfg.moe and mode == "bf16"):
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


# the family ported last (audio) builds; a family that no code has
# still raises, naming ROADMAP.md §1
@pytest.mark.parametrize("arch", [a for a in J_ARCHS if j_get_config(a).family == "audio"])
def test_families_not_ported_raise(arch):
    cfg = get_config(arch, reduced=True)
    assert t_model.get_model(cfg, device="cpu").cfg.family in t_model.PORTED_FAMILIES
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1"):
        t_model.get_model(dataclasses.replace(cfg, family="speech"), device="cpu")


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


@pytest.mark.parametrize("arch", MOE)
def test_init_draws_the_reference_moe_distributions(arch):
    """The router and the experts' ``wg``/``wu`` normal x ``d ** -0.5``,
    ``wd`` normal x ``f ** -0.5``, each layer's draw its own; the stacked
    shapes are the reference's."""
    cfg = get_config(arch, reduced=True).scaled(n_layers=3)
    a = t_model.get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    b = t_model.get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(lambda: j_model.get_model(cfg).init(jax.random.PRNGKey(0)))
    want = {n: tuple(s.shape) for n, s in convert.flat(shapes).items()}
    assert {n: tuple(p.shape) for n, p in a.params().items()} == want
    d, f = cfg.d_model, cfg.d_ff
    for key, scale in (("router", d**-0.5), ("wg", d**-0.5), ("wu", d**-0.5), ("wd", f**-0.5)):
        p = a.params()[f"layers.moe.{key}"].detach()
        assert torch.equal(p, b.params()[f"layers.moe.{key}"])
        assert float(p.mean()) == pytest.approx(0.0, abs=0.05 * scale)
        assert float(p.std()) == pytest.approx(scale, rel=0.05), key
        assert not torch.equal(p[0], p[1])  # each layer draws its own
    assert "layers.mlp.wg.w" not in a.params()


@pytest.mark.parametrize("arch", MOE + ["qwen2-vl-7b"])
def test_convert_round_trip_new_families(arch):
    """Reference parameters through the port and back, leaf for leaf, in
    the reference's order; every stacked MoE leaf has ``ndim >= 2`` (the
    AdamW decay rule reaches it, as in the reference)."""
    cfg, params, model = _reference(arch, 5)
    assert list(model.params()) == list(convert.flat(params))
    back = convert.to_numpy(cfg, model.params())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, want)
    moe = {n: p for n, p in model.params().items() if n.startswith("layers.moe.")}
    assert bool(moe) == bool(cfg.moe)
    assert all(p.ndim >= 2 for p in moe.values())
    assert convert.param_shapes(cfg) == {n: tuple(p.shape) for n, p in model.params().items()}


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
