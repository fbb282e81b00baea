"""The port's mesh rules (``repro_torch.launch.{mesh,sharding}``,
``models/shard_ctx.py``, ``train/compression.py``) against the JAX
package's, on the CPU in this process.

The reference's rules run on ``jax.sharding.AbstractMesh``, with no
devices, so every leaf of all ten configs at full shape, their caches
and their batches are held spec for spec on the production meshes
(16 × 16 and 2 × 16 × 16) and two small ones, the port's on
``launch.mesh.abstract_mesh`` of the same axes.  ``activation_spec`` is
held against the spec the reference's ``constrain`` pins (its
``with_sharding_constraint`` replaced by a recorder) for every kind and
mode.  ``train.leaf_layouts`` (the block each leaf computes with in the
meshed step) is held against the pins the reference's ``constrain``
records for the heads, the ffn width and the vocabulary, for all ten
configs on each mesh; ``layers.rank_kv`` against the whole attention's
GQA grouping.  ``compress``/``decompress`` are compared bit for bit, ties at .5
included.  Blocks: ``shard_of`` at every coordinate of a mesh tiles the
leaf, and ``gather`` on a one-rank gloo group in this process returns
it; the 4-rank layout against the reference's ``NamedSharding`` is in
``tests/test_torch_lm_mesh.py``.
"""
import datetime
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.launch import mesh as j_mesh
from repro.launch import sharding as j_shd
from repro.models import model as j_model
from repro.models import shard_ctx as j_ctx
from repro.train import compression as j_comp
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import sharding as t_shd
from repro_torch.launch import train
from repro_torch.models import convert
from repro_torch.models import layers
from repro_torch.models import shard_ctx as t_ctx
from repro_torch.models.model import Model
from repro_torch.train import compression as t_comp

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "1x2": ((1, 2), ("data", "model")),
}
MODES = ("all", "attn", "mlp", "ep", "sp")


def _meshes(key):
    shape, axes = MESHES[key]
    return AbstractMesh(shape, axes), t_mesh.abstract_mesh(shape, axes)


def _specs(tree) -> dict:
    """{dotted name: spec tuple} of a nested tree of ``NamedSharding``s."""
    return {n: tuple(s.spec) for n, s in convert.flat(tree).items()}


@pytest.fixture(scope="module")
def shapes():
    """Every config's parameters and caches as the reference lays them out
    (``jax.eval_shape``, no allocation)."""
    out = {}
    for arch in ARCHS:
        model = j_model.get_model(j_get_config(arch))
        out[arch] = {
            "params": jax.eval_shape(lambda m=model: m.init(jax.random.PRNGKey(0))),
            "cache": {B: jax.eval_shape(lambda m=model, b=B: m.init_cache(b, 4096))
                      for B in (1, 64)},
        }
    return out


def test_the_ten_configs_are_the_references():
    assert sorted(ARCHS) == sorted(J_ARCHS) and len(ARCHS) == 10


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_the_reference(arch, mesh, shapes):
    jm, tm = _meshes(mesh)
    cfg, jcfg = get_config(arch), j_get_config(arch)
    want_sh = j_shd.param_shardings(shapes[arch]["params"], jcfg, jm)
    want = _specs(want_sh)
    full = convert.param_shapes(cfg)
    got_sh = t_shd.param_shardings(full, cfg, tm)
    assert list(got_sh) == list(want)  # the reference's leaf order
    assert {n: s.spec for n, s in got_sh.items()} == want
    # and rule by rule, before _sanitize
    for name, shape in full.items():
        path = tuple(jax.tree_util.DictKey(k) for k in name.split("."))
        leaf = jax.ShapeDtypeStruct(shape, jnp.float32)
        assert t_shd.param_spec(name, shape, cfg) == tuple(j_shd.param_spec(path, leaf, jcfg))
    opt = t_shd.opt_shardings(None, got_sh, tm)
    jopt = j_shd.opt_shardings(None, want_sh, jm)
    assert opt["m"] is got_sh and opt["v"] is got_sh
    assert opt["step"].spec == tuple(jopt["step"].spec) == ()


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch, mesh, shapes):
    jm, tm = _meshes(mesh)
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for B, cache in shapes[arch]["cache"].items():
        want = _specs(j_shd.cache_shardings(cache, jcfg, jm, B))
        port = {k: tuple(v.shape) for k, v in Model(cfg, "meta").init_cache(B, 4096).items()}
        assert port == {n: tuple(s.shape) for n, s in convert.flat(cache).items()}
        got = {n: s.spec for n, s in t_shd.cache_shardings(port, cfg, tm, B).items()}
        assert got == want, (arch, B)


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_specs_equal_the_reference(mesh):
    jm, tm = _meshes(mesh)
    for B in (1, 2, 64, 512):
        batch = {"tokens": (B, 4096), "labels": (B, 4096), "patches": (B, 256, 3584),
                 "frames": (B, 1500, 1024), "pos": ()}
        jbatch = {k: jax.ShapeDtypeStruct(v, jnp.float32) for k, v in batch.items()}
        want = {k: tuple(s.spec) for k, s in j_shd.batch_shardings(jbatch, jm).items()}
        got = {k: s.spec for k, s in t_shd.batch_shardings(batch, tm).items()}
        assert got == want, B
        for k, v in jbatch.items():
            assert t_shd.batch_spec(k, batch[k], tm) == tuple(j_shd.batch_spec(k, v, jm))


@pytest.mark.parametrize("mesh", MESHES)
def test_data_axes_equal_the_reference(mesh):
    jm, tm = _meshes(mesh)
    assert t_mesh.data_axes(tm) == j_mesh.data_axes(jm)
    assert tm.shape == dict(jm.shape) and tm.axis_names == tuple(jm.axis_names)


# ---------------------------------------------------------------- activations


def _activation_shapes() -> list[tuple[str, tuple]]:
    """Each kind at shapes whose dims divide the model axis and do not,
    and at a wrong rank."""
    return [
        ("btd", (4, 64, 2048)), ("btd", (4, 7, 2048)), ("btd", (64, 2048)),
        ("btdg", (4, 64, 2048)), ("btf", (4, 64, 1408)), ("btf", (4, 64, 1400)),
        ("bthd", (4, 64, 16, 128)), ("bthd", (4, 64, 12, 128)), ("bthd", (4, 64, 2048)),
        ("bthd_rep", (4, 64, 16, 128)), ("td", (256, 2048)), ("td", (4, 64, 2048)),
        ("ecd", (64, 240, 2048)), ("ecf", (64, 240, 1408)), ("ecf", (64, 240)),
    ]


@pytest.fixture
def recorded(monkeypatch):
    """The reference's ``constrain`` with ``with_sharding_constraint``
    replaced by a recorder of the spec it pins."""
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, sharding: ("pinned", tuple(sharding.spec)))
    yield
    j_ctx.set_mesh(None)
    t_ctx.set_mesh(None)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mode", MODES)
def test_activation_specs_equal_the_references_constrain(mode, mesh, recorded):
    jm, tm = _meshes(mesh)
    j_ctx.set_mesh(jm, mode)
    t_ctx.set_mesh(tm, mode)
    pinned = 0
    for kind, shape in _activation_shapes():
        x = jax.ShapeDtypeStruct(shape, jnp.bfloat16)
        want = j_ctx.constrain(x, kind)
        want = want[1] if isinstance(want, tuple) else None
        assert t_ctx.activation_spec(kind, shape) == want, (kind, shape)
        pinned += want is not None
        y = torch.zeros(shape, dtype=torch.bfloat16)
        assert t_ctx.constrain(y, kind) is y
    assert pinned > 0 or mode == "ep"


def test_activation_spec_without_a_mesh_and_unknown_kinds(recorded):
    t_ctx.set_mesh(None)
    assert t_ctx.activation_spec("btd", (4, 64, 8)) is None
    jm, tm = _meshes("2x2")
    j_ctx.set_mesh(jm, "all")
    t_ctx.set_mesh(tm, "all")
    with pytest.raises(ValueError):
        j_ctx.constrain(jax.ShapeDtypeStruct((4, 8), jnp.float32), "bogus")
    with pytest.raises(ValueError):
        t_ctx.activation_spec("bogus", (4, 8))


# ---------------------------------------------------------------- the meshed step's layouts

# the leaves a pin cuts over ``model``, by (owner, projection, leaf): the
# dimension, from the end, that the layer splits
_CUT_DIMS = {("attn", "wq", "w"): -1, ("attn", "wq", "b"): -1, ("attn", "wo", "w"): -2,
             ("mlp", "wg", "w"): -1, ("mlp", "wu", "w"): -1, ("mlp", "wd", "w"): -2,
             ("mlp", "wi", "w"): -1, ("mlp", "wi", "b"): -1, ("mlp", "wo", "w"): -2}


def _pins_model(kind: str, shape: tuple) -> bool:
    """Whether the reference's ``constrain`` (its mesh installed, the
    recorder in place) pins a dimension of ``shape`` to ``model``."""
    pinned = j_ctx.constrain(jax.ShapeDtypeStruct(shape, jnp.bfloat16), kind)
    return isinstance(pinned, tuple) and "model" in pinned[1]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_layouts_follow_the_references_pins(arch, mesh, recorded):
    """``train.leaf_layouts``: every leaf keeps its rule's block; a leaf is
    computed with in its ``model`` block exactly where the reference pins
    the heads (``"bthd"`` on q), the ffn width or the vocabulary
    (``"btf"``) to ``model`` on a model axis of more than one rank, on
    the dimension its layer splits; ``wk`` and ``wv`` are then read in
    part (their gradient summed over ``model``); the experts compute with
    the block they keep; the rest runs whole."""
    jm, tm = _meshes(mesh)
    j_ctx.set_mesh(jm, "all")
    cfg = get_config(arch)
    tp = tm.shape["model"] > 1
    heads = tp and _pins_model("bthd", (4, 64, cfg.nh_eff, cfg.hd))
    ffn = tp and _pins_model("btf", (4, 64, cfg.d_ff))
    vocab = tp and _pins_model("btf", (4, 64, cfg.vocab))
    shapes = convert.param_shapes(cfg)
    specs = train.param_specs(cfg, tm)
    cut_any = False
    for name, lay in train.leaf_layouts(cfg, tm).items():
        assert lay.spec == specs[name], name
        if train.is_expert(name):
            assert lay.compute == lay.spec and not lay.partial, name
            continue
        owner, proj, leaf = ([None] * 3 + name.split("."))[-3:]
        owner = "attn" if owner == "xattn" else owner
        if name in ("embed", "lm_head"):
            dim = (-2 if name == "embed" else -1) if vocab else None
        elif owner == "attn":
            dim = _CUT_DIMS.get((owner, proj, leaf)) if heads else None
        elif owner == "mlp":
            dim = _CUT_DIMS.get((owner, proj, leaf)) if ffn else None
        else:
            dim = None
        want = () if dim is None else tuple(
            "model" if i == len(shapes[name]) + dim else None for i in range(len(shapes[name])))
        assert lay.compute == want, (name, lay)
        assert lay.partial == (heads and owner == "attn" and proj in ("wk", "wv")), name
        if dim is not None:
            assert shapes[name][dim] % tm.shape["model"] == 0, name
            cut_any = True
    assert cut_any == (heads or ffn or vocab)


def test_moonshot_computes_with_about_half_its_dense_leaves():
    """moonshot-v1-16b-a3b at 2 of 48 layers on (data 2, model 2), as the
    card's mesh leg runs it: 704.9 M non-expert elements, of which a rank
    computes with 361.0 M (the embedding, the head, ``wq`` and ``wo``
    at half, ``wk``, ``wv`` and the router whole)."""
    cfg = get_config("moonshot-v1-16b-a3b").scaled(n_layers=2)
    held = train.dense_held(cfg, t_mesh.abstract_mesh((2, 2), ("data", "model")))
    assert held == {"dense": 360_982_528, "whole": 704_915_456}
    assert train.dense_held(cfg, t_mesh.abstract_mesh((2, 1), ("data", "model")))["dense"] \
        == held["whole"]


@pytest.mark.parametrize("nh,nkv,size", [(12, 2, 2), (8, 2, 4), (6, 2, 2), (12, 3, 2), (4, 4, 2)],
                         ids=lambda v: str(v))
def test_rank_kv_gives_each_query_head_its_key_head(nh, nkv, size):
    """Every rank's query heads read, through ``flash_attention``'s
    grouping of the heads ``rank_kv`` returns, the key heads the whole
    attention gives them: whole GQA groups, one group, or one key head a
    query head."""
    cfg = get_config("qwen2-1.5b", reduced=True).scaled(n_heads=nh, n_kv=nkv)
    t = torch.arange(2 * 3 * nkv * 4, dtype=torch.float32).reshape(2, 3, nkv, 4)
    local = nh // size
    for index in range(size):
        got = layers.rank_kv(t, t_ctx.Cut(None, size, index), local, cfg)
        assert local % got.shape[2] == 0
        heads = (index * local + torch.arange(local)) // (nh // nkv)
        torch.testing.assert_close(got.repeat_interleave(local // got.shape[2], dim=2),
                                   t[:, :, heads], rtol=0, atol=0)


def test_the_model_axis_operations_without_a_mesh_are_the_identity():
    t_ctx.set_mesh(None)
    x = torch.ones(2, 3, 8, requires_grad=True)
    assert t_ctx.model_cut("btf", (2, 3, 8)) is None
    assert t_ctx.model_cut("bthd", (2, 3, 4, 2)) is None
    assert t_ctx.model_sum(x, None) is x and t_ctx.model_copy(x, None) is x
    tm = t_mesh.abstract_mesh((2, 1), ("data", "model"))
    assert not t_ctx.cuts_model(tm, "btf", (2, 3, 8))  # a model axis of one rank
    assert t_ctx.cuts_model(t_mesh.abstract_mesh((1, 2), ("data", "model")), "btf", (2, 3, 8))


# ---------------------------------------------------------------- compression


def _compress_cases():
    rng = np.random.default_rng(5)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5, -126.5, 0.0],
                    np.float32)
    yield "ties", ties, np.zeros_like(ties)
    yield "ties_err", ties - 0.25, np.full_like(ties, 0.25)  # corrected = ties
    yield "normal", rng.normal(size=(37, 19)).astype(np.float32), \
        (rng.normal(size=(37, 19)) * 1e-3).astype(np.float32)
    yield "wide", (rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, 4096)).astype(np.float32), \
        np.zeros(4096, np.float32)
    yield "zero", np.zeros(8, np.float32), np.zeros(8, np.float32)
    yield "bf16", rng.normal(size=64).astype(np.float32), np.zeros(64, np.float32)


@pytest.mark.parametrize("case", [c[0] for c in _compress_cases()])
def test_compress_and_decompress_bit_for_bit(case):
    _, g, err = next(c for c in _compress_cases() if c[0] == case)
    if case == "bf16":  # a bf16 gradient is widened first, as jnp's astype does
        tg = torch.tensor(g).to(torch.bfloat16)
        jg = jnp.asarray(g).astype(jnp.bfloat16)
    else:
        tg, jg = torch.tensor(g), jnp.asarray(g)
    q, scale, new_err = t_comp.compress(tg, torch.tensor(err))
    jq, jscale, jerr = j_comp.compress(jg, jnp.asarray(err))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32 and scale.ndim == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert scale.numpy().tobytes() == np.asarray(jscale).tobytes()
    assert new_err.numpy().tobytes() == np.asarray(jerr).tobytes()
    back = t_comp.decompress(q, scale)
    assert back.numpy().tobytes() == np.asarray(j_comp.decompress(jq, jscale)).tobytes()
    if case == "ties":  # half to even, in both
        np.testing.assert_array_equal(q.numpy()[1:8], [0, 2, 2, 0, -2, -2, 4])
    bufs = t_comp.init_error_buffers({"g": tg})
    assert bufs["g"].dtype == torch.float32 and not bufs["g"].any()


# ---------------------------------------------------------------- meshes and blocks


def test_production_mesh_refuses_too_few_ranks():
    with pytest.raises(RuntimeError, match=r"mesh \(16, 16\) needs 256 devices, have 1"):
        j_mesh.make_production_mesh()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match=r"mesh \(16, 16\) needs 256 ranks, have 0"):
        t_mesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match=r"mesh \(2, 16, 16\) needs 512 ranks, have 0"):
        t_mesh.make_production_mesh(multi_pod=True, device="cpu")


@pytest.fixture
def one_rank(tmp_path):
    """A gloo group of this process alone."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_a_one_rank_mesh_and_its_refusals(one_rank):
    with pytest.raises(RuntimeError, match=r"needs 256 ranks, have 1"):
        t_mesh.make_production_mesh(device="cpu")
    mesh = t_mesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.coords == {"data": 0, "model": 0}
    assert mesh.device == torch.device("cpu") and mesh.axis_names == ("data", "model")
    full = torch.arange(24.0).reshape(4, 6)
    for spec in [(), ("data",), ("model", "data"), (None, ("data", "model"))]:
        block = t_shd.shard_of(full, spec, mesh)
        assert torch.equal(block, full) and block.data_ptr() != full.data_ptr()
        assert torch.equal(t_shd.gather(block, spec, mesh), full)
    group = mesh.axis_group("data")
    x = torch.tensor([1.5, -2.0])
    assert torch.equal(t_mesh.all_reduce(x, group), x)
    assert torch.equal(t_mesh.all_reduce(x, group, op="max"), x)
    b = torch.randn(4, 3).to(torch.bfloat16)
    assert torch.equal(t_mesh.all_to_all(b, group), b)


def _tile(blocks: dict, spec: tuple, shape: dict) -> np.ndarray:
    """The whole leaf from every coordinate's block: along each cut
    dimension, blocks concatenated in the order of their index (the
    spec's axes, the first the major)."""
    def cat(coords_fixed: dict, dim: int):
        if dim == len(spec):
            return blocks[tuple(sorted(coords_fixed.items()))]
        axes = t_shd.entry_axes(spec[dim])
        if not axes:
            return cat(coords_fixed, dim + 1)
        parts = []
        for idx in itertools.product(*(range(shape[a]) for a in axes)):
            parts.append(cat({**coords_fixed, **dict(zip(axes, idx))}, dim + 1))
        return np.concatenate(parts, axis=dim)

    return cat({}, 0)


@pytest.mark.parametrize("spec", [(), ("data",), ("model", "data"), (None, ("data", "model")),
                                  (("pod", "data"), None, "model"), ("model", None, "pod")])
def test_shard_of_tiles_the_leaf(spec):
    shape = {"pod": 2, "data": 2, "model": 4}
    full = np.arange(8 * 16 * 4, dtype=np.float32).reshape(8, 16, 4)
    mesh = t_mesh.abstract_mesh(tuple(shape.values()), tuple(shape))
    blocks = {}
    for coords in itertools.product(*(range(n) for n in shape.values())):
        mesh.coords = dict(zip(shape, coords))
        block = t_shd.shard_of(full, spec, mesh).numpy()
        named = t_shd.named_axes(spec)
        key = tuple(sorted((a, c) for a, c in mesh.coords.items() if a in named))
        if key in blocks:  # the axes the spec leaves out hold copies
            np.testing.assert_array_equal(block, blocks[key])
        blocks[key] = block
    np.testing.assert_array_equal(_tile(blocks, spec, shape), full)


def test_shard_of_refuses_a_dimension_that_does_not_divide():
    mesh = t_mesh.abstract_mesh((2, 3), ("data", "model"))
    mesh.coords = {"data": 0, "model": 1}
    with pytest.raises(ValueError, match="does not divide into 3 blocks"):
        t_shd.shard_of(torch.zeros(4, 4), (None, "model"), mesh)
