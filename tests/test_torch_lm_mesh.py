"""The port's LM mesh on gloo process groups of CPU ranks, against the JAX
package's on virtual devices.

One module-scoped group of 4 ranks (``spawn``, a ``file://`` store under
the test's temporary directory) runs every case of ``_rank_cases`` and
writes its answers; one subprocess of the reference on 4 virtual CPU
devices (:func:`tests.conftest.run_in_virtual_mesh`, ``moe_ep``'s
``shard_map`` keyword renamed as ``tests/test_torch_mesh.py`` renames
it) runs the same cases.  Both read their inputs from one ``.npz`` the
parent writes from fixed seeds.  The cases:

* ``moe_block_ep`` at (data 2, model 1), (1, 2) and (2, 2) on reduced
  moonshot-v1-16b-a3b's widths, forward and every gradient of ``Σ y² +
  aux`` (f32 inputs; ``y`` comes out bf16 behind the bf16 ``model`` sum,
  in both packages);
* ``compressed_psum_tree`` over a 2-rank axis, two rounds of error
  feedback;
* the blocks ``shard_of`` cuts against the reference's ``NamedSharding``
  shards, device ``i`` against rank ``i``;
* the sharded train step on (2, 2), two f32 steps, for the reduced
  configs of ``ARCH_SEEDS``: qwen2-1.5b, moonshot-v1-16b-a3b,
  qwen2-vl-7b, rwkv6-3b, zamba2-2.7b, whisper-medium, minitron-4b (3
  heads: the attention stays whole, the MLP is cut) and qwen2-1.5b
  scaled to a vocabulary of 511 (the head stays whole); the vlm and audio
  batches carry seeded patches and frames, the same on every side.
  Loss, gradient norm and the gathered parameters against the
  reference's sharded step (``device_put`` with its shardings, the mesh
  installed) and against the port's unsharded step with ``accum = 2``;
* what a rank holds, gathers and projects in reduced qwen2-1.5b's
  sharded step (spies on ``train._to_compute``, ``train.all_gather``,
  ``layers.flash_attention`` and the vocabulary-parallel cross-entropy's
  chunk): no whole leaf that the model axis cuts, half the heads, half
  the vocabulary;
* checkpoints: a 4-rank save restored in the reference and in one
  process without a mesh, a reference save restored onto the 4 ranks,
  and 4 → 2 → 1 ranks: each restore's next step against the 4-rank
  run's.

Tolerances are ``tests/test_torch_lm_train.py``'s (f32 loss ``F32_RTOL``,
gradient norm and parameters ``UPD_RTOL`` with its sign-flip allowance)
except where a test states another and why.  Every f32 MoE comparison
first asserts the routing margin ``MARGIN`` of every token.
"""
import datetime
import json
import multiprocessing
import pickle
import time
import traceback
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.train import checkpoint as j_checkpoint
from repro.train import optimizer as j_opt
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import convert
from repro_torch.models import layers as t_layers
from repro_torch.models import model as t_model
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.optimizer import AdamWConfig, adamw_init, schedule
from repro_torch.train.pipeline import DataPipeline, PipelineConfig
from tests.conftest import run_in_virtual_mesh

WORLD = 4
SPAWN_TIMEOUT_S = 300
F32_RTOL, UPD_RTOL, FLIP_SHARE = 1e-5, 1e-4, 1e-3  # tests/test_torch_lm_train.py's
MARGIN = 1e-4  # tests/test_torch_lm_model.py's routing margin
GRAD_FLOOR = 1e-4  # chip_smoke.py's: 10**4 x AdamW's eps
EP_MESHES = ((2, 1), (1, 2), (2, 2))
# a case is a reduced config, or one scaled as "<arch>@vocab<V>"; seed 8:
# moonshot's routing margin 3.8e-4
ARCH_SEEDS = {"qwen2-1.5b": 2, "moonshot-v1-16b-a3b": 8, "qwen2-vl-7b": 2, "rwkv6-3b": 2,
              "zamba2-2.7b": 2, "whisper-medium": 2, "minitron-4b": 2, "qwen2-1.5b@vocab511": 2}
EP_SEED = 4
ROWS, SEQ, STEPS = 4, 32, 2
LR_KW = dict(lr=1e-3, warmup_steps=1, total_steps=4)
LAYOUT_SPECS = (("model", "data"), (None, ("data", "model")), ("data", None), (None, "model"), ())
PSUM_ROUNDS = 2
# y leaves the bf16 model sum: one bf16 rounding (2**-9 relative) of each
# expert's output, the same in both packages but for f32 partials that lie
# within a few f32 ulps of a bf16 rounding boundary
BF16_Y_TOL = 2.0**-8
# a MoE step's bounds where the bf16 gradient path above moves the result:
# the step-0 norm (measured 1.2e-4 against the reference), and after one
# update, which turns that noise into sign flips of near-zero gradients
# (about lr each), the loss (measured 6.6e-4), the norm (3.6e-3) and the
# parameters: each element within 2 x (Σ lr), and beyond 1e-3 (with a
# gradient above GRAD_FLOOR) on at most MOE_FLIP_SHARE of a leaf (measured
# 1.6 %, the router)
MOE_NORM0_RTOL, MOE_LOSS_RTOL, MOE_NORM_RTOL = 1e-3, 2e-3, 1e-2
MOE_PARAM_RTOL, MOE_FLIP_SHARE = 1e-3, 0.05
# the router's and the tokens' gradients pass the bf16 combine (y * gate,
# summed over k) and the gate's cotangent, a bf16 sum over d_model; XLA
# and torch accumulate those sums at different precisions, so each element
# may move by a few bf16 roundings of the largest: held to 2**-6 of the
# leaf's largest element (measured: 9.5e-3).  The expert gradients stay
# f32 (UPD_RTOL).
BF16_GRAD_TOL = 2.0**-6


def _ep_inputs() -> dict:
    """One reduced moonshot MoE layer and 64 tokens, f32."""
    cfg = get_config("moonshot-v1-16b-a3b", reduced=True)
    d, E, f = cfg.d_model, cfg.moe.n_experts, cfg.d_ff
    rng = np.random.default_rng(EP_SEED)
    return {
        "ep_router": (rng.normal(size=(d, E)) * d**-0.5).astype(np.float32),
        "ep_wg": (rng.normal(size=(E, d, f)) * d**-0.5).astype(np.float32),
        "ep_wu": (rng.normal(size=(E, d, f)) * d**-0.5).astype(np.float32),
        "ep_wd": (rng.normal(size=(E, f, d)) * f**-0.5).astype(np.float32),
        "ep_x": rng.normal(size=(64, d)).astype(np.float32),
    }


def _psum_inputs() -> dict:
    """Per round and rank, two gradient leaves (one bf16-valued)."""
    rng = np.random.default_rng(11)
    return {
        "cp_a": (rng.normal(size=(PSUM_ROUNDS, 2, 5, 7)) * 3).astype(np.float32),
        "cp_b": rng.normal(size=(PSUM_ROUNDS, 2, 33)).astype(np.float32),
    }


def _case(case: str) -> tuple[str, dict]:
    """(the arch, the ``cfg.scaled`` overrides) of a case of ``ARCH_SEEDS``."""
    arch, _, vocab = case.partition("@vocab")
    return arch, ({"vocab": int(vocab)} if vocab else {})


def _cfg(case: str):
    arch, overrides = _case(case)
    cfg = get_config(arch, reduced=True)
    return cfg.scaled(**overrides) if overrides else cfg


def _init_params(case: str) -> dict:
    cfg = _cfg(case)
    model = t_model.get_model(cfg, "cpu").init(torch.Generator().manual_seed(ARCH_SEEDS[case]))
    return {n: p.detach().numpy().copy() for n, p in model.params().items()}


def _stubs(cfg, step: int) -> dict:
    """Step ``step``'s seeded f32 vision patches (vlm) or audio frames
    (audio), every row its own; none for the other families."""
    rng = np.random.default_rng([31, step])
    if cfg.family == "vlm":
        return {"patches": rng.normal(size=(ROWS, cfg.vision_patches, cfg.d_model))
                .astype(np.float32)}
    if cfg.family == "audio":
        return {"frames": rng.normal(size=(ROWS, cfg.n_audio_ctx, cfg.d_model))
                .astype(np.float32)}
    return {}


def _batch(cfg, step: int) -> dict:
    return {**DataPipeline(PipelineConfig(cfg.vocab, SEQ, ROWS)).local_batch_at(step),
            **_stubs(cfg, step)}


def _margin(probs: np.ndarray, k: int) -> float:
    top = -np.sort(-probs, axis=-1)
    return float((top[:, k - 1] - top[:, k]).min())


# ---------------------------------------------------------------- ranks


def _rank_cases(rank: int, tmp: Path) -> dict:
    import torch.distributed as dist

    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import all_reduce, make_mesh
    from repro_torch.models import moe_ep, shard_ctx
    from repro_torch.train import compression
    from repro_torch.train.fault_tolerance import elastic_reshard

    data = dict(np.load(tmp / "inputs.npz"))
    t_model.ACT_DTYPE = torch.float32
    out: dict = {}

    # moe_block_ep: every rank of the mesh its tokens' rows, its experts
    cfg = get_config("moonshot-v1-16b-a3b", reduced=True)
    full = {k: torch.tensor(data["ep_" + k]) for k in ("router", "wg", "wu", "wd")}
    x_full = torch.tensor(data["ep_x"])
    for shape in EP_MESHES:
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        if mesh.coords is None:
            continue
        layout = {"router": (), "wg": ("data", None, "model"), "wu": ("data", None, "model"),
                  "wd": ("data", "model", None)}
        p = {k: shd.shard_of(v, layout[k], mesh).requires_grad_() for k, v in full.items()}
        x = shd.shard_of(x_full, ("data", None), mesh).requires_grad_()
        shard_ctx.set_mesh(mesh, "all")
        try:
            y, aux = t_layers.moe_block(p, x, cfg)
            ((y.float() ** 2).sum() + aux / shape[0]).backward()
        finally:
            shard_ctx.set_mesh(None)
        data_g = mesh.axis_group("data")
        grads = {
            "router": all_reduce(p["router"].grad, data_g),  # Σ over data ranks' tokens
            **{k: shd.gather(p[k].grad, layout[k], mesh) for k in ("wg", "wu", "wd")},
            "x": shd.gather(x.grad, ("data", None), mesh),
        }
        out[f"ep/{shape}"] = {"y": shd.gather(y.detach().float(), ("data", None), mesh).numpy(),
                              "y_dtype": str(y.dtype), "aux": float(aux),
                              "grads": {k: g.numpy() for k, g in grads.items()}}

    # compressed_psum_tree over the data group of a (2, 1) mesh
    mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
    if mesh.coords is not None:
        i = mesh.coords["data"]
        errs = None
        rounds = []
        for r in range(PSUM_ROUNDS):
            g = {"a": torch.tensor(data["cp_a"][r, i]), "b": torch.tensor(data["cp_b"][r, i])}
            errs = compression.init_error_buffers(g) if errs is None else errs
            red, errs = compression.compressed_psum_tree(g, errs, mesh.axis_group("data"))
            rounds.append({"reduced": {k: v.numpy() for k, v in red.items()},
                           "errs": {k: v.numpy() for k, v in errs.items()}})
        out["psum"] = rounds

    # the blocks of one leaf under each spec on (2, 2)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    leaf = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    out["layout"] = {str(spec): shd.shard_of(leaf, spec, mesh).numpy() for spec in LAYOUT_SPECS}
    out["gathered_back"] = all(
        torch.equal(shd.gather(shd.shard_of(leaf, spec, mesh), spec, mesh), leaf)
        for spec in LAYOUT_SPECS)

    # the sharded steps on (2, 2)
    calls = {"n": 0}
    ep = moe_ep.moe_block_ep

    def counted(*a, **kw):
        calls["n"] += 1
        return ep(*a, **kw)

    moe_ep.moe_block_ep = counted
    acfg = AdamWConfig(**LR_KW)
    out["spied"] = _spied_step(mesh, acfg)
    for arch, seed in ARCH_SEEDS.items():
        cfg = _cfg(arch)
        calls["n"] = 0
        model = train.shard_model(cfg, mesh, torch.Generator().manual_seed(seed))
        step = train.build_train_step(model, acfg, mesh=mesh)
        opt = adamw_init(model.params())
        losses, norms = [], []
        for s in range(STEPS):
            loss, m = step(opt, {k: torch.tensor(v) for k, v in _batch(cfg, s).items()})
            losses.append(float(loss))
            norms.append(float(m["grad_norm"]))
        whole = train.whole_params(model, mesh)
        specs = train.param_specs(cfg, mesh)
        out[f"step/{arch}"] = {"losses": losses, "norms": norms, "ep_calls": calls["n"],
                               "params": {n: t.numpy() for n, t in whole.items()},
                               "m": {n: shd.gather(t, specs[n], mesh).numpy()
                                     for n, t in opt["m"].items()}}
        if arch != "qwen2-1.5b":
            continue
        # checkpoints: save the 4-rank state, go on, then restore on 2 and on 1
        p_sh = shd.param_shardings(convert.param_shapes(cfg), cfg, mesh)
        shardings = (convert.nest(p_sh), {"m": convert.nest(p_sh), "step": shd.NamedSharding(mesh, ()),
                                          "v": convert.nest(p_sh)})
        Checkpointer(str(tmp / "ck4")).save(STEPS, train.state_tree(model.params(), opt),
                                            shardings=shardings)
        nexts = []
        for s in (STEPS, STEPS + 1):
            loss, m = step(opt, {k: torch.tensor(v) for k, v in _batch(cfg, s).items()})
            nexts.append((float(loss), float(m["grad_norm"])))
        out["ckpt/4"] = {"next": nexts, "specs": specs}
        # the reference's directory onto these 4 ranks
        ref_tree, ref_step = Checkpointer(str(tmp / "ref_ck")).restore(
            train.state_tree(model.params(), opt), shardings=shardings)
        out["ckpt/from_ref"] = {"step": ref_step, "params": {
            n: shd.gather(t, specs[n], mesh).numpy() for n, t in convert.flat(ref_tree[0]).items()},
            "step_leaf": int(ref_tree[1]["step"])}
        # elastic: 4 -> 2 ranks
        for shape, src, dst, s in (((2, 1), "ck4", "ck2", STEPS), ((1, 1), "ck2", None, STEPS + 1)):
            sub = make_mesh(shape, ("data", "model"), device="cpu")
            if sub.coords is None:
                continue
            small = train.shard_model(cfg, sub, torch.Generator().manual_seed(99))
            sopt = adamw_init(small.params())
            sub_sh = shd.param_shardings(convert.param_shapes(cfg), cfg, sub)
            sub_tree = (convert.nest(sub_sh), {"m": convert.nest(sub_sh),
                                               "step": shd.NamedSharding(sub, ()),
                                               "v": convert.nest(sub_sh)})
            tree, _ = Checkpointer(str(tmp / src)).restore(train.state_tree(small.params(), sopt),
                                                           shardings=sub_tree)
            train.load_state(small.params(), sopt, tree)
            sstep = train.build_train_step(small, acfg, mesh=sub)
            loss, m = sstep(sopt, {k: torch.tensor(v) for k, v in _batch(cfg, s).items()})
            out[f"ckpt/{shape}"] = (float(loss), float(m["grad_norm"]), int(sopt["step"]))
            if dst:
                Checkpointer(str(tmp / dst)).save(s + 1, train.state_tree(small.params(), sopt),
                                                  shardings=sub_tree)
        reshard = elastic_reshard({"a": np.arange(16.0).reshape(4, 4), "b": [np.ones(4)]},
                                  mesh, lambda path, leaf: ("model", "data") if path == ("a",)
                                  else ())
        out["elastic"] = {"a": reshard["a"].numpy(), "b": reshard["b"][0].numpy()}
    moe_ep.moe_block_ep = ep
    out["rank"] = dist.get_rank()
    return out


def _spied_step(mesh, acfg) -> dict:
    """One sharded step of reduced qwen2-1.5b with spies: per leaf, the
    shapes each ``all_gather`` of ``train._to_compute`` returned and the
    block the rank computed with; every q that reached
    ``layers.flash_attention``; every chunk's logits of the
    vocabulary-parallel cross-entropy."""
    cfg = get_config("qwen2-1.5b", reduced=True)
    model = train.shard_model(cfg, mesh, torch.Generator().manual_seed(ARCH_SEEDS["qwen2-1.5b"]))
    step = train.build_train_step(model, AdamWConfig(**LR_KW), mesh=mesh)
    opt = adamw_init(model.params())
    names = {p.data_ptr(): n for n, p in model.params().items()}
    leaves: dict = {}
    seen = {"leaf": None, "q": [], "logits": []}
    to_compute, gather = train._to_compute, train.all_gather
    flash, chunk = t_layers.flash_attention, t_layers._xent_chunk_cut

    def spy_to_compute(block, lay, mesh_):
        seen["leaf"] = names[block.data_ptr()]
        leaves[seen["leaf"]] = {"gathered": []}
        held = to_compute(block, lay, mesh_)
        leaves[seen["leaf"]]["held"] = tuple(held.shape)
        seen["leaf"] = None
        return held

    def spy_gather(t, group, dim):
        got = gather(t, group, dim)
        if seen["leaf"] is not None:
            leaves[seen["leaf"]]["gathered"].append(tuple(got.shape))
        return got

    def spy_flash(q, k, v, *a, **kw):
        seen["q"].append(tuple(q.shape))
        return flash(q, k, v, *a, **kw)

    def spy_chunk(hc, w, lc, cut):
        seen["logits"].append((*hc.shape[:-1], w.shape[-1]))
        return chunk(hc, w, lc, cut)

    train._to_compute, train.all_gather = spy_to_compute, spy_gather
    t_layers.flash_attention, t_layers._xent_chunk_cut = spy_flash, spy_chunk
    try:
        step(opt, {k: torch.tensor(v) for k, v in _batch(cfg, 0).items()})
    finally:
        train._to_compute, train.all_gather = to_compute, gather
        t_layers.flash_attention, t_layers._xent_chunk_cut = flash, chunk
    return {"leaves": leaves, "q": seen["q"], "logits": seen["logits"], "held": step.held}


def _rank_main(rank: int, tmp: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=180))
    try:
        answers = _rank_cases(rank, Path(tmp))
        with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
            pickle.dump(answers, f)
    except BaseException:
        with open(f"{tmp}/rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _spawn(tmp: Path) -> tuple[list[dict], float]:
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_rank_main, args=(r, str(tmp)), daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = t0 + SPAWN_TIMEOUT_S
    for p in procs:
        p.join(timeout=max(deadline - time.perf_counter(), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    errors = {r: (tmp / f"rank{r}.err").read_text() for r in range(WORLD)
              if (tmp / f"rank{r}.err").exists()}
    codes = [p.exitcode for p in procs]
    if hung or errors or any(codes):
        raise AssertionError(f"gloo group of {WORLD}: hung ranks {hung}, exit codes {codes}\n"
                             + "\n".join(f"rank {r}:\n{e}" for r, e in errors.items()))
    answers = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            answers.append(pickle.load(f))
    return answers, time.perf_counter() - t0


# ---------------------------------------------------------------- the reference

_REFERENCE = r"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import repro.models.moe_ep as moe_ep


def shard_map(f, *, check_rep=True, **kwargs):
    return jax.shard_map(f, check_vma=check_rep, **kwargs)


moe_ep.shard_map = shard_map
from repro.configs import get_config
from repro.launch import sharding as shd
from repro.launch import train as j_train
from repro.models import layers as L
from repro.models import model as j_model
from repro.models import shard_ctx
from repro.train import compression
from repro.train import optimizer as j_opt
from repro.train.pipeline import DataPipeline, PipelineConfig

args = json.load(sys.stdin)
data = dict(np.load(args["tmp"] + "/inputs.npz"))
j_model.ACT_DTYPE = jnp.float32
arrays, scalars = {}, {}


def mesh_of(shape, axes=("data", "model")):
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), axes)


def nest(flat):
    out = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(flat(tree[k], prefix + k + "."))
        else:
            out[prefix + k] = tree[k]
    return out


cfg = get_config("moonshot-v1-16b-a3b", reduced=True)
p = {k: data["ep_" + k] for k in ("router", "wg", "wu", "wd")}
x = data["ep_x"]
for shape in args["ep_meshes"]:
    shard_ctx.set_mesh(mesh_of(tuple(shape)), "all")

    def loss(p, x):
        y, aux = L.moe_block(p, x, cfg)
        return jnp.sum(jnp.square(y.astype(jnp.float32))) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(p, x)
    key = str(tuple(shape))
    arrays[f"ep/{key}/y"] = np.asarray(y.astype(jnp.float32))
    scalars[f"ep/{key}/y_dtype"] = str(y.dtype)
    scalars[f"ep/{key}/aux"] = float(aux)
    for k, g in {**gp, "x": gx}.items():
        arrays[f"ep/{key}/grad/{k}"] = np.asarray(g)
    shard_ctx.set_mesh(None)

mesh2 = mesh_of((2,), ("data",))


def psum_round(g, e):
    red, e2 = compression.compressed_psum_tree(
        jax.tree.map(lambda t: t[0], g), jax.tree.map(lambda t: t[0], e), "data")
    return jax.tree.map(lambda t: t[None], red), jax.tree.map(lambda t: t[None], e2)


fn = jax.jit(shard_map(psum_round, mesh=mesh2, in_specs=(P("data"), P("data")),
                       out_specs=(P("data"), P("data")), check_rep=False))
errs = None
for r in range(data["cp_a"].shape[0]):
    g = {"a": data["cp_a"][r], "b": data["cp_b"][r]}
    errs = jax.tree.map(jnp.zeros_like, g) if errs is None else errs
    red, errs = fn(g, errs)
    for k in g:
        arrays[f"psum/{r}/reduced/{k}"] = np.asarray(red[k])
        arrays[f"psum/{r}/errs/{k}"] = np.asarray(errs[k])

mesh = mesh_of((2, 2))
leaf = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
for spec in args["layout_specs"]:
    spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
    arr = jax.device_put(leaf, NamedSharding(mesh, P(*spec)))
    for s in arr.addressable_shards:
        arrays[f"layout/{spec}/{s.device.id}"] = np.asarray(s.data)

for arch, base, overrides in args["archs"]:
    cfg = get_config(base, reduced=True)
    cfg = cfg.scaled(**overrides) if overrides else cfg
    model = j_model.get_model(cfg)
    params = nest({k[len("init/" + arch + "/"):]: v for k, v in data.items()
                   if k.startswith("init/" + arch + "/")})
    shard_ctx.set_mesh(mesh, "all")
    p_sh = shd.param_shardings(params, cfg, mesh)
    opt = j_opt.adamw_init(params)
    o_sh = shd.opt_shardings(opt, p_sh, mesh)
    params, opt = jax.device_put(params, p_sh), jax.device_put(opt, o_sh)
    step = j_train.build_train_step(model, j_opt.AdamWConfig(**args["lr_kw"]))
    pipe = DataPipeline(PipelineConfig(cfg.vocab, args["seq"], args["rows"]))
    losses, norms = [], []
    for s in range(args["steps"]):
        batch = {k: jnp.asarray(v) for k, v in pipe.local_batch_at(s).items()}
        for k in ("patches", "frames"):
            if f"stub/{arch}/{s}/{k}" in data:
                batch[k] = jnp.asarray(data[f"stub/{arch}/{s}/{k}"])
        batch = jax.device_put(batch, shd.batch_shardings(batch, mesh))
        params, opt, loss, metrics = step(params, opt, batch)
        losses.append(float(loss))
        norms.append(float(metrics["grad_norm"]))
    shard_ctx.set_mesh(None)
    scalars[f"step/{arch}/losses"] = losses
    scalars[f"step/{arch}/norms"] = norms
    leaf = params["layers"]["attn"]["wq"]["w"] if "attn" in params["layers"] else params["embed"]
    scalars[f"step/{arch}/sharding"] = str(leaf.sharding.spec)
    for name, v in flat(jax.tree.map(np.asarray, params)).items():
        arrays[f"step/{arch}/params/{name}"] = v

np.savez(args["tmp"] + "/reference.npz", **arrays)
print(json.dumps(scalars))
"""


@pytest.fixture(scope="module")
def tmp(tmp_path_factory) -> Path:
    """The inputs every side reads: ``inputs.npz`` and a checkpoint the
    reference wrote (``ref_ck``: random reduced qwen2-1.5b parameters and
    AdamW state at step 5)."""
    tmp = tmp_path_factory.mktemp("lm_mesh")
    arrays = {**_ep_inputs(), **_psum_inputs()}
    for arch in ARCH_SEEDS:
        arrays.update({f"init/{arch}/{n}": v for n, v in _init_params(arch).items()})
        for s in range(STEPS):
            arrays.update({f"stub/{arch}/{s}/{k}": v for k, v in _stubs(_cfg(arch), s).items()})
    np.savez(tmp / "inputs.npz", **arrays)
    cfg = get_config("qwen2-1.5b", reduced=True)
    rng = np.random.default_rng(21)
    tree = {n: rng.normal(size=s).astype(np.float32) for n, s in convert.param_shapes(cfg).items()}
    opt = {k: convert.nest({n: rng.random(s).astype(np.float32)
                            for n, s in convert.param_shapes(cfg).items()}) for k in ("m", "v")}
    opt["step"] = np.int32(5)
    j_checkpoint.Checkpointer(str(tmp / "ref_ck")).save(5, (convert.nest(tree), opt),
                                                        blocking=True)
    np.savez(tmp / "ref_ck_whole.npz", **tree)
    return tmp


@pytest.fixture(scope="module")
def group(tmp):
    answers, seconds = _spawn(tmp)
    print(f"gloo group of {WORLD} CPU ranks: {seconds:.1f} s")
    return answers


@pytest.fixture(scope="module")
def reference(tmp):
    args = {"tmp": str(tmp), "ep_meshes": [list(s) for s in EP_MESHES],
            "layout_specs": [[list(e) if isinstance(e, tuple) else e for e in s]
                             for s in LAYOUT_SPECS],
            "archs": [(case, *_case(case)) for case in ARCH_SEEDS], "lr_kw": LR_KW, "seq": SEQ, "rows": ROWS, "steps": STEPS}
    scalars = run_in_virtual_mesh(_REFERENCE, devices=WORLD, timeout=600, stdin=json.dumps(args))
    return scalars, dict(np.load(tmp / "reference.npz"))


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded step with ``accum = 2`` (f32) from the same
    parameters on the same batches, and every router softmax it computed."""
    before = t_model.ACT_DTYPE
    t_model.ACT_DTYPE = torch.float32
    route = t_layers.moe_route
    probs = []

    def spy(p, x, cfg):
        r = route(p, x, cfg)
        probs.append(r.probs.detach().numpy().copy())
        return r

    t_layers.moe_route = spy
    out = {}
    try:
        for arch, seed in ARCH_SEEDS.items():
            cfg = _cfg(arch)
            probs.clear()
            model = t_model.get_model(cfg, "cpu").init(torch.Generator().manual_seed(seed))
            step = train.build_train_step(model, AdamWConfig(**LR_KW), accum=2)
            opt = adamw_init(model.params())
            losses, norms = [], []
            for s in range(STEPS):
                loss, m = step(opt, {k: torch.tensor(v) for k, v in _batch(cfg, s).items()})
                losses.append(float(loss))
                norms.append(float(m["grad_norm"]))
            out[arch] = {"losses": losses, "norms": norms, "probs": list(probs),
                         "params": {n: p.detach().numpy().copy()
                                    for n, p in model.params().items()},
                         "m": {n: t.numpy().copy() for n, t in opt["m"].items()}}
    finally:
        t_layers.moe_route = route
        t_model.ACT_DTYPE = before
    return out


def _lr_sum(steps: int) -> float:
    return sum(float(schedule(AdamWConfig(**LR_KW), s)) for s in range(1, steps + 1))


def _params_close(got: dict, want: dict, m: dict, lr_steps: float, rtol=UPD_RTOL,
                  share=FLIP_SHARE):
    """Leaf by leaf: every element within 2 x (Σ lr) (one Adam step moves
    an element by about lr x sign(g), and a gradient that is zero up to
    rounding may take either sign), and, where AdamW's first moment says
    the gradient is not near zero (|m| / (1 - b1) > ``GRAD_FLOOR``, leg
    18's rule), within ``rtol`` on all but ``share`` of the leaf."""
    b1 = AdamWConfig().b1
    for name, w in want.items():
        g = np.asarray(got[name], np.float32)
        w = np.asarray(w, np.float32)
        above = np.abs(m[name]) / (1 - b1) > GRAD_FLOOR
        off = ~np.isclose(g, w, rtol=rtol, atol=rtol * np.abs(w).max()) & above
        assert off.mean() <= share, (name, off.mean())
        assert np.abs(g - w).max() <= 2 * lr_steps * (1 + 1e-3), name


# ---------------------------------------------------------------- tests


@pytest.mark.parametrize("shape", EP_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_block_ep_forward_and_gradients_equal_the_reference(shape, group, reference):
    cfg = get_config("moonshot-v1-16b-a3b", reduced=True)
    inputs = _ep_inputs()
    probs = torch.softmax(torch.tensor(inputs["ep_x"]) @ torch.tensor(inputs["ep_router"]), -1)
    assert _margin(probs.numpy(), cfg.moe.top_k) > MARGIN
    scalars, arrays = reference
    key = str(shape)
    got = group[0][f"ep/{key}"]
    for r in group[1:shape[0] * shape[1]]:
        np.testing.assert_array_equal(r[f"ep/{key}"]["y"], got["y"])
    assert got["y_dtype"] == "torch.bfloat16" and scalars[f"ep/{key}/y_dtype"] == "bfloat16"
    want_y = arrays[f"ep/{key}/y"]
    # BF16_Y_TOL: a partial within f32 rounding of a bf16 boundary rounds to
    # the neighbouring bf16 value in one package
    np.testing.assert_allclose(got["y"], want_y, rtol=BF16_Y_TOL, atol=BF16_Y_TOL)
    assert (got["y"] != want_y).mean() <= FLIP_SHARE
    np.testing.assert_allclose(got["aux"], scalars[f"ep/{key}/aux"], rtol=F32_RTOL)
    for k in ("router", "wg", "wu", "wd", "x"):
        g, w = got["grads"][k], arrays[f"ep/{key}/grad/{k}"]
        assert g.shape == w.shape, k
        tol = BF16_GRAD_TOL if k in ("router", "x") else UPD_RTOL
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * np.abs(w).max(), err_msg=k)


def test_compressed_psum_tree_equals_the_reference(group, reference):
    """The reference runs inside a jitted ``shard_map``, where XLA fuses
    ``corrected - q * scale`` into one multiply-add: its new error buffer
    differs from the port's (and from its own eager ``compress``, which
    ``tests/test_torch_lm_sharding.py`` holds bit for bit) by up to an f32
    ulp of the leaf's largest value (measured: one ulp).  Round 0's sums are bit for bit; in round
    1 that difference can move a quantised value by one step on a few
    elements, so each sum and error is held within one step there.  Every
    sum is also held to the int8 bound around the plain mean of the
    corrected gradients: rank i's ``q_i`` is within half a step of its own
    scale ``s_i`` and is dequantised with the largest, ``s_max``."""
    _, arrays = reference
    inputs = _psum_inputs()
    for r in range(PSUM_ROUNDS):
        for k in ("a", "b"):
            corrected = [inputs[f"cp_{k}"][r, j] + (group[j]["psum"][r - 1]["errs"][k] if r else 0)
                         for j in range(2)]
            scales = [np.abs(c).max() / np.float32(127.0) for c in corrected]
            bound = sum(np.abs(np.round(c / sc)) * (max(scales) - sc) + sc / 2
                        for c, sc in zip(corrected, scales)) / 2
            plain = (corrected[0] + corrected[1]) / 2
            for i in range(2):
                got = group[i]["psum"][r]
                want = arrays[f"psum/{r}/reduced/{k}"][i]
                err = arrays[f"psum/{r}/errs/{k}"][i]
                fma = 2.0**-23 * np.abs(corrected[i]).max()  # an f32 ulp of the largest
                if r == 0:
                    assert got["reduced"][k].tobytes() == want.tobytes(), (r, i, k)
                    assert np.abs(got["errs"][k] - err).max() <= fma, (r, i, k)
                else:
                    step = max(scales)
                    assert np.abs(got["reduced"][k] - want).max() <= step * (1 + 1e-5), (r, i, k)
                    assert (got["reduced"][k] != want).mean() <= 0.05, (r, i, k)
                    assert np.abs(got["errs"][k] - err).max() <= step * (1 + 1e-5) + fma
                assert (np.abs(got["reduced"][k] - plain) <= bound * (1 + 1e-5) + 1e-7).all()


def test_blocks_are_the_references_shards(group, reference):
    _, arrays = reference
    for rank, answer in enumerate(group):
        assert answer["gathered_back"]
        for spec in LAYOUT_SPECS:
            want = arrays[f"layout/{spec}/{rank}"]
            np.testing.assert_array_equal(answer["layout"][str(spec)], want)


def _steps_close(got: dict, want: dict, m: dict, moe: bool) -> None:
    """Losses, norms and parameters: ``tests/test_torch_lm_train.py``'s f32
    bounds, or for MoE the ``MOE_*`` bounds after the first step."""
    np.testing.assert_allclose(got["losses"][0], want["losses"][0], rtol=F32_RTOL if not moe
                               else 1e-4)
    if not moe:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=F32_RTOL)
        np.testing.assert_allclose(got["norms"], want["norms"], rtol=UPD_RTOL)
        _params_close(got["params"], want["params"], m, _lr_sum(STEPS))
        return
    np.testing.assert_allclose(got["norms"][0], want["norms"][0], rtol=MOE_NORM0_RTOL)
    np.testing.assert_allclose(got["losses"][1:], want["losses"][1:], rtol=MOE_LOSS_RTOL)
    np.testing.assert_allclose(got["norms"][1:], want["norms"][1:], rtol=MOE_NORM_RTOL)
    _params_close(got["params"], want["params"], m, _lr_sum(STEPS), rtol=MOE_PARAM_RTOL,
                  share=MOE_FLIP_SHARE)


@pytest.mark.parametrize("arch", ARCH_SEEDS)
def test_sharded_step_equals_the_references_sharded_step(arch, group, reference, unsharded):
    """Both packages run the experts expert-parallel with the bf16
    ``model`` sum; MoE bounds as ``_steps_close`` states (step 0's loss
    within 1e-4: measured 1.4e-6)."""
    cfg = _cfg(arch)
    if cfg.moe:
        margins = [_margin(p, cfg.moe.top_k) for p in unsharded[arch]["probs"]]
        assert margins and min(margins) > MARGIN, min(margins)
    scalars, arrays = reference
    got = group[0][f"step/{arch}"]
    for r in group[1:]:  # every rank holds the same loss and norm
        assert r[f"step/{arch}"]["losses"] == got["losses"]
        assert r[f"step/{arch}"]["norms"] == got["norms"]
    assert (got["ep_calls"] > 0) == bool(cfg.moe)
    # the reference's step kept the layout the port's rules give
    specs = train.param_specs(cfg, abstract_mesh((2, 2), ("data", "model")))
    spec = specs.get("layers.attn.wq.w", specs["embed"])
    assert scalars[f"step/{arch}/sharding"] == f"PartitionSpec({', '.join(map(repr, spec))})"
    prefix = f"step/{arch}/params/"
    want = {"losses": scalars[f"step/{arch}/losses"], "norms": scalars[f"step/{arch}/norms"],
            "params": {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}}
    assert sorted(want["params"]) == sorted(got["params"])
    _steps_close(got, want, got["m"], bool(cfg.moe))


@pytest.mark.parametrize("arch", ARCH_SEEDS)
def test_sharded_step_equals_the_unsharded_accum_step(arch, group, unsharded):
    """A data axis of 2 is ``accum = 2``: micro-batch ``i`` is data rank
    ``i``'s rows, and MoE capacity is per micro-batch as it is per rank.
    For MoE the experts' outputs pass the bf16 ``model`` sum on the mesh
    and stay f32 unsharded, the only expected gap (step 0's loss
    measured 5.3e-5, within 1e-4)."""
    cfg = _cfg(arch)
    got, want = group[0][f"step/{arch}"], unsharded[arch]
    _steps_close(got, want, want["m"], bool(cfg.moe))


def test_a_4_rank_checkpoint_restores_in_the_reference_and_in_one_process(tmp, group):
    cfg = get_config("qwen2-1.5b", reduced=True)
    saved = group[0]["step/qwen2-1.5b"]["params"]
    ck = tmp / "ck4"
    assert Checkpointer(str(ck)).steps() == [STEPS]
    model = t_model.get_model(cfg, "cpu")
    opt = adamw_init(model.params())
    tree, step = Checkpointer(str(ck)).restore(train.state_tree(model.params(), opt))
    assert step == STEPS and int(tree[1]["step"]) == STEPS
    for name, t in convert.flat(tree[0]).items():
        assert t.numpy().tobytes() == saved[name].tobytes(), name
    shapes = convert.param_shapes(cfg)
    template = (convert.nest({n: np.zeros(s, np.float32) for n, s in shapes.items()}),
                j_opt.adamw_init(convert.nest({n: np.zeros(s, np.float32)
                                               for n, s in shapes.items()})))
    (rp, ro), rstep = j_checkpoint.Checkpointer(str(ck)).restore(template)
    assert rstep == STEPS and int(ro["step"]) == STEPS
    for name, v in convert.flat(jax.tree.map(np.asarray, rp)).items():
        assert v.tobytes() == saved[name].tobytes(), name
    np.testing.assert_array_equal(convert.flat(jax.tree.map(np.asarray, ro["m"]))["embed"],
                                  convert.flat(tree[1]["m"])["embed"].numpy())


def test_a_reference_checkpoint_restores_onto_4_ranks(tmp, group):
    want = dict(np.load(tmp / "ref_ck_whole.npz"))
    got = group[0]["ckpt/from_ref"]
    assert got["step"] == 5 and got["step_leaf"] == 5
    assert sorted(got["params"]) == sorted(want)
    for name, v in want.items():
        assert got["params"][name].tobytes() == v.tobytes(), name


def test_reshard_4_to_2_to_1_ranks_continues_the_4_rank_run(group):
    nexts = group[0]["ckpt/4"]["next"]
    two, one = group[0]["ckpt/(2, 1)"], group[0]["ckpt/(1, 1)"]
    assert group[1]["ckpt/(2, 1)"][:2] == two[:2]
    assert two[2] == STEPS + 1 and one[2] == STEPS + 2  # AdamW's counter went on
    for (loss, norm, _), (want_l, want_n) in ((two, nexts[0]), (one, nexts[1])):
        np.testing.assert_allclose(loss, want_l, rtol=F32_RTOL)
        np.testing.assert_allclose(norm, want_n, rtol=UPD_RTOL)


def test_elastic_reshard_keeps_each_ranks_block(group):
    a = np.arange(16.0).reshape(4, 4)
    for rank, answer in enumerate(group):
        data, model = divmod(rank, 2)
        np.testing.assert_array_equal(answer["elastic"]["a"],
                                      a[model * 2:(model + 1) * 2, data * 2:(data + 1) * 2])
        np.testing.assert_array_equal(answer["elastic"]["b"], np.ones(4))


def test_a_rank_computes_with_its_heads_ffn_columns_and_vocabulary(group):
    """Reduced qwen2-1.5b on (2, 2): no rank holds or gathers a whole
    ``wq``, ``wo``, ``wg``, ``wu``, ``wd`` or ``embed`` leaf (each rank
    computes with half of each), q has 3 of the 6 heads and the logits
    256 of the 512 columns; ``wk`` and ``wv`` are projected whole."""
    cfg = get_config("qwen2-1.5b", reduced=True)
    shapes = convert.param_shapes(cfg)
    cut = ["embed"] + [n for n in shapes
                       if n.endswith(".w") and n.split(".")[-2] in ("wq", "wo", "wg", "wu", "wd")]
    assert len(cut) == 6
    for answer in group:
        spied = answer["spied"]
        for name in cut:
            leaf = spied["leaves"][name]
            assert 2 * int(np.prod(leaf["held"])) == int(np.prod(shapes[name])), (name, leaf)
            assert shapes[name] not in leaf["gathered"], (name, leaf)
        for name in ("layers.attn.wk.w", "layers.attn.wv.w"):
            assert spied["leaves"][name]["held"] == shapes[name]
        assert spied["q"] and {q[2] for q in spied["q"]} == {3}
        assert spied["logits"] and {lg[-1] for lg in spied["logits"]} == {256}
        assert spied["held"]["dense"] < spied["held"]["whole"]
