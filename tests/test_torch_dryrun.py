"""The port's LM dry run (``launch/dryrun.py:run_cell``), its analysis
(``launch/hlo_analysis.py``) and its LM roofline (``launch/roofline.py``),
against the JAX package's and against a real run of the same cells.

Each fake world runs in a subprocess of its own (a process group is
process-wide, and ``--dist loadfile`` runs many files in one worker); the
three sides below start together and run at once:

* **the port, dry**: one subprocess runs ``run_cell`` on every case of
  ``CELLS`` (reduced configs, ``ROWS`` × ``SEQ`` tokens, on (data 2,
  model 2): each on a fake world of 4 ranks, fake CPU tensors), then one
  full-size production cell, qwen2-1.5b × decode_32k × single (256 fake
  ranks), a ``long_500k`` cell of a pure full-attention arch (skipped) and
  a serving cell on the multi-pod mesh (the port's refusal, recorded);
* **the port, real**: the same cases by ``measure_cell`` on a gloo group
  of 4 CPU ranks (``tests/test_torch_lm_mesh.py``'s launcher), rank 0's
  numbers;
* **the reference**: the same cases through the reference's
  ``build_cell``, ``.lower().compile()`` and ``hlo_analysis.analyze`` on 4
  virtual CPU devices, its ``get_config`` and ``SHAPES`` patched to the
  reduced ones in that subprocess only; its ``_summarize`` on one list.

What is held: the pure functions (``model_flops`` for every arch and
shape, ``ring_traffic`` for every kind at k in ``RING_KS``, ``_summarize``)
equal the reference's exactly.  Dry equals real: the collective log entry
for entry (kind, result bytes, group size, axis, member span),
``dot_flops``, and every argument block's bytes.  Against the reference:
each argument block's bytes equal its per-device shard's, but for the
blocks ``_argument_difference`` names with the reason; the ratio of the
port's ``dot_flops`` to the reference's within ``FLOP_BAND``; collective
bytes by kind printed side by side and not compared (GSPMD chooses its
own collectives).

``FLOP_BAND`` = [0.75, 1.60], written before this file's first run, from
these known sources (an earlier probe of both packages measured 1.116
for dense train, 1.053 for dense decode and 1.248 for moe train at 4 × 64
tokens):

* every family: both sides recompute each layer's forward in the backward
  (``torch.utils.checkpoint``; the reference's ``jax.checkpoint`` in a
  scan), both count only matmul-family work; XLA may drop or merge dots
  the eager port runs (a recompute it can prove dead, a product of
  broadcasts);
* dense: the port's vocabulary-parallel cross-entropy runs each chunk's
  head product under ``checkpoint``, so its backward recomputes it; the
  eager chunked attention computes whole chunks, masked positions
  included (at ``SEQ`` one chunk: the whole square, as the reference's);
* moe: the port computes every expert slot of the capacity C, empty slots
  included, and routes the whole batch's tokens again in the recompute;
  the reference's dispatch and combine may be one-hot products that XLA
  counts as dots (below 1 if they outweigh the rest);
* ssm and hybrid: each chunk's intra-chunk products and state products at
  once (``models/ssm.py``), where the reference's scan may form other
  products of the same recurrence;
* audio: the encoder's and decoder's layers as dense; cross-attention
  keys and values projected once a call;
* prefill and decode: no backward; the meshed decode attends the rank's
  positions and combines them (``layers.attend_cached``).
"""
import json
import math
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from repro.launch import roofline as j_roofline
from repro_torch.configs import ARCHS
from repro_torch.launch import roofline
from repro_torch.models.config import SHAPES
from tests.conftest import REPO_ROOT, run_in_virtual_mesh
from tests.test_torch_lm_mesh import _spawn

MESH_SHAPE = (2, 2)
ROWS, SEQ = 4, 64
# (arch, shape kind) of each case, every one reduced
CELLS = {"qwen2-1.5b/train": ("qwen2-1.5b", "train"),
         "moonshot-v1-16b-a3b/train": ("moonshot-v1-16b-a3b", "train"),
         "rwkv6-3b/train": ("rwkv6-3b", "train"),
         "zamba2-2.7b/train": ("zamba2-2.7b", "train"),
         "whisper-medium/train": ("whisper-medium", "train"),
         "qwen2-vl-7b/train": ("qwen2-vl-7b", "train"),
         "qwen2-1.5b/prefill": ("qwen2-1.5b", "prefill"),
         "qwen2-1.5b/decode": ("qwen2-1.5b", "decode"),
         "rwkv6-3b/prefill": ("rwkv6-3b", "prefill"),
         "rwkv6-3b/decode": ("rwkv6-3b", "decode")}
FLOP_BAND = (0.75, 1.60)
RING_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
RING_KS = (1, 2, 16, 32, 512)
SUMMARY_LIST = [{"kind": "all-gather", "bytes": 1024.0, "group": 16},
                {"kind": "all-reduce", "bytes": 8.0, "group": 2},
                {"kind": "all-gather", "bytes": 4096.0, "group": 16},
                {"kind": "all-to-all", "bytes": 512.0, "group": 16}]
TIMEOUT_S = 600


def _shape_args(kind: str) -> tuple[str, str, int, int]:
    """The reduced shape of a case: (name, kind, positions, rows); a decode
    reads a cache of ``SEQ`` positions."""
    return (f"{kind}_reduced", kind, SEQ, ROWS)


# ---------------------------------------------------------------- the port, dry

_DRY = r"""
import json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models.config import ShapeConfig

with open(sys.argv[1]) as f:
    job = json.load(f)
out = {}
for name, (arch, kind, shape) in job["cells"].items():
    rec = dryrun.run_cell(arch, shape[0], "single", job["hlo"] + "/" + name.replace("/", "__"),
                          cfg=get_config(arch, reduced=True), shape=ShapeConfig(*shape),
                          mesh_shape=tuple(job["mesh"]), device="cpu")
    out[name] = rec
out["full/decode_32k"] = dryrun.run_cell("qwen2-1.5b", "decode_32k", "single", device="cpu")
out["full/long_500k"] = dryrun.run_cell("qwen2-1.5b", "long_500k", "single", device="cpu")
out["multi/decode"] = dryrun.run_cell(
    "qwen2-1.5b", "decode_reduced", "multi", cfg=get_config("qwen2-1.5b", reduced=True),
    shape=ShapeConfig("decode_reduced", "decode", 64, 4), mesh_shape=(2, 1, 2), device="cpu")
print(json.dumps(out))
"""


# ---------------------------------------------------------------- the port, real

def _real_rank(rank: int, tmp: str) -> None:
    """One rank of the gloo group: every case of ``CELLS`` by
    ``measure_cell``, the rank's numbers to ``rank<r>.pkl``."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.config import ShapeConfig

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=math.prod(MESH_SHAPE),
                            timeout=datetime.timedelta(seconds=180))
    try:
        mesh = make_mesh(MESH_SHAPE, ("data", "model"), device="cpu")
        out = {}
        for name, (arch, kind) in CELLS.items():
            shape = ShapeConfig(*_shape_args(kind))
            _, got = dryrun.measure_cell(arch, shape.name, mesh,
                                         cfg=get_config(arch, reduced=True), shape=shape)
            out[name] = {k: got[k] for k in ("dot_flops", "collectives", "argument_leaves",
                                              "memory", "collectives_by_kind")}
        with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(f"{tmp}/rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- the reference

_REFERENCE = r"""
import json, math, sys

import jax

jax.devices()  # 4 virtual devices, before launch/dryrun.py's import sets 512
import numpy as np
from jax.sharding import Mesh

import repro.launch.dryrun as D
from repro.configs import get_config
from repro.launch import hlo_analysis
from repro.models.config import ShapeConfig

job = json.loads(sys.stdin.read())
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))


def leaves(tree, prefix):
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        shard = s.sharding.shard_shape(s.shape)
        out[prefix + name] = int(math.prod(shard)) * s.dtype.itemsize
    return out


out = {"summary": D._summarize(job["summary"])}
for name, (arch, kind, shape) in job["cells"].items():
    D.get_config = lambda a, _arch=arch: get_config(_arch, reduced=True)
    D.SHAPES = {shape[0]: ShapeConfig(*shape)}
    fn, args = D.build_cell(arch, shape[0], mesh)
    compiled = fn.lower(*args).compile()
    deep = hlo_analysis.analyze(compiled.as_text())
    if kind == "train":
        params, opt, batch = args
        named = {**leaves(params, "params/"), **leaves(opt["m"], "opt/m/"),
                 **leaves(opt["v"], "opt/v/"), **leaves(opt["step"], "opt/step"),
                 **leaves(batch, "batch/")}
    elif kind == "prefill":
        params, batch = args
        named = {**leaves(params, "params/"), **leaves(batch, "batch/")}
    else:
        params, cache, tokens, pos = args
        named = {**leaves(params, "params/"), **leaves(cache, "cache/"),
                 **leaves(tokens, "batch/tokens"), **leaves(pos, "pos")}
    out[name] = {"dot_flops": deep["dot_flops"], "argument_leaves": named,
                 "argument_size_in_bytes": int(compiled.memory_analysis().argument_size_in_bytes),
                 "collectives_by_kind": deep["collectives_by_kind"]}
print(json.dumps(out))
"""


# ---------------------------------------------------------------- fixtures

def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO_ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(the dry records, every rank's real numbers, the reference's, the
    temporary directory), the three sides run at once."""
    tmp = tmp_path_factory.mktemp("dryrun")
    cells = {name: (arch, kind, _shape_args(kind)) for name, (arch, kind) in CELLS.items()}
    (tmp / "job.json").write_text(
        json.dumps({"cells": cells, "mesh": MESH_SHAPE, "hlo": str(tmp / "hlo")}))
    dry = subprocess.Popen([sys.executable, "-c", _DRY, str(tmp / "job.json")],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                           env=_env(), cwd=REPO_ROOT)

    ref: dict = {}

    def reference():
        ref["out"] = run_in_virtual_mesh(
            _REFERENCE, devices=4, timeout=TIMEOUT_S,
            stdin=json.dumps({"cells": cells, "summary": SUMMARY_LIST}))

    worker = threading.Thread(target=reference)
    worker.start()
    real = _spawn(tmp, _real_rank)[0]
    worker.join(TIMEOUT_S)
    stdout, stderr = dry.communicate(timeout=TIMEOUT_S)
    assert dry.returncode == 0, stderr[-4000:]
    assert not worker.is_alive() and "out" in ref, "the reference's subprocess did not finish"
    return json.loads(stdout.strip().splitlines()[-1]), real, ref["out"], tmp


# ---------------------------------------------------------------- pure functions

@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equals_the_references(arch):
    for shape in SHAPES:
        assert roofline.model_flops(arch, shape) == j_roofline.model_flops(arch, shape), shape


@pytest.mark.parametrize("kind", RING_KINDS)
def test_ring_traffic_equals_the_references(kind):
    for k in RING_KS:
        assert roofline.ring_traffic(kind, 12345.0, k) == j_roofline.ring_traffic(kind, 12345.0, k)


def test_summarize_equals_the_references(sides):
    from repro_torch.launch import dryrun

    assert dryrun._summarize(SUMMARY_LIST) == sides[2]["summary"]


def test_the_link_follows_the_span_of_the_ranks():
    """On (16, 16) a model group of 16 spans 2 nodes of 8 and a data group
    16; on (2, 2) every group shares a node."""
    assert roofline.link_bw([0, 15]) == roofline.IB_BW
    assert roofline.link_bw([0, 240]) == roofline.IB_BW
    assert roofline.link_bw([0, 7]) == roofline.NVLINK_BW
    assert roofline.link_bw([8, 10]) == roofline.NVLINK_BW
    colls = [{"kind": "all-gather", "bytes": 16e6, "group": 16, "ranks": [0, 15]},
             {"kind": "all-reduce", "bytes": 4e6, "group": 2, "ranks": [0, 2]}]
    want = 15 / 16 * 16e6 / roofline.IB_BW + 4e6 / roofline.NVLINK_BW
    assert roofline.collective_seconds(colls) == pytest.approx(want, rel=1e-12)


# ---------------------------------------------------------------- dry = real

def _log(colls: list[dict]) -> list[tuple]:
    return [(c["kind"], c["bytes"], c["group"], tuple(c["axes"]), tuple(c["ranks"]))
            for c in colls]


def _dry_log(tmp: Path, name: str, rec: dict) -> list[dict]:
    """The dry cell's collectives, from its ``hlo_dir`` file."""
    import gzip

    path = tmp / "hlo" / name.replace("/", "__") / (
        f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.ops.jsonl.gz")
    with gzip.open(path, "rt") as f:
        lines = [json.loads(line) for line in f]
    assert any("op" in line for line in lines), "the ops file holds no op"
    return [line["collective"] for line in lines if "collective" in line]


@pytest.mark.parametrize("name", list(CELLS))
def test_a_dry_cell_counts_what_the_real_cell_does(name, sides):
    dry, real, _, tmp = sides
    rec, got = dry[name], real[0][name]
    assert rec["status"] == "ok", rec.get("traceback")
    assert _log(_dry_log(tmp, name, rec)) == _log(got["collectives"])
    assert rec["dot_flops"] == got["dot_flops"] > 0
    assert rec["argument_leaves"] == got["argument_leaves"]
    assert rec["memory"]["argument_size_in_bytes"] == got["memory"]["argument_size_in_bytes"]
    assert rec["collectives_by_kind"] == got["collectives_by_kind"]
    print(f"{name}: temp dry {rec['memory']['temp_size_in_bytes']} B, real "
          f"{got['memory']['temp_size_in_bytes']} B")


@pytest.mark.parametrize("name", list(CELLS))
def test_every_rank_counts_what_rank_0_does(name, sides):
    """The dry run's per-device numbers are rank 0's; on (2, 2) every rank
    of the real run moves the same bytes by kind, runs the same dot FLOPs
    and holds the same argument blocks."""
    real = sides[1]
    for r, got in enumerate(real[1:], 1):
        for key in ("collectives_by_kind", "dot_flops", "argument_leaves"):
            assert got[name][key] == real[0][name][key], (r, key)


# ---------------------------------------------------------------- against the reference

def _argument_difference(name: str, leaf: str, ours: int | None, theirs: int | None) -> str:
    """Why block ``leaf`` of case ``name`` differs from the reference's
    shard, or "" if nothing explains it."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import train
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models.convert import param_shapes

    arch, kind = CELLS[name]
    if leaf == "pos" and ours is None and kind == "decode":
        return "the port's decode takes the position as a host integer"
    if kind != "train" and leaf.startswith("params/") and ours is not None:
        cfg = get_config(arch, reduced=True)
        param = leaf.removeprefix("params/")
        mesh = abstract_mesh(MESH_SHAPE, ("data", "model"))
        lay = train.leaf_layouts(cfg, mesh)[param]
        whole = math.prod(param_shapes(cfg)[param]) * 4
        if lay.select is not None:
            read, length = lay.select.share(MESH_SHAPE[1])
            compute = whole // length * read
        else:
            cut = train._model_dim(lay.compute)
            compute = whole // (1 if cut is None else MESH_SHAPE[1])
        if train.is_expert(param):
            compute = whole // math.prod(shd._block(e, mesh)[0] for e in lay.spec)
        if ours == compute:
            return ("a served call reads its compute block, gathered once when the cell is "
                    "built (train.leaf_layouts); the reference's call takes the kept shard "
                    "and gathers inside")
    return ""


@pytest.mark.parametrize("name", list(CELLS))
def test_argument_bytes_equal_the_references_or_are_named(name, sides):
    dry, _, ref, _ = sides
    ours, theirs = dry[name]["argument_leaves"], ref[name]["argument_leaves"]
    # XLA leaves an argument the module never reads out of its count
    # (rwkv6-3b's decode does not read pos)
    assert sum(theirs.values()) - ref[name]["argument_size_in_bytes"] in (0, theirs.get("pos"))
    differ = {leaf: (ours.get(leaf), theirs.get(leaf)) for leaf in set(ours) | set(theirs)
              if ours.get(leaf) != theirs.get(leaf)}
    named = {leaf: _argument_difference(name, leaf, *pair) for leaf, pair in differ.items()}
    for leaf, why in sorted(named.items()):
        print(f"{name}: {leaf} port {differ[leaf][0]} B, reference {differ[leaf][1]} B: {why}")
    assert all(named.values()), {k: v for k, v in differ.items() if not named[k]}
    if CELLS[name][1] == "train":
        assert not differ


@pytest.mark.parametrize("name", list(CELLS))
def test_dot_flops_lie_in_the_band_stated_beforehand(name, sides):
    dry, _, ref, _ = sides
    ratio = dry[name]["dot_flops"] / ref[name]["dot_flops"]
    print(f"{name}: dot_flops port {dry[name]['dot_flops']:.0f}, reference "
          f"{ref[name]['dot_flops']:.0f}, ratio {ratio:.4f}; collective bytes by kind: port "
          + json.dumps({k: v["bytes"] for k, v in dry[name]["collectives_by_kind"].items()})
          + ", reference "
          + json.dumps({k: v["bytes"] for k, v in ref[name]["collectives_by_kind"].items()}))
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1]


# ---------------------------------------------------------------- production cells

def test_a_full_size_production_cell_runs_dry(sides):
    rec = sides[0]["full/decode_32k"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh_shape"] == [16, 16] and rec["rank"] == 0
    assert math.prod(rec["mesh_shape"]) == roofline.CHIPS["single"]
    for key in ("dot_flops", "hbm_bytes", "collective_bytes"):
        assert rec[key] > 0, key
    assert {"argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes"} <= set(rec["memory"])
    assert rec["collectives_detail"] and rec["top_collectives"]
    assert rec["model_flops"] == roofline.model_flops("qwen2-1.5b", "decode_32k")
    row = roofline.analyze_cell(rec)
    assert row["dominant"] in ("compute", "memory", "collective") and row["useful_ratio"] > 0
    table = roofline.markdown_table([rec, sides[0]["full/long_500k"], sides[0]["multi/decode"]])
    print(table)
    assert "| qwen2-1.5b | decode_32k | single |" in table


def test_long_500k_is_skipped_for_pure_full_attention(sides):
    rec = sides[0]["full/long_500k"]
    assert rec["status"] == "skipped" and "pure full attention" in rec["reason"]


def test_serving_on_the_multi_pod_mesh_is_recorded_as_refused(sides):
    rec = sides[0]["multi/decode"]
    assert rec["status"] == "error"
    assert "a mesh of data and model axes" in rec["error"] and rec["traceback"]


def test_the_roofline_cli_prints_the_table(sides, tmp_path):
    for name in ("full/decode_32k", "full/long_500k"):
        rec = sides[0][name]
        (tmp_path / f"{name.replace('/', '__')}.json").write_text(json.dumps(rec))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline", "--results",
                           str(tmp_path)], capture_output=True, text=True, env=_env(),
                          cwd=REPO_ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "| qwen2-1.5b | decode_32k | single |" in proc.stdout
    assert "skipped" in proc.stdout


def test_a_dry_mesh_refuses_another_process_group():
    """No fallback: a dry mesh over a group that is not a fake world of its
    size raises (run in a subprocess: a process group is process-wide)."""
    script = r"""
import tempfile
import torch.distributed as dist
from repro_torch.launch.mesh import make_dry_mesh
dist.init_process_group("gloo", init_method=f"file://{tempfile.mkdtemp()}/s", rank=0,
                        world_size=1)
try:
    make_dry_mesh((2, 2), ("data", "model"), device="cpu")
except RuntimeError as e:
    print("refused:", e)
dist.destroy_process_group()
"""
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=_env(), cwd=REPO_ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "refused: a dry mesh of 4 ranks" in proc.stdout

