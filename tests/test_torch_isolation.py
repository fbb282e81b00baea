"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package ``repro`` (an acyclic, a split, a cyclic
and a dense-path query are answered, explained and verified, a
maintained bundle takes an insert, a stored database is written,
mounted and answered, a query server on the CPU answers in process
(also a ``.mesh(1)`` spec rebuilt from the description that
``serve/mesh.py`` sends across ranks) and over TCP and applies a view
batch, a meshed plan runs on a
local mesh of one and explains a mesh of 8, and the brute-force oracle,
both baselines and the legacy ``join_agg`` agree with the planner, all
with both packages refused, and so do the ``"ref"`` engine and a ``"ref"``
maintained handle, and the LM substrate's reduced qwen2-1.5b takes a
train step and a decode step, the reduced moonshot-v1-16b-a3b (moe) a
train step, the reduced qwen2-vl-7b (vlm), rwkv6-3b (ssm) and
zamba2-2.7b (hybrid) a decode step each, the reduced whisper-medium
(audio) a loss and a decode step on its prefilled cache, the reduced
moonshot a sharded step on a one-rank mesh of a gloo group, and a reduced
qwen2-1.5b decode cell runs dry on a fake world of 4 ranks; the storage
gate, the catalog verifier and the trainer run as ``python -m`` the same
way), and the port's
default engine refuses to run without a CUDA card instead of quietly
using the CPU."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import Count, Q, TorchChannelEngine

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}

# refuses the forbidden top-level packages by exact name, so that
# ``repro_torch`` still imports
_BLOCKED_RUN = """
import json, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {"jax", "jaxlib", "repro"}:
            raise ModuleNotFoundError(f"import of {name!r} refused")
        return None

sys.meta_path.insert(0, Refuse())
import numpy as np
from repro_torch.api import Count, Max, Min, Q, Sum, TorchChannelEngine

rng = np.random.default_rng(0)
db = {
    "R1": {"g1": rng.integers(0, 5, 300), "j": rng.integers(0, 20, 300)},
    "R2": {"j": rng.integers(0, 20, 300), "g2": rng.integers(0, 5, 300),
           "m": rng.integers(0, 9, 300)},
}
res = (
    Q.over("R1", "R2").group_by("R1.g1", "R2.g2")
    .agg(n=Count(), s=Sum("R2.m"), lo=Min("R2.m"), hi=Max("R2.m"))
    .engine(TorchChannelEngine(device="cpu")).execute(db)
)
from repro_torch.data.queries import skewed_chain_like, triangle_like

cpu = TorchChannelEngine(device="cpu")
sdb, sq = skewed_chain_like(2000, seed=0)
split = Q.from_query(sq).engine(cpu).plan(sdb)
tdb, tq = triangle_like(800, seed=0)
cyclic = Q.from_query(tq).engine(cpu).plan(tdb)
dense = (
    Q.over("R1", "R2").group_by("R1.g1", "R2.g2")
    .agg(n=Count(), s=Sum("R2.m"), lo=Min("R2.m")).engine(cpu).plan(db)
)
explained = dense.explain(actuals=True) + cyclic.explain(actuals=True)
handle = (
    Q.over("R1", "R2").group_by("R1.g1", "R2.g2").agg(n=Count(), s=Sum("R2.m"))
    .engine(cpu).maintain(db)
)
maintained = handle.insert("R2", {"j": np.array([1, 2]), "g2": np.array([0, 4]),
                                  "m": np.array([3, 5])})
import tempfile
from repro_torch.relational.relation import Database
from repro_torch.storage import write_database

with tempfile.TemporaryDirectory() as td:
    write_database(Database.from_mapping(db), td + "/db")
    stored = (
        Q.over("R1", "R2").group_by("R1.g1", "R2.g2")
        .agg(n=Count(), s=Sum("R2.m"), lo=Min("R2.m"), hi=Max("R2.m"))
        .engine(cpu).plan(td + "/db")
    )
    stored_res = stored.execute()
    stored_same = all(
        (stored_res.column(c) == res.column(c)).all() for c in res.relation.columns
    )
    stored_explained = "storage: chunked" in stored.explain()
    stored_findings = len(stored.verify(strict=False))
from repro_torch.serve import JoinAggServer, connect, serve_tcp
from repro_torch.serve.mesh import describe_spec, rebuild_spec

served_db = Database.from_mapping(db)
with JoinAggServer(served_db, device="cpu", workers=2) as srv:
    bundle = Q.over("R1", "R2").group_by("R1.g1", "R2.g2").agg(n=Count(), s=Sum("R2.m"))
    served = srv.query(bundle)
    served_mesh_one = srv.query(rebuild_spec(describe_spec(bundle.mesh(1)), {}))
    tcp, _ = serve_tcp(srv)
    try:
        with connect(*tcp.server_address) as remote:
            remote_res = remote.query({"relations": ["R1", "R2"],
                                       "group_by": ["R1.g1", "R2.g2"],
                                       "aggs": {"n": {"kind": "count"}}})
    finally:
        tcp.shutdown()
        tcp.server_close()
    srv.create_view("v", Q.over("R1", "R2").group_by("R1.g1").agg(n=Count()))
    epoch = srv.apply_view("v", "insert", "R1",
                           {"g1": np.array([0]), "j": np.array([1])}).result(timeout=120)
    server_device = srv.stats()["device"]
meshed_q = (
    Q.over("R1", "R2").group_by("R1.g1", "R2.g2")
    .agg(n=Count(), s=Sum("R2.m"), lo=Min("R2.m"), hi=Max("R2.m")).engine(cpu)
)
meshed = meshed_q.fused(True).mesh(1).plan(db).execute()
meshed_same = all((meshed.column(c) == res.column(c)).all() for c in res.relation.columns)
from repro_torch.baselines import binary_join_agg, preagg_join_agg
from repro_torch.core import join_agg
from repro_torch.core.query import JoinAggQuery
from repro_torch.relational.oracle import oracle_joinagg, oracle_multiagg

pair = JoinAggQuery(("R1", "R2"), (("R1", "g1"), ("R2", "g2")))
counts = res.to_dict("n")
baselines_same = (
    binary_join_agg(pair, served_db, device="cpu")[0] == counts
    and preagg_join_agg(pair, served_db, device="cpu")[0] == counts
    and oracle_joinagg(pair, served_db, device="cpu") == counts
    and join_agg(pair, served_db, engine=cpu) == counts
    and {k: v["hi"] for k, v in oracle_multiagg(
        pair.relations, pair.group_by, {"hi": Max("R2.m")}, served_db, device="cpu"
    ).items()} == res.to_dict("hi")
)
meshed_explained = "torch path: distributed-sparse" in meshed_q.mesh(8).plan(db).explain()
served_same = all(
    (r.column(c) == res.column(c)).all() for r in (served, served_mesh_one) for c in ("n", "s")
)
remote_same = remote_res.to_dict("n") == res.to_dict("n")
from repro_torch.api import RefChannelEngine

ref_cpu = RefChannelEngine(device="cpu")
ref_res = (
    Q.over("R1", "R2").group_by("R1.g1", "R2.g2")
    .agg(n=Count(), s=Sum("R2.m"), lo=Min("R2.m"), hi=Max("R2.m")).engine(ref_cpu).execute(db)
)
ref_same = all((ref_res.column(c) == res.column(c)).all() for c in res.relation.columns)
ref_handle = Q.over("R1", "R2").group_by("R1.g1").agg(n=Count()).engine(ref_cpu).maintain(db)
ref_handle.insert("R2", {"j": np.array([1, 2]), "g2": np.array([0, 4]), "m": np.array([3, 5])})
ref_maintained = sum(ref_handle.result().values())
import torch
from repro_torch.configs import get_config
from repro_torch.launch.train import build_train_step
from repro_torch.models.model import get_model
from repro_torch.train.optimizer import AdamWConfig, adamw_init

lm_cfg = get_config("qwen2-1.5b", reduced=True)
lm = get_model(lm_cfg, device="cpu").init(torch.Generator().manual_seed(0))
lm_opt = adamw_init(lm.params())
lm_tokens = torch.tensor(rng.integers(0, lm_cfg.vocab, (2, 33)), dtype=torch.int32)
lm_loss, _ = build_train_step(lm, AdamWConfig())(
    lm_opt, {"tokens": lm_tokens[:, :-1], "labels": lm_tokens[:, 1:]})
lm_logits, _ = lm.decode_step(lm.init_cache(2, 4), lm_tokens[:, :1], 0)
moe_cfg = get_config("moonshot-v1-16b-a3b", reduced=True)
moe = get_model(moe_cfg, device="cpu").init(torch.Generator().manual_seed(1))
moe_opt = adamw_init(moe.params())
moe_loss, _ = build_train_step(moe, AdamWConfig())(
    moe_opt, {"tokens": lm_tokens[:, :-1], "labels": lm_tokens[:, 1:]})
vlm_cfg = get_config("qwen2-vl-7b", reduced=True)
vlm = get_model(vlm_cfg, device="cpu").init(torch.Generator().manual_seed(2))
vlm_logits, _ = vlm.decode_step(vlm.init_cache(2, 4), lm_tokens[:, :1], 0)
recurrent_decoded = {}
for arch in ("rwkv6-3b", "zamba2-2.7b"):
    rec = get_model(get_config(arch, reduced=True), device="cpu").init(
        torch.Generator().manual_seed(3))
    rec_logits, _ = rec.decode_step(rec.init_cache(2, 4), lm_tokens[:, :1], 0)
    recurrent_decoded[arch] = (list(rec_logits.shape)
                               if bool(torch.isfinite(rec_logits).all()) else None)
audio_cfg = get_config("whisper-medium", reduced=True)
audio = get_model(audio_cfg, device="cpu").init(torch.Generator().manual_seed(4))
frames = torch.tensor(rng.normal(size=(2, audio_cfg.n_audio_ctx, audio_cfg.d_model)),
                      dtype=torch.float32)
with torch.no_grad():
    audio_loss = audio.loss({"tokens": lm_tokens[:, :-1], "labels": lm_tokens[:, 1:],
                             "frames": frames})
_, audio_prefilled = audio.prefill({"tokens": lm_tokens[:, :4], "frames": frames})
audio_cache = audio.init_cache(2, 5)
for key, t in audio_prefilled.items():
    if key in ("k", "v"):
        audio_cache[key][:, :, :4] = t
    else:
        audio_cache[key].copy_(t)
audio_logits, _ = audio.decode_step(audio_cache, lm_tokens[:, 4:5], 4)
import shutil
import tempfile
import torch.distributed as dist
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import shard_model

store = tempfile.mkdtemp()
dist.init_process_group("gloo", init_method=f"file://{store}/store", rank=0, world_size=1)
one_rank = make_mesh((1, 1), ("data", "model"), device="cpu")
meshed_moe = shard_model(moe_cfg, one_rank, torch.Generator().manual_seed(1))
meshed_opt = adamw_init(meshed_moe.params())
meshed_loss, _ = build_train_step(meshed_moe, AdamWConfig(), mesh=one_rank)(
    meshed_opt, {"tokens": lm_tokens[:, :-1], "labels": lm_tokens[:, 1:]})
from repro_torch.launch.dryrun import build_cell
from repro_torch.models.config import ShapeConfig

served_prefill, (served_rows,) = build_cell(
    "moonshot-v1-16b-a3b", "prefill", one_rank, cfg=moe_cfg, model=meshed_moe, slots=12,
    shape=ShapeConfig("prefill", "prefill", 8, 2))
_, served_cache = served_prefill({"tokens": lm_tokens[:, :8]})
served_decode, _ = build_cell("moonshot-v1-16b-a3b", "decode", one_rank, cfg=moe_cfg,
                              model=meshed_moe, shape=ShapeConfig("decode", "decode", 12, 2))
served_logits, _ = served_decode(served_cache, lm_tokens[:, 8:9], 8)
dist.destroy_process_group()
shutil.rmtree(store)
from repro_torch.launch.dryrun import run_cell

dry = run_cell("qwen2-1.5b", "decode", "single", cfg=lm_cfg, mesh_shape=(2, 2), device="cpu",
               shape=ShapeConfig("decode", "decode", 8, 2))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {"jax", "jaxlib", "repro"})
print(json.dumps({"rows": res.num_rows, "n": float(res.column("n").sum()),
                  "split": split.split is not None,
                  "split_rows": split.execute().num_rows,
                  "cyclic": cyclic.cyclic, "cyclic_rows": cyclic.execute().num_rows,
                  "dense": dense.engine.path(dense.prep, dense.channels),
                  "dense_rows": dense.execute().num_rows,
                  "explained": "torch path: dense" in explained,
                  "findings": len(dense.verify(strict=False) + cyclic.verify(strict=False)),
                  "maintained_n": float(maintained.column("n").sum()),
                  "stored_same": bool(stored_same), "stored_explained": stored_explained,
                  "stored_findings": stored_findings,
                  "served_same": bool(served_same), "remote_same": remote_same,
                  "view_epoch": epoch, "server_device": server_device,
                  "meshed_same": bool(meshed_same), "meshed_explained": meshed_explained,
                  "baselines_same": baselines_same, "ref_same": bool(ref_same),
                  "ref_maintained": ref_maintained, "lm_loss": float(lm_loss),
                  "lm_step": int(lm_opt["step"]),
                  "lm_decoded": list(lm_logits.shape) if bool(torch.isfinite(lm_logits).all())
                  else None, "moe_loss": float(moe_loss), "moe_aux": float(moe.last_aux),
                  "moe_step": int(moe_opt["step"]),
                  "vlm_decoded": list(vlm_logits.shape) if bool(torch.isfinite(vlm_logits).all())
                  else None, "recurrent_decoded": recurrent_decoded,
                  "audio_loss": float(audio_loss), "meshed_loss": float(meshed_loss),
                  "meshed_step": int(meshed_opt["step"]),
                  "served_decoded": list(served_logits.shape)
                  if bool(torch.isfinite(served_logits).all()) else None,
                  "audio_decoded": list(audio_logits.shape)
                  if bool(torch.isfinite(audio_logits).all()) else None,
                  "dry": [dry["status"], dry.get("dot_flops", 0) > 0,
                          dry.get("collective_bytes", 0) > 0], "loaded": loaded}))
"""


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def test_port_answers_a_query_with_jax_and_repro_refused():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN], capture_output=True, text=True,
        env=_env(), cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["rows"] > 0 and out["n"] > 0
    assert out["split"] and out["split_rows"] > 0
    assert out["cyclic"] and out["cyclic_rows"] > 0
    assert out["dense"] == "dense" and out["dense_rows"] > 0
    assert out["explained"] and out["findings"] == 0
    assert out["maintained_n"] > out["n"]  # the insert joined
    assert out["stored_same"] and out["stored_explained"] and out["stored_findings"] == 0
    assert out["served_same"] and out["remote_same"]
    assert out["view_epoch"] == 1 and out["server_device"] == "cpu"
    assert out["meshed_same"] and out["meshed_explained"]
    assert out["baselines_same"]
    assert out["ref_same"] and out["ref_maintained"] > out["n"]
    assert 0 < out["lm_loss"] < 2.5 * np.log(512) and out["lm_step"] == 1
    assert out["lm_decoded"] == [2, 1, 512]
    assert 0 < out["moe_loss"] < 2.5 * np.log(512) and out["moe_aux"] > 0
    assert out["moe_step"] == 1
    # one sharded step on a one-rank mesh: the expert-parallel path, the
    # unsharded step's loss up to the bf16 model sum
    assert out["meshed_step"] == 1
    assert out["served_decoded"] == [2, 1, 512]  # launch/dryrun.py's decode cell on one rank
    assert abs(out["meshed_loss"] - out["moe_loss"]) <= 1e-3 * out["moe_loss"]
    assert out["vlm_decoded"] == [2, 1, 512]
    assert out["recurrent_decoded"] == {"rwkv6-3b": [2, 1, 512], "zamba2-2.7b": [2, 1, 512]}
    assert 0 < out["audio_loss"] < 2.5 * np.log(512)
    assert out["audio_decoded"] == [2, 1, 512]
    # launch/dryrun.py's run_cell: a reduced decode cell on a fake world of 4
    assert out["dry"] == ["ok", True, True]


# the same refusal, then one of the port's launchers run as ``python -m``
_BLOCKED_CLI = """
import runpy, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {"jax", "jaxlib", "repro"}:
            raise ModuleNotFoundError(f"import of {name!r} refused")
        return None

sys.meta_path.insert(0, Refuse())
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""


@pytest.mark.parametrize(
    "argv, expect",
    [
        (["repro_torch.launch.storage", "--smoke", "--rows", "600", "--device", "cpu"],
         "storage-smoke: maintain() deltas ok"),
        (["repro_torch.analysis", "--verify-catalog", "--device", "cpu"],
         "catalog[TPCH@fused]: ok"),
        (["repro_torch.launch.train", "--device", "cpu", "--reduced", "--steps", "2",
          "--global-batch", "2", "--seq-len", "32"], "[train] done: 2 steps in "),
    ],
    ids=["storage", "analysis", "train"],
)
def test_launchers_run_with_jax_and_repro_refused(argv, expect):
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_CLI, *argv], capture_output=True, text=True,
        env=_env(), cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert expect in proc.stdout
    assert "refused" not in proc.stderr


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "tools" / "walk_sweep.py",
                                  REPO / "tools" / "decode_drift.py",
                                  REPO / "tools" / "step_profile.py",
                                  REPO / "tools" / "dryrun_table.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_source_imports_jax_or_repro(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{path} imports {bad}"


def test_the_scan_covers_every_port_package():
    scanned_files = set(PORT.rglob("*.py"))
    assert PORT / "core" / "distributed.py" in scanned_files
    assert PORT / "relational" / "oracle.py" in scanned_files
    assert PORT / "launch" / "storage.py" in scanned_files
    assert PORT / "analysis" / "__main__.py" in scanned_files
    assert PORT / "serve" / "mesh.py" in scanned_files
    assert PORT / "launch" / "train.py" in scanned_files
    assert PORT / "launch" / "dryrun.py" in scanned_files
    assert PORT / "models" / "model.py" in scanned_files
    assert PORT / "train" / "checkpoint.py" in scanned_files
    assert PORT / "configs" / "qwen2_1_5b.py" in scanned_files
    scanned = {p.parent.name for p in PORT.rglob("*.py")}
    packages = {p.parent.name for p in PORT.rglob("__init__.py")}
    assert {
        "analysis", "api", "baselines", "configs", "core", "incremental", "kernels",
        "launch", "models", "planner", "relational", "serve", "storage", "train",
    } <= packages == scanned


def test_torch_engine_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(1)
    db = {
        "R1": {"g1": rng.integers(0, 4, 50), "j": rng.integers(0, 6, 50)},
        "R2": {"j": rng.integers(0, 6, 50), "g2": rng.integers(0, 4, 50)},
    }
    q = Q.over("R1", "R2").group_by("R1.g1", "R2.g2").agg(n=Count())
    with pytest.raises(RuntimeError, match=r'TorchChannelEngine\(device="cpu"\)'):
        q.engine("torch").plan(db)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        q.plan(db)  # "torch" is the default engine
    assert q.engine(TorchChannelEngine(device="cpu")).execute(db).num_rows > 0


def test_chip_smoke_fails_without_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        cwd=tmp_path, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_without_a_card():
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, whatever the host has
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        cwd=REPO, timeout=300, env=env,
    )
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "torch.cuda.is_available() is false" in proc.stderr
