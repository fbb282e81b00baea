"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package ``repro`` (an acyclic, a split, a cyclic
and a dense-path query are answered, explained and verified, a
maintained bundle takes an insert, a stored database is written,
mounted and answered, a query server on the CPU answers in process
and over TCP and applies a view batch, a meshed plan runs on a
local mesh of one and explains a mesh of 8, and the brute-force oracle,
both baselines and the legacy ``join_agg`` agree with the planner, all
with both packages refused), and the port's default engine refuses to
run without a CUDA card instead of quietly using the CPU."""
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

served_db = Database.from_mapping(db)
with JoinAggServer(served_db, device="cpu", workers=2) as srv:
    bundle = Q.over("R1", "R2").group_by("R1.g1", "R2.g2").agg(n=Count(), s=Sum("R2.m"))
    served = srv.query(bundle)
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
served_same = all((served.column(c) == res.column(c)).all() for c in ("n", "s"))
remote_same = remote_res.to_dict("n") == res.to_dict("n")
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
                  "baselines_same": baselines_same, "loaded": loaded}))
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
    sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "tools" / "walk_sweep.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_source_imports_jax_or_repro(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{path} imports {bad}"


def test_the_scan_covers_every_port_package():
    scanned_files = set(PORT.rglob("*.py"))
    assert PORT / "core" / "distributed.py" in scanned_files
    assert PORT / "relational" / "oracle.py" in scanned_files
    scanned = {p.parent.name for p in PORT.rglob("*.py")}
    packages = {p.parent.name for p in PORT.rglob("__init__.py")}
    assert {
        "analysis", "api", "baselines", "core", "incremental", "kernels", "launch",
        "planner", "relational", "serve", "storage",
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
