"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package ``repro`` (an acyclic, a split and a
cyclic query are answered with both refused), and the port's default
engine refuses to run without a CUDA card instead of quietly using the
CPU."""
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
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {"jax", "jaxlib", "repro"})
print(json.dumps({"rows": res.num_rows, "n": float(res.column("n").sum()),
                  "split": split.split is not None,
                  "split_rows": split.execute().num_rows,
                  "cyclic": cyclic.cyclic, "cyclic_rows": cyclic.execute().num_rows,
                  "loaded": loaded}))
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
