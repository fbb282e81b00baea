"""The port's two launchers against the JAX package's, on the CPU.

``python -m repro_torch.launch.storage --smoke`` (the out-of-core
storage gate) and ``python -m repro_torch.analysis --verify-catalog``
(the plan verifier over the catalog) run here with ``--device cpu`` and
are held against ``repro.launch.storage`` and ``repro.analysis``: the
same generated chain, the same ``ok`` lines, the same mounted answers.
Each gate must also fail when its check fails, and both refuse to run
without a card unless the CPU is asked for.
"""
import tempfile

import numpy as np
import pytest
import torch

import repro.analysis.__main__ as j_analysis
import repro.launch.storage as j_storage
from repro.storage import open_database as j_open_database
from repro_torch.analysis import __main__ as analysis
from repro_torch.analysis.verify import Diagnostic
from repro_torch.api import TorchChannelEngine
from repro_torch.api.plan import Plan
from repro_torch.launch import storage
from repro_torch.relational.relation import Database
from repro_torch.storage import open_database, write_database

CPU_ARGS = ["--device", "cpu"]


def _catalog_lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.startswith("catalog[")]


@pytest.mark.parametrize("rows", [500, 3000])
@pytest.mark.parametrize("seed", [7, 11])
def test_medium_chain_equals_the_reference(rows, seed):
    got, want = storage.medium_chain(rows, seed), j_storage.medium_chain(rows, seed)
    assert sorted(got.relations) == sorted(want.relations)
    for name in want.relations:
        gcols, wcols = got[name].columns, want[name].columns
        assert list(gcols) == list(wcols)
        for attr, col in wcols.items():
            assert gcols[attr].dtype == col.dtype, (name, attr)
            assert np.array_equal(gcols[attr], col), (name, attr)


def test_smoke_counts_the_reference_groups(capsys):
    assert storage.main(["--smoke", "--rows", "2000", *CPU_ARGS]) == 0
    out = capsys.readouterr().out.splitlines()
    assert j_storage.smoke(2000, None) == 0
    ref = capsys.readouterr().out.splitlines()
    assert out[0].startswith("storage-smoke: torch ok (")
    groups = out[0].split("torch ok ")[1]
    for engine in j_storage.ENGINES:
        assert f"storage-smoke: {engine} ok {groups}" in ref
    # the ref engine's line follows, its group count the reference's own
    assert out[1] == f"storage-smoke: ref ok {groups}"
    assert out[1] in ref
    assert out[2] == "storage-smoke: maintain() deltas ok" == ref[-1]


def test_mounted_bundle_equals_the_reference_tensor_engine(tmp_path):
    write_database(storage.medium_chain(1500), tmp_path / "db")
    got = storage._query().engine(TorchChannelEngine(device="cpu")).execute(
        open_database(tmp_path / "db")
    )
    want = j_storage._query().engine("tensor").execute(j_open_database(tmp_path / "db"))
    assert got.group_names == want.group_names and got.agg_names == want.agg_names
    assert got.num_rows == want.num_rows > 0
    for col in want.group_names + want.agg_names:
        assert np.array_equal(got.column(col), want.column(col)), col
    # the launcher's own comparison agrees
    assert storage._same(got, got)


def test_keep_leaves_the_database_and_the_temp_dir_goes(tmp_path, monkeypatch):
    kept = tmp_path / "kept"
    kept.mkdir()
    assert storage.main(["--smoke", "--rows", "600", "--keep", str(kept), *CPU_ARGS]) == 0
    assert (kept / "db").is_dir() and any((kept / "db").iterdir())

    scratch = tmp_path / "tmp"
    scratch.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(scratch))
    made = []
    real_mkdtemp = tempfile.mkdtemp

    def recording_mkdtemp(*args, **kwargs):
        made.append(real_mkdtemp(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(storage.tempfile, "mkdtemp", recording_mkdtemp)
    assert storage.main(["--smoke", "--rows", "600", *CPU_ARGS]) == 0
    smoke_dirs = [d for d in made if "repro-storage-smoke-" in d]
    assert len(smoke_dirs) == 1 and smoke_dirs[0].startswith(str(scratch))
    assert not any(p.name.startswith("repro-storage-smoke-") for p in scratch.iterdir())


def test_the_gate_fails_on_a_short_mounted_database(monkeypatch, capsys):
    rows = 800
    full = storage.medium_chain(rows)
    short = Database.from_mapping({
        name: {a: c[:-1] if name == "R2" else c for a, c in full[name].columns.items()}
        for name in full.relations
    })
    assert short["R2"].num_rows == rows - 1
    monkeypatch.setattr(storage, "open_database", lambda path: short)
    assert storage.smoke(rows, None, "cpu") == 1
    err = capsys.readouterr().err
    assert "storage-smoke FAILED: torch: mounted run diverged" in err
    assert "storage-smoke FAILED: torch: forced-chunk run diverged" in err


def test_verify_catalog_equals_the_reference(capsys):
    assert analysis.main(["--verify-catalog", *CPU_ARGS]) == 0
    got = _catalog_lines(capsys.readouterr().out)
    assert j_analysis._verify_catalog() == 0
    want = _catalog_lines(capsys.readouterr().out)
    assert len(want) == 10
    assert got == want


def test_verify_catalog_fails_on_a_diagnostic(monkeypatch, capsys):
    diag = Diagnostic("V-TEST", "tree/R1", "planted finding")
    monkeypatch.setattr(Plan, "verify", lambda self, strict=True: [diag])
    assert analysis.main(["--verify-catalog", *CPU_ARGS]) == 1
    out = capsys.readouterr().out.splitlines()
    assert "catalog[TPCH]: V-TEST at tree/R1: planted finding" in out
    assert "catalog[TPCH@mesh=8]: V-TEST at tree/R1: planted finding" in out
    assert not any(": ok" in line for line in out)


def test_analysis_without_a_flag_prints_its_usage(capsys):
    assert analysis.main([]) == 2
    assert "usage: python -m repro_torch.analysis" in capsys.readouterr().err


@pytest.mark.parametrize(
    "cli, argv, prog",
    [
        (storage, ["--smoke", "--rows", "600"], "python -m repro_torch.launch.storage"),
        (analysis, ["--verify-catalog"], "python -m repro_torch.analysis"),
    ],
    ids=["storage", "analysis"],
)
def test_clis_refuse_to_run_without_a_card(cli, argv, prog, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(argv) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert (f"{prog} runs on CUDA and no CUDA device is available; pass "
            "--device cpu to run on the CPU") in captured.err
