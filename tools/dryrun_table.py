"""One row an arch of the dry run's roofline: each cell's bound, its term,
MODEL/HLO and argument + temp bytes, modelled on ``launch/roofline.py``'s
H100 SXM constants.

    PYTHONPATH=src python3 tools/dryrun_table.py launch_results

Reads the records ``python -m repro_torch.launch.dryrun --all`` wrote;
the long table is ``python -m repro_torch.launch.roofline``'s.
"""
import sys

from repro_torch.configs import ARCHS
from repro_torch.launch import roofline
from repro_torch.models.config import SHAPES

TERM = {"compute": "comp", "memory": "mem", "collective": "coll"}


def cell(rec: dict | None) -> str:
    if rec is None:
        return "not run"
    if rec.get("status") == "skipped":
        return "skip"
    row = roofline.analyze_cell(rec)
    if row is None:
        return "refused" if "NotImplementedError" in rec.get("error", "") else "error"
    mem = rec["memory"]
    held = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    bound = max(row["compute_s"], row["memory_s"], row["collective_s"]) * 1e3
    return (f"{bound:.3g} {TERM[row['dominant']]}, {row['useful_ratio']:.2f}, "
            f"{held / 2**30:.3g}{'' if held < roofline.HBM_BYTES else ' ✗'}")


def main(results: str) -> None:
    cells = {(r["arch"], r["shape"], r["mesh"]): r for r in roofline.load_cells(results)}
    print("| arch | " + " | ".join(SHAPES) + " | train_4k, multi |")
    print("|---|" + "---|" * (len(SHAPES) + 1))
    for arch in ARCHS:
        row = [cell(cells.get((arch, s, "single"))) for s in SHAPES]
        row.append(cell(cells.get((arch, "train_4k", "multi"))))
        print(f"| {arch} | " + " | ".join(row) + " |")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "launch_results")
