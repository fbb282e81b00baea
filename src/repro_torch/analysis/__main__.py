"""CLI of the plan verifier and the lint.

``python -m repro_torch.analysis --check [PATH ...]``
    Lint the given files and directories (default: ``src/repro_torch``)
    with :mod:`repro_torch.analysis.lint` (``lock-guard``,
    ``tile-floordiv``); print each finding as ``path:line:col: CODE
    message`` and exit 1 on any.  Needs no card.

``python -m repro_torch.analysis --verify-catalog [--device cuda|cpu]``
    Compile every catalog query at golden scales on the ``"torch"``
    engine (``TorchChannelEngine(device=--device)``, CUDA by default)
    and run the plan verifier over each (plus a mesh=8 variant, a fused
    variant and the SKEWCHAIN per-split plan); exit 1 on any diagnostic.
    Without a card and without ``--device cpu`` it exits non-zero.

Port of the JAX package's ``analysis/__main__.py``.  With neither flag
it prints its usage and exits 2 (the reference lints ``src`` then).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.lint import lint_paths

PROG = "python -m repro_torch.analysis"
DEFAULT_CHECK = "src/repro_torch"

# golden scales — mirror benchmarks/plan_goldens.py so the verified
# plans are the same ones the plan-choice gate snapshots
_SCALES = {"REAL": 600, "CYCLIC": 300, "SKEWED": 600}


def _verify_catalog(device: str = "cuda") -> int:
    from repro_torch.api.builder import Q
    from repro_torch.api.engines import TorchChannelEngine
    from repro_torch.data.queries import CYCLIC, REAL, SKEWED

    engine = TorchChannelEngine(device=device)
    failures = 0
    for group, cat in (("REAL", REAL), ("CYCLIC", CYCLIC), ("SKEWED", SKEWED)):
        for name, gen in sorted(cat.items()):
            db, q = gen(_SCALES[group], seed=0)
            plan = Q.from_query(q).engine(engine).plan(db)
            diags = plan.verify(strict=False)
            for d in diags:
                failures += 1
                print(f"catalog[{name}]: {d}")
            if not diags:
                nodes = len(plan.prep.decomposition.order)
                print(f"catalog[{name}]: ok ({nodes} nodes)")
            if name == "SKEWCHAIN" and plan.split is None:
                failures += 1
                print(
                    "catalog[SKEWCHAIN]: expected a per-split plan at "
                    "golden scale but the planner chose an unsplit one"
                )

    # a distributed (mesh=8) variant of an acyclic catalog query: the
    # shard-partition invariants only bind when mesh is set
    db, q = REAL["TPCH"](_SCALES["REAL"], seed=0)
    plan = Q.from_query(q).engine(engine).mesh(8).plan(db)
    diags = plan.verify(strict=False)
    for d in diags:
        failures += 1
        print(f"catalog[TPCH@mesh=8]: {d}")
    if not diags:
        print("catalog[TPCH@mesh=8]: ok")

    # a fused variant: V-KERN binds on fused-capable engines, and the
    # explicit option must survive compile + verify end to end
    plan = Q.from_query(q).engine(engine).fused(True).plan(db)
    diags = plan.verify(strict=False)
    for d in diags:
        failures += 1
        print(f"catalog[TPCH@fused]: {d}")
    if not diags:
        kerns = len(plan.prep.decomposition.order)
        print(f"catalog[TPCH@fused]: ok ({kerns} fused hop kernel(s))")
    return 1 if failures else 0


def main(argv: list[str] | None = None) -> int:
    from repro_torch.core.torch_engine import require_device

    ap = argparse.ArgumentParser(prog=PROG)
    ap.add_argument(
        "--check",
        nargs="*",
        metavar="PATH",
        default=None,
        help=f"lint the given files/directories (default: {DEFAULT_CHECK})",
    )
    ap.add_argument(
        "--verify-catalog",
        action="store_true",
        help="compile + verify every catalog golden plan",
    )
    ap.add_argument("--device", default="cuda",
                    help="device the engine runs on (cuda, or cpu)")
    args = ap.parse_args(argv)
    if not args.verify_catalog and args.check is None:
        ap.print_usage(sys.stderr)
        return 2
    rc = 0
    if args.verify_catalog:
        try:
            device = require_device(args.device, PROG, "--device cpu")
        except RuntimeError as e:
            print(e, file=sys.stderr)
            return 2
        rc |= _verify_catalog(device)
    if args.check is not None:
        rc |= _check(args.check or [DEFAULT_CHECK])
    return rc


def _check(paths: list[str]) -> int:
    findings = lint_paths(paths)
    for f in findings:
        print(f)
    if findings:
        print(f"{len(findings)} finding(s)", file=sys.stderr)
        return 1
    print(f"lint: clean ({len(paths)} path(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
