"""Static checks (DESIGN.md §11): the plan-invariant verifier of
compiled plans, exposed as ``Plan.verify()`` and as a ``REPRO_VERIFY=1``
debug-mode assert inside ``compile_plan``, and the AST lint of the
port's sources (``lint.py``, ``python -m repro_torch.analysis
--check``)."""
from repro_torch.analysis.verify import (
    Diagnostic,
    PlanInvariantError,
    verify_ghd_plan,
    verify_plan,
    verify_sparse_program,
)

__all__ = [
    "Diagnostic",
    "PlanInvariantError",
    "verify_ghd_plan",
    "verify_plan",
    "verify_sparse_program",
]
