"""GHD compiler: cyclic join-aggregate queries over the acyclic pipeline.

The paper's JOIN-AGG operator requires an α-acyclic join; this package
lifts it to arbitrary (cyclic) queries the AJAR way [Joglekar, Puttagunta
& Ré]: cover the query hypergraph with a *generalized hypertree
decomposition* (a tree of attribute bags, each bag covered by relations),
materialize every bag once on the host as a pre-aggregated multiplicity
relation, and run the existing acyclic walk over the bag tree on the
card.

* :mod:`repro_torch.ghd.hypertree` — GHD construction by
  elimination-order search, scored by estimated bag size.
* :mod:`repro_torch.ghd.bags` — blocked-COO bag materialization in the
  counting semiring, with peak-bytes accounting.
* :mod:`repro_torch.ghd.rewrite` — the derived acyclic query over bag
  relations, routed through the unchanged prepare pipeline.

Port of the JAX package's ``ghd/``; ``Q...plan(db)`` dispatches here when
the GYO test reports a cyclic hypergraph.
"""
from repro_torch.ghd.hypertree import GHD, Bag, build_ghd, verify_ghd
from repro_torch.ghd.rewrite import GHDPlan, compile_ghd, ghd_join_agg, is_cyclic_query

__all__ = [
    "GHD",
    "Bag",
    "build_ghd",
    "verify_ghd",
    "GHDPlan",
    "compile_ghd",
    "ghd_join_agg",
    "is_cyclic_query",
]
