"""Synthetic datasets from the paper's experimental section (Section VII-A).

Each dataset is a uniform draw: join attributes from ``[0, sel * n)``
(``sel`` = the paper's selectivity ``|π_j(R)| / |R|``), group attributes
from a per-dataset range that reproduces the paper's output-group counts
proportionally.  Paper scale is ``n = 500_000`` rows per relation; the
default here is container-friendly and every generator takes ``n``.

S1–S3: self-join  R1(g1,p) ⋈ R2(g2,p)                       (Table III)
C1–C3: chain      R1(g1,p0) ⋈ R2(p0,p1) ⋈ R3(p1,p2) ⋈ R4(p2,g2)  (Table IV)
B1–B3: branching  R1(g1,j) ⋈ R2(j,b) ⋈ R3(b,g2) ⋈ R4(b,g3)  (Table V)
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.query import JoinAggQuery
from repro_torch.relational.relation import Database

# paper-derived parameters: selectivities exact, group-domain fractions
# chosen to reproduce the paper's reported group counts at n=500k.
SELF_JOIN = {"S1": 0.001, "S2": 0.003, "S3": 0.1}
CHAIN = {"C1": 0.1, "C2": 0.3, "C3": 0.5}
BRANCH = {"B1": (0.001, 0.8), "B2": (0.1, 0.1), "B3": (0.3, 0.5)}
G_FRAC = {"S": 0.005, "C": 0.0045, "B1": 1e-4, "B2": 1e-4, "B3": 4.3e-4}


def _dom(frac: float, n: int) -> int:
    # floor keeps scaled-down group domains non-degenerate
    return max(16, int(frac * n))


def self_join(name: str, n: int, seed: int = 0) -> tuple[Database, JoinAggQuery]:
    sel = SELF_JOIN[name]
    rng = np.random.default_rng(seed)
    jdom, gdom = max(2, int(sel * n)), _dom(G_FRAC["S"], n)
    g = rng.integers(0, gdom, n)
    p = rng.integers(0, jdom, n)
    db = Database.from_mapping({"R1": {"g1": g, "p": p}, "R2": {"g2": g, "p": p}})
    return db, JoinAggQuery(("R1", "R2"), (("R1", "g1"), ("R2", "g2")))


def chain(name: str, n: int, seed: int = 0) -> tuple[Database, JoinAggQuery]:
    sel = CHAIN[name]
    rng = np.random.default_rng(seed)
    jdom, gdom = max(2, int(sel * n)), _dom(G_FRAC["C"], n)
    db = Database.from_mapping(
        {
            "R1": {"g1": rng.integers(0, gdom, n), "p0": rng.integers(0, jdom, n)},
            "R2": {"p0": rng.integers(0, jdom, n), "p1": rng.integers(0, jdom, n)},
            "R3": {"p1": rng.integers(0, jdom, n), "p2": rng.integers(0, jdom, n)},
            "R4": {"p2": rng.integers(0, jdom, n), "g2": rng.integers(0, gdom, n)},
        }
    )
    return db, JoinAggQuery(
        ("R1", "R2", "R3", "R4"), (("R1", "g1"), ("R4", "g2"))
    )


def branching(name: str, n: int, seed: int = 0) -> tuple[Database, JoinAggQuery]:
    sel1, sel2 = BRANCH[name]
    rng = np.random.default_rng(seed)
    jdom = max(2, int(sel1 * n))
    bdom = max(2, int(sel2 * n))
    gdom = _dom(G_FRAC[name], n)
    db = Database.from_mapping(
        {
            "R1": {"g1": rng.integers(0, gdom, n), "j": rng.integers(0, jdom, n)},
            "R2": {"j": rng.integers(0, jdom, n), "b": rng.integers(0, bdom, n)},
            "R3": {"b": rng.integers(0, bdom, n), "g2": rng.integers(0, gdom, n)},
            "R4": {"b": rng.integers(0, bdom, n), "g3": rng.integers(0, gdom, n)},
        }
    )
    return db, JoinAggQuery(
        ("R1", "R2", "R3", "R4"),
        (("R1", "g1"), ("R3", "g2"), ("R4", "g3")),
    )


def make(name: str, n: int, seed: int = 0) -> tuple[Database, JoinAggQuery]:
    if name in SELF_JOIN:
        return self_join(name, n, seed)
    if name in CHAIN:
        return chain(name, n, seed)
    if name in BRANCH:
        return branching(name, n, seed)
    raise KeyError(name)


ALL = list(SELF_JOIN) + list(CHAIN) + list(BRANCH)
