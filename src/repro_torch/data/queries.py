"""Real-world-shaped query workloads (paper Section VII, Table VI).

The paper's real datasets (TPCH SF=1, DBLP, ORDS, IMDB) are not shipped
offline; we synthesize datasets with the same *join shapes, skew and
fan-outs* so Table VI's comparisons are reproducible at container scale:

* TPCH  — [Q1]-shaped chain: supplier ⋈ lineitem ⋈ orders ⋈ customer,
  GROUP BY (s_suppkey, c_zipcode): key joins + one low-selectivity hop.
* DBLP  — co-author pair counting: self-join of (author, paper) on paper.
* ORDS  — market-basket item pairs: self-join of (item, invoice) on
  invoice (Zipf-distributed item popularity).
* IMDB  — [Q2]-shaped path counting: Nodes ⋈ Edges ⋈ Edges ⋈ Nodes,
  GROUP BY (n1.label, n2.label).

Copy of the JAX package's ``data/queries.py``: the same generators draw
the same data from the same seed.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.query import JoinAggQuery
from repro_torch.relational.relation import Database


def _zipf_ids(rng, n, dom, a=1.3):
    z = rng.zipf(a, size=n)
    return (z - 1) % dom


def tpch_like(n: int, seed: int = 0) -> tuple[Database, JoinAggQuery]:
    rng = np.random.default_rng(seed)
    n_supp = max(2, n // 100)
    n_ord = max(2, n // 4)
    n_cust = max(2, n // 10)
    n_zip = max(2, n_cust // 20)
    lineitem = {
        "suppkey": rng.integers(0, n_supp, n),
        "orderkey": rng.integers(0, n_ord, n),
    }
    orders = {
        "orderkey": np.arange(n_ord),
        "custkey": rng.integers(0, n_cust, n_ord),
    }
    customer = {
        "custkey": np.arange(n_cust),
        "zipcode": _zipf_ids(rng, n_cust, n_zip),
    }
    supplier = {"suppkey": np.arange(n_supp), "sname": np.arange(n_supp)}
    db = Database.from_mapping(
        {
            "supplier": supplier,
            "lineitem": lineitem,
            "orders": orders,
            "customer": customer,
        }
    )
    q = JoinAggQuery(
        ("supplier", "lineitem", "orders", "customer"),
        (("supplier", "sname"), ("customer", "zipcode")),
    )
    return db, q


def dblp_like(n: int, seed: int = 0) -> tuple[Database, JoinAggQuery]:
    rng = np.random.default_rng(seed)
    n_auth = max(2, n // 5)
    n_pap = max(2, n // 3)
    auth = _zipf_ids(rng, n, n_auth)
    pap = rng.integers(0, n_pap, n)
    db = Database.from_mapping(
        {
            "AP1": {"a1": auth, "paper": pap},
            "AP2": {"a2": auth, "paper": pap},
        }
    )
    return db, JoinAggQuery(("AP1", "AP2"), (("AP1", "a1"), ("AP2", "a2")))


def ords_like(n: int, seed: int = 0) -> tuple[Database, JoinAggQuery]:
    rng = np.random.default_rng(seed)
    n_item = max(2, n // 50)
    n_inv = max(2, n // 8)
    item = _zipf_ids(rng, n, n_item, a=1.2)
    inv = rng.integers(0, n_inv, n)
    db = Database.from_mapping(
        {
            "I1": {"i1": item, "invoice": inv},
            "I2": {"i2": item, "invoice": inv},
        }
    )
    return db, JoinAggQuery(("I1", "I2"), (("I1", "i1"), ("I2", "i2")))


def imdb_like(n: int, seed: int = 0) -> tuple[Database, JoinAggQuery]:
    """[Q2] path counting: N1 ⋈ E1 ⋈ E2 ⋈ N2 grouped by labels."""
    rng = np.random.default_rng(seed)
    n_nodes = max(4, n // 10)
    n_labels = 24
    src = _zipf_ids(rng, n, n_nodes, a=1.25)
    dst = _zipf_ids(rng, n, n_nodes, a=1.25)
    labels = rng.integers(0, n_labels, n_nodes)
    db = Database.from_mapping(
        {
            "N1": {"id1": np.arange(n_nodes), "label1": labels},
            "E1": {"id1": src, "mid": dst},
            "E2": {"mid": src, "id2": dst},
            "N2": {"id2": np.arange(n_nodes), "label2": labels},
        }
    )
    q = JoinAggQuery(
        ("N1", "E1", "E2", "N2"),
        (("N1", "label1"), ("N2", "label2")),
    )
    return db, q


def skewed_chain_like(n: int, seed: int = 0) -> tuple[Database, JoinAggQuery]:
    """Two-hop chain R1(g1, p0) ⋈ R2(p0, g2), GROUP BY (g1, g2), where
    the join key ``p0`` is heavily skewed: ~30% of both sides land on one
    hot key, the rest spread over a wide domain.  This is the workload
    the statistics-driven planner's per-split plans exist for — the dense
    message over ``p0`` collapses from the full domain to singleton heavy
    ranges plus narrow light chunks (DESIGN.md §10, bench table 13)."""
    rng = np.random.default_rng(seed)
    dom = max(64, 2 * n)
    gdom = max(2, min(64, n // 30))
    heavy1 = rng.random(n) < 0.3
    heavy2 = rng.random(n) < 0.3
    db = Database.from_mapping(
        {
            "R1": {
                "g1": rng.integers(0, gdom, n),
                "p0": np.where(heavy1, 0, rng.integers(0, dom, n)),
            },
            "R2": {
                "p0": np.where(heavy2, 0, rng.integers(0, dom, n)),
                "g2": rng.integers(0, gdom, n),
            },
        }
    )
    q = JoinAggQuery(("R1", "R2"), (("R1", "g1"), ("R2", "g2")))
    return db, q


REAL = {"TPCH": tpch_like, "DBLP": dblp_like, "ORDS": ords_like, "IMDB": imdb_like}

# skewed workloads: exercised by the planner bench (table 13) and the
# plan-choice golden gate, kept out of REAL so the legacy Table-VI
# comparisons keep their historical workload set
SKEWED = {"SKEWCHAIN": skewed_chain_like}


# --- cyclic graph-pattern workloads (GHD compiler, DESIGN.md §3) ---------
#
# These join hypergraphs are cyclic, so the paper's acyclic JOIN-AGG
# cannot run them directly; the planner compiles them through a
# generalized hypertree decomposition (``repro_torch.ghd``).


def triangle_like(n: int, seed: int = 0) -> tuple[Database, JoinAggQuery]:
    """Triangle counting per vertex label on a scale-free directed graph:

        SELECT l.vlabel, COUNT(*)
        FROM E e1, E e2, E e3, L l
        WHERE e1.b = e2.b' ... (a→b→c→a) AND l.a = e1.a
        GROUP BY l.vlabel;
    """
    rng = np.random.default_rng(seed)
    n_nodes = max(8, n // 8)
    n_labels = max(2, min(16, n_nodes // 4))
    src = _zipf_ids(rng, n, n_nodes, a=1.1)
    dst = _zipf_ids(rng, n, n_nodes, a=1.1)
    labels = rng.integers(0, n_labels, n_nodes)
    db = Database.from_mapping(
        {
            "E1": {"a": src, "b": dst},
            "E2": {"b": src, "c": dst},
            "E3": {"c": src, "a": dst},
            "L": {"a": np.arange(n_nodes), "vlabel": labels},
        }
    )
    q = JoinAggQuery(("E1", "E2", "E3", "L"), (("L", "vlabel"),))
    return db, q


def four_cycle_like(n: int, seed: int = 0) -> tuple[Database, JoinAggQuery]:
    """4-cycle counting per anchor-vertex label (a→b→c→d→a)."""
    rng = np.random.default_rng(seed)
    n_nodes = max(8, n // 10)
    n_labels = max(2, min(16, n_nodes // 4))
    src = _zipf_ids(rng, n, n_nodes, a=1.1)
    dst = _zipf_ids(rng, n, n_nodes, a=1.1)
    labels = rng.integers(0, n_labels, n_nodes)
    db = Database.from_mapping(
        {
            "E1": {"a": src, "b": dst},
            "E2": {"b": src, "c": dst},
            "E3": {"c": src, "d": dst},
            "E4": {"d": src, "a": dst},
            "L": {"a": np.arange(n_nodes), "lab": labels},
        }
    )
    q = JoinAggQuery(("E1", "E2", "E3", "E4", "L"), (("L", "lab"),))
    return db, q


def fof_common_group_like(n: int, seed: int = 0) -> tuple[Database, JoinAggQuery]:
    """Friends-of-friends u–v–w where u and w belong to a common group,
    counted per group.  The group id both joins G1 ⋈ G2 *and* is the
    group-by attribute — the case the GHD compiler handles with the
    paper's column-copy convention."""
    rng = np.random.default_rng(seed)
    n_people = max(8, n // 10)
    n_groups = max(2, n_people // 6)
    db = Database.from_mapping(
        {
            "F1": {"u": _zipf_ids(rng, n, n_people), "v": _zipf_ids(rng, n, n_people)},
            "F2": {"v": _zipf_ids(rng, n, n_people), "w": _zipf_ids(rng, n, n_people)},
            "G1": {"u": _zipf_ids(rng, n, n_people), "grp": rng.integers(0, n_groups, n)},
            "G2": {"w": _zipf_ids(rng, n, n_people), "grp": rng.integers(0, n_groups, n)},
        }
    )
    q = JoinAggQuery(("F1", "F2", "G1", "G2"), (("G1", "grp"),))
    return db, q


CYCLIC = {
    "TRIANGLE": triangle_like,
    "FOURCYCLE": four_cycle_like,
    "FOFGROUP": fof_common_group_like,
}
