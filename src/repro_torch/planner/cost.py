"""Statistics-driven cost model for plan choice (DESIGN.md §10).

The byte heuristic (``node_message_bytes``) prices every decomposition
tree node at its *dense* message allocation, blind to how many of those
cells are ever nonzero.  This module adds the sparse side of the ledger:

* :func:`node_card_estimates` — estimated nonzero cardinality of each
  node's upward message, as the minimum of three upper estimates: the
  dense cell count, the product of per-attr surviving-distinct
  estimates (KMV sketches, bounded by every relation carrying the
  attr), and a fanout-chained subtree join-row estimate (sampled
  pairwise selectivities composed along tree edges).

* :func:`plan_cost` — the root-ranking key: per node, the dense bytes
  plus an 8-byte work term per estimated nonzero.  Ranked
  lexicographically ``(peak, total)``; on uniform data the dense term
  dominates and the ranking matches the byte heuristic, while
  skew/selectivity shifts the work term.

Copy of the JAX package's ``planner/cost.py`` without the measured
cardinalities and q-error of its ``explain(actuals=True)``.
"""
from __future__ import annotations

from repro_torch.core.operator import node_message_bytes
from repro_torch.core.prepare import Prepared
from repro_torch.stats.collect import Statistics


def message_attrs(prep: Prepared) -> dict[str, tuple[str, ...]]:
    """Attrs of each node's upward message: shared-with-parent attrs
    plus the subtree's group attrs (the axes ``node_message_bytes``
    prices)."""
    deco = prep.decomposition

    def subtree_gattrs(rel: str) -> list[str]:
        out = []
        g = prep.schema.group_of.get(rel)
        if g:
            out.append(g)
        for c in deco.nodes[rel].children:
            out.extend(subtree_gattrs(c))
        return out

    out: dict[str, tuple[str, ...]] = {}
    for rel in deco.order:
        node = deco.nodes[rel]
        up: tuple[str, ...] = ()
        if node.parent is not None:
            up = tuple(
                set(prep.schema.relevant[rel])
                & set(prep.schema.relevant[node.parent])
            )
        out[rel] = tuple(dict.fromkeys(list(up) + subtree_gattrs(rel)))
    return out


def _subtree_rels(prep: Prepared) -> dict[str, list[str]]:
    deco = prep.decomposition
    out: dict[str, list[str]] = {}

    def walk(rel: str) -> list[str]:
        rels = [rel]
        for c in deco.nodes[rel].children:
            rels.extend(walk(c))
        out[rel] = rels
        return rels

    walk(deco.root)
    return out


def subtree_join_rows(prep: Prepared, stats: Statistics) -> dict[str, float]:
    """Fanout-chained estimate of each subtree's join-row count:
    ``J(r) = rows(r) · Π_c fanout(r→c) · J(c)/rows(c)`` — each child
    subtree expands every matching child tuple by its own factor."""
    deco = prep.decomposition
    out: dict[str, float] = {}

    def rows_of(rel: str) -> float:
        rs = stats.relations.get(rel)
        return float(max(rs.rows, 1)) if rs is not None else 1.0

    def walk(rel: str) -> float:
        j = rows_of(rel)
        for c in deco.nodes[rel].children:
            jc = walk(c)
            fan = stats.fanout(rel, c)
            if fan is None:
                fan = 1.0
            j *= max(fan, 0.0) * (jc / rows_of(c))
        out[rel] = j
        return j

    walk(deco.root)
    return out


def node_card_estimates(
    prep: Prepared, stats: Statistics
) -> dict[str, float]:
    """Estimated nonzero cardinality of each node's upward message."""
    attrs_of = message_attrs(prep)
    subtree = _subtree_rels(prep)
    join_rows = subtree_join_rows(prep, stats)
    out: dict[str, float] = {}
    for rel, attrs in attrs_of.items():
        dense = 1.0
        distinct_cap = 1.0
        for a in attrs:
            dom = prep.dicts[a].size
            dense *= max(dom, 1)
            ests = [
                stats.distinct(r, a, default=float(dom))
                for r in subtree[rel]
                if a in prep.schema.relevant.get(r, ())
            ]
            distinct_cap *= min(ests) if ests else float(dom)
        out[rel] = max(1.0, min(dense, distinct_cap, join_rows[rel]))
    return out


def plan_cost(prep: Prepared, stats: Statistics) -> tuple[float, float]:
    """Root-ranking key ``(peak node cost, total cost)`` in bytes: the
    dense message allocation plus an 8-byte work term per estimated
    nonzero."""
    dense = node_message_bytes(prep)
    cards = node_card_estimates(prep, stats)
    refined = {r: dense[r] + 8.0 * cards[r] for r in dense}
    return (max(refined.values()), sum(refined.values()))
