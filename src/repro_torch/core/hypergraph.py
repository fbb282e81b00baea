"""Query hypergraph ``H(X ∪ G, E_H)`` and GYO acyclicity test (Section II-A).

Vertices are the query-relevant attributes; one hyperedge per relation.
Acyclicity is decided by GYO/ear reduction [Tarjan & Yannakakis '84], the
"standard elimination algorithm" the paper builds its decomposition on.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.query import QuerySchema


@dataclass
class Hypergraph:
    edges: dict[str, frozenset[str]]  # relation name -> attr set

    @property
    def vertices(self) -> frozenset[str]:
        out: set[str] = set()
        for e in self.edges.values():
            out |= e
        return frozenset(out)

    def neighbors(self, rel: str) -> list[str]:
        """Relations sharing at least one attribute with ``rel`` (stable order)."""
        mine = self.edges[rel]
        return [r for r in self.edges if r != rel and self.edges[r] & mine]

    def is_acyclic(self) -> bool:
        edges = {r: set(a) for r, a in self.edges.items()}
        changed = True
        while changed and len(edges) > 1:
            changed = False
            # vertex occurrence counts
            occ: dict[str, int] = {}
            for attrs in edges.values():
                for a in attrs:
                    occ[a] = occ.get(a, 0) + 1
            # remove isolated vertices (appear in exactly one edge)
            for r in list(edges):
                iso = {a for a in edges[r] if occ[a] == 1}
                if iso:
                    edges[r] -= iso
                    changed = True
            # remove edges contained in another edge (incl. now-empty ones)
            for r in list(edges):
                if any(r2 != r and edges[r] <= edges[r2] for r2 in edges):
                    del edges[r]
                    changed = True
                    break
        return len(edges) <= 1


def build_hypergraph(schema: QuerySchema) -> Hypergraph:
    return Hypergraph({r: frozenset(a) for r, a in schema.relevant.items()})
