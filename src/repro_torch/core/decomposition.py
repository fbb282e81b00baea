"""Query decomposition tree + attribute splitting (paper Sections III-A/B).

One tree node per relation, rooted at a *group relation* (the source
relation ``R_S``).  The paper builds the tree by BFS over the hypergraph;
BFS alone does not guarantee the running-intersection property for every
acyclic hypergraph, so we build a maximum-weight spanning tree over the
relation-intersection graph (weight = |shared attrs|, ties broken in query
order — identical to the paper's BFS on its example queries) and verify
the running-intersection property explicitly.

Attribute splitting (Section III-B) partitions each relation's relevant
attrs into ``(x_l, x_r)``:

* root ``R_S``:        ``x_l = {g0}``, ``x_r`` = attrs shared with children
* non-root group rel:  ``x_l = attrs \\ {g_i}``, ``x_r = {g_i}`` (sink)
* other relations:     ``x_l`` = attrs shared with parent,
                       ``x_r`` = attrs shared with children

Relation types (Section III-C): source ``R_S``, group ``R_G``, branching
``R_B`` (>1 child, or a non-leaf non-root group relation), intermediate
``R_J``.  The *connector* side (where children attach) is ``x_r`` except
for non-root group relations, whose join attrs all live in ``x_l``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.hypergraph import Hypergraph
from repro_torch.core.query import QuerySchema


@dataclass
class TreeNode:
    rel: str
    parent: str | None
    children: list[str] = field(default_factory=list)
    x_l: tuple[str, ...] = ()
    x_r: tuple[str, ...] = ()
    is_group: bool = False
    is_branching: bool = False

    @property
    def is_source(self) -> bool:
        return self.parent is None

    @property
    def connector(self) -> tuple[str, ...]:
        """Attrs of the node children attach to (and branching is keyed on)."""
        if self.is_group and not self.is_source:
            return self.x_l
        return self.x_r


@dataclass
class Decomposition:
    root: str
    nodes: dict[str, TreeNode]
    order: list[str]  # topological (parent before child)
    group_relations: list[str]
    # pid semantics: nearest branching ancestor of each relation (None = source)
    anchor: dict[str, str | None]
    # group relation -> branching node whose subtree directly holds its sink
    sink_anchor: dict[str, str | None]
    # branching relation -> its parent branching relation (None = source level)
    branching_parent: dict[str, str | None]

    def direct_groups(self, b: str | None) -> list[str]:
        return [g for g in self.group_relations
                if g != self.root and self.sink_anchor[g] == b]

    def child_branchings(self, b: str | None) -> list[str]:
        return [r for r, n in self.nodes.items()
                if n.is_branching and self.branching_parent[r] == b]


def _max_spanning_tree(hg: Hypergraph, root: str, order: list[str]) -> dict[str, str]:
    """Prim's algorithm from ``root``; returns child -> parent."""
    idx = {r: i for i, r in enumerate(order)}
    in_tree = {root}
    parent: dict[str, str] = {}
    while len(in_tree) < len(order):
        best: tuple[int, int, int, str, str] | None = None
        for r in order:
            if r in in_tree:
                continue
            for p in in_tree:
                w = len(hg.edges[r] & hg.edges[p])
                if w == 0:
                    continue
                cand = (-w, idx[p], idx[r], p, r)
                if best is None or cand < best:
                    best = cand
        if best is None:
            raise ValueError("query hypergraph is disconnected (cross product)")
        _, _, _, p, r = best
        parent[r] = p
        in_tree.add(r)
    return parent


def _check_running_intersection(hg: Hypergraph, parent: dict[str, str]) -> None:
    """Each attribute's relations must induce a connected subtree."""
    for attr in hg.vertices:
        holders = [r for r, attrs in hg.edges.items() if attr in attrs]
        if len(holders) <= 1:
            continue
        # climb each holder towards the root until we leave the holder set;
        # connected iff all holders converge on a single 'top' holder.
        tops = set()
        for r in holders:
            cur = r
            while cur in parent and parent[cur] in holders:
                cur = parent[cur]
            # also allow passing through non-holders? RIP forbids it.
            tops.add(cur)
        if len(tops) != 1:
            raise ValueError(
                f"running-intersection violated for attr {attr!r}: "
                "query is cyclic or needs a different decomposition "
                "(paper scope: acyclic joins only)"
            )


def decompose(schema: QuerySchema, hg: Hypergraph, root: str | None = None) -> Decomposition:
    if not hg.is_acyclic():
        raise ValueError("cyclic join query: out of scope (paper Section II-A)")
    group_rels = [r for r in schema.query.relations
                  if r in schema.group_of and r in hg.edges]
    if not group_rels:
        raise ValueError("query needs at least one group-by attribute")
    if root is None:
        root = group_rels[0]
    if root not in schema.group_of:
        raise ValueError(f"root {root!r} must be a group relation (Section III-A)")

    # relations surviving the fold rewrite only
    order_all = [r for r in schema.query.relations if r in hg.edges]
    parent = _max_spanning_tree(hg, root, order_all)
    _check_running_intersection(hg, parent)

    nodes: dict[str, TreeNode] = {
        r: TreeNode(r, parent.get(r), is_group=r in schema.group_of) for r in order_all
    }
    for r, p in parent.items():
        nodes[p].children.append(r)

    # topological order (BFS from root, children in query order)
    order: list[str] = []
    queue = [root]
    while queue:
        cur = queue.pop(0)
        order.append(cur)
        queue.extend(c for c in order_all if parent.get(c) == cur)

    # --- attribute splitting (Section III-B) ---
    for r in order:
        n = nodes[r]
        attrs = set(schema.relevant[r])
        shared_children: set[str] = set()
        for c in n.children:
            shared_children |= attrs & set(schema.relevant[c])
        if n.is_source:
            g = schema.group_of[r]
            n.x_l = (g,)
            n.x_r = tuple(sorted(shared_children))
        elif n.is_group:
            g = schema.group_of[r]
            n.x_l = tuple(sorted(attrs - {g}))
            n.x_r = (g,)
        else:
            shared_parent = attrs & set(schema.relevant[n.parent])
            n.x_l = tuple(sorted(shared_parent))
            n.x_r = tuple(sorted(shared_children))
            if not n.x_r:
                raise ValueError(
                    f"leaf relation {r!r} has no group attr; fold it first "
                    "(core.rewrite.fold_leaf_multipliers)"
                )

    # --- relation types ---
    for r in order:
        n = nodes[r]
        n.is_branching = (len(n.children) > 1) or (
            n.is_group and not n.is_source and len(n.children) > 0
        )

    # --- branching hierarchy (for path-id semantics, Section IV-A) ---
    anchor: dict[str, str | None] = {root: None}
    for r in order[1:]:
        p = parent[r]
        anchor[r] = p if nodes[p].is_branching else anchor[p]
    sink_anchor: dict[str, str | None] = {}
    for g in group_rels:
        if g == root:
            continue
        sink_anchor[g] = g if nodes[g].is_branching else anchor[g]
    branching_parent: dict[str, str | None] = {
        r: anchor[r] for r, n in nodes.items() if n.is_branching
    }

    return Decomposition(
        root=root,
        nodes=nodes,
        order=order,
        group_relations=group_rels,
        anchor=anchor,
        sink_anchor=sink_anchor,
        branching_parent=branching_parent,
    )
