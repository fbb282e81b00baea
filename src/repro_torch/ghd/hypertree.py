"""Generalized hypertree decomposition by elimination-order search.

A GHD of the query hypergraph is a rooted tree of attribute *bags* such
that (1) every relation's attr set is contained in some bag (edge cover)
and (2) each attribute's bags form a connected subtree (running
intersection).  Materializing each bag as one relation turns any cyclic
query into an acyclic one over the bag tree (AJAR; see DESIGN.md §3).

Construction is the classic elimination game: eliminating attribute ``v``
emits the bag ``{v} ∪ N(v)`` and cliques its neighbors.  We search over
elimination orders — exhaustively for small attr counts, otherwise
min-degree / min-fill / min-estimated-size greedy orders plus seeded
shuffles — and keep the tree minimizing the *estimated* maximum bag size:

    est(bag) = min over covering relations R of  |R| · Π_{a ∈ bag∖R} |dom(a)|

(the product of attr domains, capped by the tightest covering relation).

Copy of the JAX package's ``ghd/hypertree.py`` without two accessors
nothing here reads.  Every choice is deterministic (the shuffles draw
from ``random.Random(0)``, ties break on sorted names and positions),
so both packages build the same bags, order and relation cover.
"""
from __future__ import annotations

import itertools
import random
from dataclasses import dataclass

EXHAUSTIVE_MAX_ATTRS = 6  # 6! = 720 orders; beyond that use heuristics
N_RANDOM_ORDERS = 8


@dataclass
class Bag:
    name: str
    attrs: tuple[str, ...]  # sorted
    parent: str | None
    relations: tuple[str, ...] = ()  # assigned (covered) input relations


@dataclass
class GHD:
    bags: dict[str, Bag]
    root: str
    order: list[str]  # topological, parent before child
    cover_of: dict[str, str]  # input relation -> assigned bag
    est_elems: dict[str, int]  # estimated materialized tuples per bag
    width: int  # max relations assigned to one bag (integer cover width)


def _bag_estimate(
    attrs: frozenset[str],
    edges: dict[str, frozenset[str]],
    domains: dict[str, int],
    rows: dict[str, int],
) -> int:
    est = 1
    for a in attrs:
        est *= max(1, domains.get(a, 1))
    for r, e in edges.items():
        if e <= attrs:
            cap = rows[r]
            for a in attrs - e:
                cap *= max(1, domains.get(a, 1))
            est = min(est, cap)
    return est


def _eliminate(order: list[str], edges: dict[str, frozenset[str]]):
    """Run the elimination game; yields (eliminated attr, bag attr set)."""
    adj: dict[str, set[str]] = {a: set() for a in order}
    for e in edges.values():
        for x in e:
            adj[x] |= set(e) - {x}
    removed: set[str] = set()
    raw: list[tuple[str, frozenset[str]]] = []
    for v in order:
        nbrs = adj[v] - removed
        raw.append((v, frozenset(nbrs | {v})))
        removed.add(v)
        for x in nbrs:
            adj[x] |= nbrs - {x}
    return raw


def _raw_tree(raw: list[tuple[str, frozenset[str]]]):
    """Bag tree from elimination: parent(i) = bag of the first-eliminated
    attr among ``bag_i ∖ {v_i}`` (always a later bag).  Then prune bags
    contained in a tree neighbor.  Returns (attrs, parent) keyed by index."""
    pos = {v: i for i, (v, _) in enumerate(raw)}
    attrs = {i: set(bag) for i, (_, bag) in enumerate(raw)}
    parent: dict[int, int | None] = {}
    for i, (v, bag) in enumerate(raw):
        rest = bag - {v}
        parent[i] = min((pos[x] for x in rest), default=None) if rest else None

    children: dict[int, list[int]] = {i: [] for i in attrs}
    for i, p in parent.items():
        if p is not None:
            children[p].append(i)

    changed = True
    while changed:
        changed = False
        for i in list(attrs):
            if i not in attrs:
                continue
            p = parent[i]
            if p is None:
                continue
            if attrs[i] <= attrs[p]:
                # drop i; its children move under p
                children[p].remove(i)
                for c in children.pop(i):
                    parent[c] = p
                    children[p].append(c)
                del attrs[i], parent[i]
                changed = True
            elif attrs[p] <= attrs[i]:
                # child absorbs parent: i takes p's place in the tree
                gp = parent[p]
                children[p].remove(i)
                for c in children.pop(p):
                    parent[c] = i
                    children[i].append(c)
                parent[i] = gp
                if gp is not None:
                    children[gp].remove(p)
                    children[gp].append(i)
                del attrs[p], parent[p]
                changed = True
    return attrs, parent


def _candidate_orders(
    attrs: list[str],
    edges: dict[str, frozenset[str]],
    domains: dict[str, int],
    group_attrs: frozenset[str] = frozenset(),
):
    if len(attrs) <= EXHAUSTIVE_MAX_ATTRS:
        yield from itertools.permutations(attrs)
        return

    occ = {a: sum(a in e for e in edges.values()) for a in attrs}

    def greedy(key) -> tuple[str, ...]:
        adj: dict[str, set[str]] = {a: set() for a in attrs}
        for e in edges.values():
            for x in e:
                adj[x] |= set(e) - {x}
        left = set(attrs)
        out = []
        while left:
            v = min(sorted(left), key=lambda a: key(a, adj, left))
            nbrs = adj[v] & left
            for x in nbrs:
                adj[x] |= nbrs - {x}
            left.remove(v)
            out.append(v)
        return tuple(out)

    def fill_in(a, adj, left):
        nbrs = adj[a] & left
        return sum(
            1 for x, y in itertools.combinations(sorted(nbrs), 2) if y not in adj[x]
        )

    yield greedy(lambda a, adj, left: len(adj[a] & left))  # min-degree
    yield greedy(fill_in)  # min-fill
    yield greedy(lambda a, adj, left: (occ[a], domains.get(a, 1)))  # private/small first
    if group_attrs:
        # AJAR-style aggregate-aware order: eliminate aggregated-away
        # attrs first so group attrs (which must survive to the output)
        # sit near the root and avoid widening the interior bags
        yield greedy(
            lambda a, adj, left: (a in group_attrs, len(adj[a] & left))
        )
    rng = random.Random(0)
    for _ in range(N_RANDOM_ORDERS):
        perm = list(attrs)
        rng.shuffle(perm)
        yield tuple(perm)


def build_ghd(
    edges: dict[str, frozenset[str]],
    domains: dict[str, int],
    rows: dict[str, int],
    group_of: dict[str, str] | None = None,
) -> GHD:
    """Minimum-estimated-width GHD of the hypergraph ``edges``.

    ``domains`` maps attr -> domain size, ``rows`` relation -> tuple count
    (both drive the bag-size estimates); ``group_of`` marks group relations
    so no two of them share an assigned bag (the derived acyclic query
    allows one group attribute per relation)."""
    all_attrs = sorted({a for e in edges.values() for a in e})
    group_of = group_of or {}
    group_attrs = frozenset(group_of.values())

    best: tuple[tuple, dict, dict] | None = None
    seen_trees: set[frozenset] = set()
    for order in _candidate_orders(all_attrs, edges, domains, group_attrs):
        raw = _eliminate(list(order), edges)
        battrs, bparent = _raw_tree(raw)
        sig = frozenset(frozenset(v) for v in battrs.values())
        if sig in seen_trees:
            continue
        seen_trees.add(sig)
        ests = {
            i: _bag_estimate(frozenset(v), edges, domains, rows)
            for i, v in battrs.items()
        }
        # aggregate-aware (AJAR-style) component: bags carrying group
        # attrs become output-carrying messages in the derived acyclic
        # plan, so their estimated size is weighted separately — between
        # trees tied on (max, sum), prefer the one keeping group-attr
        # bags small
        gpen = sum(
            est for i, est in ests.items() if battrs[i] & group_attrs
        )
        cost = (max(ests.values()), sum(ests.values()), gpen, len(battrs))
        if best is None or cost < best[0]:
            best = (cost, battrs, bparent)
    assert best is not None
    _, battrs, bparent = best

    # --- relabel in topological order from the root ---
    roots = [i for i, p in bparent.items() if p is None]
    if len(roots) != 1:
        raise ValueError("query hypergraph is disconnected (cross product)")
    topo: list[int] = []
    queue = [roots[0]]
    while queue:
        cur = queue.pop(0)
        topo.append(cur)
        queue.extend(sorted(i for i, p in bparent.items() if p == cur))
    name_of = {i: f"bag{k}" for k, i in enumerate(topo)}

    bags: dict[str, Bag] = {}
    for i in topo:
        p = bparent[i]
        bags[name_of[i]] = Bag(
            name=name_of[i],
            attrs=tuple(sorted(battrs[i])),
            parent=name_of[p] if p is not None else None,
        )
    order_names = [name_of[i] for i in topo]

    # --- assign each relation to its tightest covering bag ---
    cover_of: dict[str, str] = {}
    for r, e in edges.items():
        cands = [b for b in order_names if e <= frozenset(bags[b].attrs)]
        if not cands:
            raise AssertionError(f"GHD edge cover violated for {r!r}")
        cover_of[r] = min(
            cands,
            key=lambda b: (
                _bag_estimate(frozenset(bags[b].attrs), edges, domains, rows),
                len(bags[b].attrs),
                order_names.index(b),
            ),
        )

    # --- no two group relations in one bag: carve dedicated child bags ---
    taken: dict[str, str] = {}  # bag -> group relation holding it
    for r in sorted(group_of, key=lambda r: order_names.index(cover_of[r])):
        b = cover_of[r]
        if b not in taken:
            taken[b] = r
            continue
        new = f"bag{len(bags)}"
        bags[new] = Bag(name=new, attrs=tuple(sorted(edges[r])), parent=b)
        order_names.append(new)
        cover_of[r] = new
        taken[new] = r

    # --- strip private attrs (one owning relation) from non-owner bags ---
    owner: dict[str, str] = {}
    for a in all_attrs:
        holders = [r for r, e in edges.items() if a in e]
        if len(holders) == 1:
            owner[a] = holders[0]
    for bname in order_names:
        bag = bags[bname]
        keep = tuple(
            a for a in bag.attrs
            if a not in owner or cover_of[owner[a]] == bname
        )
        if keep:  # never strip a bag empty
            bags[bname] = Bag(bname, keep, bag.parent)

    # --- record assignments + final estimates ---
    for bname in order_names:
        rels = tuple(sorted(r for r, b in cover_of.items() if b == bname))
        bags[bname] = Bag(bname, bags[bname].attrs, bags[bname].parent, rels)
    est_elems = {
        b: _bag_estimate(frozenset(bags[b].attrs), edges, domains, rows)
        for b in order_names
    }
    width = max((len(bags[b].relations) for b in order_names), default=0)
    return GHD(bags, order_names[0], order_names, cover_of, est_elems, width)


def verify_ghd(ghd: GHD, edges: dict[str, frozenset[str]]) -> None:
    """Assert the two GHD properties (edge cover + running intersection)."""
    for r, e in edges.items():
        b = ghd.cover_of[r]
        assert e <= frozenset(ghd.bags[b].attrs), (r, b)
    # running intersection: bags holding each attr form a connected subtree
    for a in {x for e in edges.values() for x in e}:
        holders = {b for b in ghd.order if a in ghd.bags[b].attrs}
        if len(holders) <= 1:
            continue
        tops = set()
        for b in holders:
            cur = b
            while ghd.bags[cur].parent in holders:
                cur = ghd.bags[cur].parent
            tops.add(cur)
        assert len(tops) == 1, f"running intersection violated for attr {a!r}"
