"""Plan-invariant verifier (DESIGN.md §11).

Every structural invariant the materialization-free evaluation rests on,
stated as code.  ``verify_plan`` walks a compiled
:class:`~repro_torch.api.plan.Plan` and returns a list of
:class:`Diagnostic`\\ s — empty iff the plan is sound; ``Plan.verify()``
raises :class:`PlanInvariantError` on any finding, and ``compile_plan``
runs the same walk as a debug-mode assert when ``REPRO_VERIFY=1``.

Invariant catalog (one diagnostic code per invariant; the mutation suite
in ``tests/test_torch_verify.py`` proves each one fires):

============= =========================================================
code          invariant
============= =========================================================
V-TREE-ROOT   decomposition root exists and is a group relation
V-TREE-ORDER  node order is topological; parent/child pointers agree
V-TREE-LEAF   every tree leaf holds a group attribute (post-fold)
V-RIP         each attribute's relations form a connected subtree
V-CODES       encoded codes lie in [0, dom); multiplicities >= 0
V-STORE-CSR   memmap-backed CSR views: keys ascending, order a valid
              permutation, keys reproduce the raveled codes
V-CHAN-COUNT  exactly one COUNT channel, in slot 0
V-CHAN-DUP    no duplicate channels / min-max requests
V-CHAN-MEASURE  channel & min-max measures point at relations that
                actually carry the payload (post-fold re-pointing)
V-CHAN-RECIPE every aggregate's assembly recipe resolves against the
              plan's channels (AVG's SUM/COUNT pairing intact)
V-SPLIT-PARTITION  split ranges exactly partition [0, dom(attr))
V-SPLIT-ROOT  one root per range; each is a group relation
V-SPLIT-ATTR  split attr is a non-group join attribute
V-SPLIT-MINMAX  split plans carry no MIN/MAX (not range-additive)
V-SPLIT-HEAVY heavy keys are in-domain singleton ranges
V-SHARD-PARTITION  shard key ranges (and their CSR edge slices)
              exactly partition the root group attr's domain
V-SHARD-TILE  no shard is wider than the uniform tile its codes are
              re-based into
V-SENTINEL    a built sharded program's hop keys lie in [0, knum),
              ascending, with knum the product of the kept dims
V-KERN        every fused hop has a launch shape the kernel takes:
              positive block dimensions, blocks and edges within one
              launch's limits, dynamic shared memory within the
              default per-block limit, a float accumulator
V-OVERFLOW    sketch-estimated counts fit the accumulator dtype
V-GHD-COVER   every input relation is covered by its assigned bag
V-GHD-RIP     bags holding each attribute form a connected subtree
V-GHD-GROUP   no bag hosts two group relations
============= =========================================================

Port of the JAX package's ``analysis/verify.py``.  V-KERN checks the
launch shapes of ``kernels/ops.py`` in place of the TPU tile
configurations, and V-SENTINEL checks a rank's real hop keys: the port
pads no edges, so there is no pad sentinel to keep apart from them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.torch_engine import hop_launch_shapes
from repro_torch.kernels import ops
from repro_torch.planner.cost import subtree_join_rows

# float32 accumulators (the torch engine, both paths) hold exact integer
# counts up to 2**24 per partial product
F32_EXACT = 2**24


@dataclass(frozen=True)
class Diagnostic:
    """One verifier finding: a broken invariant at a plan site."""

    code: str  # invariant id, e.g. "V-RIP"
    site: str  # where, e.g. "tree/R2" or "split"
    message: str

    def __str__(self) -> str:
        return f"{self.code} at {self.site}: {self.message}"


class PlanInvariantError(AssertionError):
    """Raised by ``Plan.verify()`` when any invariant is violated."""

    def __init__(self, diagnostics: list[Diagnostic]):
        self.diagnostics = list(diagnostics)
        lines = [f"{len(self.diagnostics)} plan invariant violation(s):"]
        lines += [f"  {d}" for d in self.diagnostics]
        super().__init__("\n".join(lines))


# ----------------------------------------------------------------------
# decomposition tree + encodings
# ----------------------------------------------------------------------


def check_tree(prep) -> list[Diagnostic]:
    """V-TREE-ROOT / V-TREE-ORDER / V-TREE-LEAF / V-RIP."""
    out: list[Diagnostic] = []
    deco = prep.decomposition
    nodes = deco.nodes
    root = deco.root

    if root not in nodes:
        out.append(Diagnostic("V-TREE-ROOT", f"tree/{root}", "root is not a tree node"))
        return out  # nothing else is well-defined
    if root not in prep.schema.group_of:
        out.append(
            Diagnostic(
                "V-TREE-ROOT",
                f"tree/{root}",
                "root is not a group relation (Section III-A roots the "
                "tree at the source group relation)",
            )
        )
    if nodes[root].parent is not None:
        out.append(Diagnostic("V-TREE-ROOT", f"tree/{root}", "root has a parent"))

    if set(deco.order) != set(nodes) or len(deco.order) != len(nodes):
        out.append(
            Diagnostic(
                "V-TREE-ORDER",
                "tree",
                f"order {deco.order} does not enumerate the node set "
                f"{sorted(nodes)} exactly once",
            )
        )
    else:
        pos = {r: i for i, r in enumerate(deco.order)}
        for rel, node in nodes.items():
            if node.parent is not None and pos[node.parent] >= pos[rel]:
                out.append(
                    Diagnostic(
                        "V-TREE-ORDER",
                        f"tree/{rel}",
                        f"parent {node.parent!r} ordered after child "
                        f"{rel!r} (order must be topological)",
                    )
                )
    for rel, node in nodes.items():
        for c in node.children:
            if c not in nodes or nodes[c].parent != rel:
                out.append(
                    Diagnostic(
                        "V-TREE-ORDER",
                        f"tree/{rel}",
                        f"child {c!r} does not point back at {rel!r}",
                    )
                )

    for rel, node in nodes.items():
        if not node.children and rel not in prep.schema.group_of:
            out.append(
                Diagnostic(
                    "V-TREE-LEAF",
                    f"tree/{rel}",
                    "leaf relation carries no group attribute (the fold "
                    "rewrite must absorb pure-multiplier leaves)",
                )
            )

    # running intersection: climb each holder towards the root; connected
    # iff all holders of an attr converge on one top holder
    parent = {r: n.parent for r, n in nodes.items()}
    attrs = {a for r in nodes for a in prep.schema.relevant.get(r, ())}
    for attr in sorted(attrs):
        holders = {
            r for r in nodes if attr in prep.schema.relevant.get(r, ())
        }
        if len(holders) <= 1:
            continue
        tops = set()
        for r in holders:
            cur = r
            seen = {cur}
            while parent.get(cur) in holders and parent[cur] not in seen:
                cur = parent[cur]
                seen.add(cur)
            tops.add(cur)
        if len(tops) != 1:
            out.append(
                Diagnostic(
                    "V-RIP",
                    f"tree/{attr}",
                    f"attr {attr!r} is held by disconnected subtrees "
                    f"rooted at {sorted(tops)} — running intersection "
                    "violated, messages would double-count",
                )
            )
    return out


def check_codes(prep) -> list[Diagnostic]:
    """V-CODES: encoded codes in-range, multiplicities non-negative.

    Every hop's keys and gather indices ravel these codes over the
    domains; a code outside ``[0, dom)`` lands in another group's row or
    outside the output."""
    out: list[Diagnostic] = []
    for rel, er in prep.encoded.items():
        for i, a in enumerate(er.attrs):
            if er.num_rows == 0:
                continue
            col = er.codes[:, i]
            lo, hi = int(col.min()), int(col.max())
            dom = prep.dicts[a].size
            if lo < 0 or hi >= dom:
                out.append(
                    Diagnostic(
                        "V-CODES",
                        f"codes/{rel}",
                        f"{rel}.{a} codes span [{lo}, {hi}] outside "
                        f"[0, {dom}) — a hop would misroute its rows to "
                        "another group",
                    )
                )
        if er.num_rows and bool(np.any(er.count < 0)):
            out.append(
                Diagnostic(
                    "V-CODES",
                    f"codes/{rel}",
                    f"{rel} has negative multiplicities; the additive "
                    "merge assumes pre-aggregated counts >= 0",
                )
            )
    return out


def check_storage(prep) -> list[Diagnostic]:
    """V-STORE-CSR: every memmap-backed grouped-CSR view built by the
    external sort (DESIGN.md §12) must be a faithful sorted permutation
    of its encoding — ``keys`` ascending, ``order`` a permutation of
    ``[0, n)``, and ``keys == ravel(codes)[order]``.  A bug in the k-way
    merge (dropped run, split key, unstable tie-break) trips one of the
    three; in-RAM views are ``np.argsort`` by construction and skipped."""
    from repro_torch.core.prepare import _ravel

    out: list[Diagnostic] = []
    for (rel, key_attrs), view in getattr(prep, "_csr_cache", {}).items():
        if not isinstance(prep.encoded[rel].codes, np.memmap):
            continue  # in-RAM encodings build views via np.argsort
        site = f"storage/{rel}"
        n = prep.encoded[rel].num_rows
        if len(view.keys) != n or len(view.order) != n:
            out.append(
                Diagnostic(
                    "V-STORE-CSR",
                    site,
                    f"CSR view over {key_attrs} has {len(view.keys)} keys "
                    f"/ {len(view.order)} order entries for {n} rows",
                )
            )
            continue
        if n == 0:
            continue
        if bool(np.any(view.keys[1:] < view.keys[:-1])):
            out.append(
                Diagnostic(
                    "V-STORE-CSR",
                    site,
                    f"CSR keys over {key_attrs} are not ascending — "
                    "binary-search slicing would drop edges",
                )
            )
            continue
        order = np.asarray(view.order)
        seen = np.zeros(n, dtype=bool)
        in_range = (order >= 0) & (order < n)
        seen[order[in_range]] = True
        if not (in_range.all() and seen.all()):
            out.append(
                Diagnostic(
                    "V-STORE-CSR",
                    site,
                    f"CSR order over {key_attrs} is not a permutation of "
                    f"[0, {n}) — edges duplicated or lost in the merge",
                )
            )
            continue
        er = prep.encoded[rel]
        cols = [er.attrs.index(a) for a in key_attrs]
        dims = [prep.dicts[a].size for a in key_attrs]
        expect = _ravel(np.asarray(er.codes), cols, dims)[order]
        if not np.array_equal(np.asarray(view.keys), expect):
            out.append(
                Diagnostic(
                    "V-STORE-CSR",
                    site,
                    f"CSR keys over {key_attrs} disagree with the "
                    "raveled codes under the view's own permutation",
                )
            )
    return out


# ----------------------------------------------------------------------
# semiring channels
# ----------------------------------------------------------------------


def check_channels(plan) -> list[Diagnostic]:
    """V-CHAN-COUNT / V-CHAN-DUP / V-CHAN-MEASURE / V-CHAN-RECIPE."""
    out: list[Diagnostic] = []
    channels, minmax, prep = plan.channels, plan.minmax, plan.prep

    count_slots = [i for i, ch in enumerate(channels) if ch.kind == "count"]
    if count_slots != [0]:
        out.append(
            Diagnostic(
                "V-CHAN-COUNT",
                "channels",
                f"expected exactly one COUNT channel in slot 0, got "
                f"count slots {count_slots} of {len(channels)} channels "
                "(AVG and to_dict both divide by the slot-0 COUNT)",
            )
        )
    if len(set(channels)) != len(channels) or len(set(minmax)) != len(minmax):
        out.append(
            Diagnostic(
                "V-CHAN-DUP",
                "channels",
                "duplicate channel or min/max request (one fused pass "
                "must compute each channel once)",
            )
        )

    for ch in channels:
        if ch.kind != "sum":
            continue
        rel, _attr = ch.measure
        er = prep.encoded.get(rel)
        if er is None or "sum" not in er.payloads:
            out.append(
                Diagnostic(
                    "V-CHAN-MEASURE",
                    f"channels/{rel}",
                    f"SUM channel measures {rel!r} but that relation "
                    "carries no 'sum' payload (fold re-pointing broken)",
                )
            )
    for req in minmax:
        rel, _attr = req.measure
        er = prep.encoded.get(rel)
        if req.kind not in ("min", "max") or er is None or (
            req.kind not in er.payloads
        ):
            out.append(
                Diagnostic(
                    "V-CHAN-MEASURE",
                    f"channels/{rel}",
                    f"{req.kind.upper()} request measures {rel!r} but "
                    f"that relation carries no {req.kind!r} payload",
                )
            )

    has_count = bool(count_slots)
    for name, _agg in plan.aggs:
        recipe = plan.assemble.get(name)
        if recipe is None:
            out.append(
                Diagnostic(
                    "V-CHAN-RECIPE",
                    f"channels/{name}",
                    f"aggregate {name!r} has no assembly recipe",
                )
            )
            continue
        kind = recipe[0]
        if kind == "count":
            ok = has_count
        elif kind == "sum":
            ok = recipe[1] in channels
        elif kind == "avg":
            # the SUM/COUNT pairing: both halves must survive
            # channel fusion and demux
            ok = recipe[1] in channels and has_count
        elif kind == "minmax":
            ok = recipe[1] in minmax
        else:
            ok = False
        if not ok:
            out.append(
                Diagnostic(
                    "V-CHAN-RECIPE",
                    f"channels/{name}",
                    f"aggregate {name!r} recipe {recipe!r} does not "
                    "resolve against the plan's channels "
                    f"({len(channels)} channel(s), {len(minmax)} "
                    "min/max request(s))",
                )
            )
    return out


# ----------------------------------------------------------------------
# per-split plans
# ----------------------------------------------------------------------


def check_split(prep, split, minmax) -> list[Diagnostic]:
    """V-SPLIT-* — the additive merge is only sound over an exact
    disjoint partition of the split attribute's code space."""
    out: list[Diagnostic] = []
    attr = split.attr
    if attr not in prep.dicts:
        out.append(Diagnostic("V-SPLIT-ATTR", "split", f"unknown split attr {attr!r}"))
        return out
    dom = prep.dicts[attr].size

    cursor = 0
    broken = None
    for lo, hi in split.ranges:
        if lo != cursor or hi <= lo:
            broken = (lo, hi)
            break
        cursor = hi
    if broken is not None or cursor != dom:
        out.append(
            Diagnostic(
                "V-SPLIT-PARTITION",
                "split",
                f"ranges {list(split.ranges)} do not exactly partition "
                f"[0, {dom}) of {attr!r}"
                + (f" (first break at {broken})" if broken else "")
                + " — a gap loses groups, an overlap double-counts them "
                "through the additive merge",
            )
        )

    if len(split.roots) != len(split.ranges):
        out.append(
            Diagnostic(
                "V-SPLIT-ROOT",
                "split",
                f"{len(split.roots)} root(s) for {len(split.ranges)} "
                "range(s)",
            )
        )
    for i, root in enumerate(split.roots):
        if root not in prep.schema.group_of:
            out.append(
                Diagnostic(
                    "V-SPLIT-ROOT",
                    f"split/{i}",
                    f"range root {root!r} is not a group relation",
                )
            )

    group_attrs = {a for _, a in prep.group_attrs}
    if attr in group_attrs or attr not in prep.schema.join_attrs:
        out.append(
            Diagnostic(
                "V-SPLIT-ATTR",
                "split",
                f"split attr {attr!r} must be a non-group join attr "
                "(splitting a group axis would fragment output groups)",
            )
        )
    if minmax:
        out.append(
            Diagnostic(
                "V-SPLIT-MINMAX",
                "split",
                "split plan carries MIN/MAX requests; min/max are not "
                "additive across key ranges",
            )
        )
    ranges = set(split.ranges)
    for code, share in split.heavy:
        if not (0 <= code < dom) or (code, code + 1) not in ranges:
            out.append(
                Diagnostic(
                    "V-SPLIT-HEAVY",
                    "split",
                    f"heavy key {code} (share {share:.2f}) is not an "
                    "in-domain singleton range",
                )
            )
    return out


# ----------------------------------------------------------------------
# distributed shard partitions + hop keys
# ----------------------------------------------------------------------


def check_shards(prep, num_shards: int) -> list[Diagnostic]:
    """V-SHARD-* for a planned (host-side) shard count: the per-shard
    grouped-CSR key ranges of the root group attribute must exactly
    partition its domain, with contiguous, exhaustive edge slices."""
    out: list[Diagnostic] = []
    root = prep.decomposition.root
    attr = prep.schema.group_of.get(root)
    if attr is None:
        out.append(
            Diagnostic(
                "V-SHARD-PARTITION",
                f"shard/{root}",
                f"root {root!r} has no group attribute to shard",
            )
        )
        return out
    view = prep.csr_view(root, (attr,))
    dom = prep.dicts[attr].size
    if view.num_keys != dom:
        out.append(
            Diagnostic(
                "V-SHARD-PARTITION",
                f"shard/{root}",
                f"CSR view key space {view.num_keys} != dom({attr!r}) = {dom}",
            )
        )
    if len(view.keys) and (
        bool(np.any(np.diff(view.keys) < 0))
        or int(view.keys[0]) < 0
        or int(view.keys[-1]) >= view.num_keys
    ):
        out.append(
            Diagnostic(
                "V-SHARD-PARTITION",
                f"shard/{root}",
                "CSR keys are unsorted or out of range; binary-search "
                "slicing would return wrong edge blocks",
            )
        )
        return out

    shards = view.shard(num_shards)
    if len(shards) != num_shards:
        out.append(
            Diagnostic(
                "V-SHARD-PARTITION",
                "shard",
                f"{len(shards)} shard(s) for a mesh of {num_shards}",
            )
        )
    cursor = 0
    edge_cursor = 0
    ok = True
    for lo, hi, sl in shards:
        if lo != min(cursor, view.num_keys) or hi < lo or sl.start != edge_cursor:
            ok = False
            break
        cursor = max(cursor, hi)
        edge_cursor = sl.stop
    if not ok or cursor != view.num_keys or edge_cursor != len(view.keys):
        out.append(
            Diagnostic(
                "V-SHARD-PARTITION",
                "shard",
                f"shard ranges {[(lo, hi) for lo, hi, _ in shards]} / "
                "edge slices do not exactly partition the key space — "
                "a dropped or repeated CSR block changes the answer",
            )
        )

    tile = max(1, -(-view.num_keys // num_shards))
    widths = [hi - lo for lo, hi, _ in shards]
    if widths and max(widths) > tile:
        out.append(
            Diagnostic(
                "V-SHARD-TILE",
                "shard",
                f"shard width {max(widths)} exceeds the padded tile "
                f"{tile}; a rebased code could reach the OOB sentinel",
            )
        )
    return out


def verify_distributed_program(prog) -> list[Diagnostic]:
    """V-SHARD-* / V-SENTINEL on a *built*
    :class:`~repro_torch.core.distributed.DistributedSparseProgram`:
    checks its ranges, its tile and the hop keys this rank's walk reads,
    not just the planned arithmetic."""
    out: list[Diagnostic] = []
    dom = prog.prep.dicts[prog.attr].size

    cursor = 0
    for lo, hi in prog.ranges:
        if lo != min(cursor, dom) or hi < lo:
            cursor = -1
            break
        cursor = max(cursor, hi)
    if cursor != dom:
        out.append(
            Diagnostic(
                "V-SHARD-PARTITION",
                f"distributed/{prog.attr}",
                f"shard ranges {list(prog.ranges)} do not partition [0, {dom})",
            )
        )
    widths = [hi - lo for lo, hi in prog.ranges]
    if widths and (prog.tile < max(widths) or prog.tile < 1):
        out.append(
            Diagnostic(
                "V-SHARD-TILE",
                f"distributed/{prog.attr}",
                f"tile {prog.tile} < max shard width {max(widths)}",
            )
        )

    for hop in prog.hops:
        knum = hop.knum
        site = f"distributed/{hop.rel}"
        if knum != math.prod(hop.kept_dims) or knum < 1:
            out.append(
                Diagnostic(
                    "V-SENTINEL",
                    site,
                    f"hop key space knum={knum} inconsistent with kept dims "
                    f"{hop.kept_dims}",
                )
            )
            continue
        keys = np.asarray(prog.host_keys(hop))
        bad = int(np.count_nonzero((keys < 0) | (keys >= knum)))
        if bad:
            out.append(
                Diagnostic(
                    "V-SENTINEL",
                    site,
                    f"{bad} hop key(s) outside [0, {knum}) — the reduction "
                    "would drop or misroute real edges",
                )
            )
        elif bool(np.any(keys[1:] < keys[:-1])):
            out.append(
                Diagnostic(
                    "V-SENTINEL",
                    site,
                    "hop keys are not ascending — the kernels' row walk "
                    "would split an output row's edges",
                )
            )
    return out


# ----------------------------------------------------------------------
# fused-hop launch shapes (DESIGN.md §13)
# ----------------------------------------------------------------------

_WALK_DIMS = ("rows_per_tile", "slab", "slabs", "blocks")
_GATHER_DIMS = ("slab", "slabs", "rows_per_block", "tiles", "blocks", "warps")


def check_kernels(plan) -> list[Diagnostic]:
    """V-KERN: every hop of every pass of the fused path
    (``plan.fused_runs()``: key ranges, stream tiles, MIN/MAX passes) has
    a launch shape its kernel takes
    (:func:`~repro_torch.core.torch_engine.hop_launch_shapes`, the cost
    model's pick of ``kernels/autotune.py``, never a card's measured one):
    ``make_walk_plan``/``make_gather_plan`` could make one, every block dimension
    is positive, blocks stay within one launch's :data:`ops.MAX_BLOCKS`,
    edges within the 32-bit run bounds :data:`ops.MAX_EDGES`, dynamic
    shared memory within :data:`ops.SMEM_LIMIT` (what a block gets
    without opting in), and the accumulator is a float type (the
    MIN/MAX identities ±inf have no integer encoding)."""
    out: list[Diagnostic] = []
    entries = [
        (e, "/".join(x for x in (r["run"], "min-max" if r["pass"] == "min/max" else "",
                                 e["rel"]) if x))
        for r in plan.fused_runs()
        for e in hop_launch_shapes(r["prep"], r["k"], r["encoded"], r["domains"])
    ]
    for e, where in entries:
        site = f"kernel/{where}"

        def bad(msg: str) -> None:
            out.append(Diagnostic("V-KERN", site, msg))

        p = e["plan"]
        if p is None:
            bad(f"no {e['walk']} walk launch shape: {e['error']}")
            continue
        for name in _GATHER_DIMS if e["walk"] == "gather" else _WALK_DIMS:
            if getattr(p, name) <= 0:
                bad(f"{name}={getattr(p, name)} is not positive — the launch "
                    "would cover no output")
        if p.blocks > ops.MAX_BLOCKS:
            bad(f"{p.blocks} blocks exceed one launch's {ops.MAX_BLOCKS}")
        if e["edges"] > ops.MAX_EDGES:
            bad(f"{e['edges']} edges exceed the 32-bit run bounds "
                f"({ops.MAX_EDGES})")
        if not 0 <= p.smem_bytes <= ops.SMEM_LIMIT:
            bad(f"{p.smem_bytes} B of dynamic shared memory outside [0, "
                f"{ops.SMEM_LIMIT}] — the launch would be refused")
        if e["acc_dtype"] not in ("float32", "float64"):
            bad(f"accumulator dtype {e['acc_dtype']!r} cannot carry the "
                "min/max ±inf identities")
    return out


# ----------------------------------------------------------------------
# accumulator overflow at sketch-estimated cardinalities
# ----------------------------------------------------------------------


def check_overflow(prep, engine_name: str) -> list[Diagnostic]:
    """V-OVERFLOW: the fanout-chained subtree join-row estimate bounds
    (in estimate) any single count cell; past the float-exactness cliff
    the additive merges silently lose integer precision.  The torch
    engine accumulates in float32 on both paths."""
    out: list[Diagnostic] = []
    est = subtree_join_rows(prep, prep.stats)
    worst = max(est.items(), key=lambda kv: kv[1], default=None)
    if worst is not None and worst[1] > F32_EXACT:
        out.append(
            Diagnostic(
                "V-OVERFLOW",
                f"overflow/{worst[0]}",
                f"estimated subtree join rows {worst[1]:.3g} at node "
                f"{worst[0]!r} exceed the f32 exact-integer limit "
                f"{F32_EXACT} for engine {engine_name!r} — counts would "
                "round silently",
            )
        )
    return out


# ----------------------------------------------------------------------
# GHD plans
# ----------------------------------------------------------------------


def verify_ghd_plan(gplan) -> list[Diagnostic]:
    """V-GHD-* on a :class:`~repro_torch.ghd.rewrite.GHDPlan` (edge cover,
    running intersection over bags, one group relation per bag)."""
    out: list[Diagnostic] = []
    ghd = gplan.ghd
    for r, e in gplan.edges.items():
        b = ghd.cover_of.get(r)
        if b is None or not frozenset(e) <= frozenset(ghd.bags[b].attrs):
            out.append(
                Diagnostic(
                    "V-GHD-COVER",
                    f"ghd/{r}",
                    f"relation {r!r} (attrs {sorted(e)}) is not "
                    f"covered by its assigned bag {b!r}",
                )
            )
    attrs = {a for e in gplan.edges.values() for a in e}

    parent = {b: ghd.bags[b].parent for b in ghd.bags}
    for a in sorted(attrs):
        holders = {b for b in ghd.order if a in ghd.bags[b].attrs}
        if len(holders) <= 1:
            continue
        tops = set()
        for b in holders:
            cur = b
            seen = {cur}
            while parent.get(cur) in holders and parent[cur] not in seen:
                cur = parent[cur]
                seen.add(cur)
            tops.add(cur)
        if len(tops) != 1:
            out.append(
                Diagnostic(
                    "V-GHD-RIP",
                    f"ghd/{a}",
                    f"bags holding attr {a!r} form disconnected "
                    f"subtrees rooted at {sorted(tops)}",
                )
            )

    hosts: dict[str, list[str]] = {}
    for rel, _g in gplan.query.group_by:
        b = ghd.cover_of.get(rel)
        if b is not None:
            hosts.setdefault(b, []).append(rel)
    for b, rels in hosts.items():
        if len(set(rels)) > 1:
            out.append(
                Diagnostic(
                    "V-GHD-GROUP",
                    f"ghd/{b}",
                    f"bag {b!r} hosts group relations {sorted(set(rels))}; "
                    "the derived query allows one group attr per bag",
                )
            )
    return out


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------


def verify_sparse_program(prog) -> list[Diagnostic]:
    """Verify a :class:`~repro_torch.core.torch_engine.SparseProgram`: tree +
    encodings + channel-measure wiring."""
    out = check_tree(prog.prep) + check_codes(prog.prep)
    for c, rel in enumerate(prog.channel_measures):
        if rel is None:
            continue
        er = prog.prep.encoded.get(rel)
        if er is None or "sum" not in er.payloads:
            out.append(
                Diagnostic(
                    "V-CHAN-MEASURE",
                    f"channels/{rel}",
                    f"sparse channel {c} measures {rel!r} but that "
                    "relation carries no 'sum' payload",
                )
            )
    return out


def verify_plan(plan) -> list[Diagnostic]:
    """Walk one compiled :class:`~repro_torch.api.plan.Plan` and check
    every applicable invariant.  Returns diagnostics (empty = sound)."""
    prep = plan.prep
    out = check_tree(prep)
    tree_broken = any(d.code in ("V-TREE-ROOT", "V-TREE-ORDER") for d in out)
    out += check_codes(prep)
    out += check_storage(prep)
    out += check_channels(plan)
    if plan.ghd_plan is not None:
        out += verify_ghd_plan(plan.ghd_plan)
    if plan.split is not None:
        out += check_split(prep, plan.split, plan.minmax)
    if tree_broken:
        # the shard, kernel and overflow checks walk the tree from the
        # root; on a malformed tree the V-TREE-* findings already say why
        return out
    if plan.mesh is not None:
        from repro_torch.core.distributed import mesh_shards

        out += check_shards(prep, mesh_shards(plan.mesh))
    if getattr(plan.engine, "supports_fused", False):
        out += check_kernels(plan)
    if plan.stats_enabled:
        out += check_overflow(prep, plan.engine.name)
    return out
