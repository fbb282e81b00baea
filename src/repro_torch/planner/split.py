"""Per-split planning: skew-partitioned execution (DESIGN.md §10).

When the heavy-hitter sketch of a join attribute shows skew above
``SPLIT_MIN_SHARE``, the planner partitions that attribute's code space
into heavy/light key ranges (each heavy key a singleton range, the light
remainder in contiguous chunks), executes the plan once per range over
``csr_restrict``-sliced relations — with a *per-range root*, re-chosen
because a singleton heavy range collapses that attribute's domain to 1
and can move the bottleneck node — and merges the per-range group
partials additively on the host.

Every message carrying the split attribute shrinks from ``|dom(attr)|``
to the range width on its attr axis, which is where the peak reduction
comes from.  The merge is a plain per-group sum in float64: COUNT/SUM
channels are additive across disjoint key ranges of a join attribute,
and for integer-valued payloads the merged result is bit-identical to
the unsplit plan (sums of integers are exact and order-free below 2^53).

Split plans are restricted to acyclic, unstreamed plans with no MIN/MAX
requests (MIN/MAX are not additive across ranges).

Copy of the JAX package's ``planner/split.py``.  Execution is split in
two: :func:`split_parts` builds the per-range ``Prepared`` set once (the
plan memoizes it, so a warm execute reuses every range's device views)
and :func:`execute_split` runs and merges them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.api.engines import Channel, EngineOutput
from repro_torch.core.decomposition import decompose
from repro_torch.core.hypergraph import Hypergraph
from repro_torch.core.operator import peak_message_bytes
from repro_torch.core.prepare import Prepared, csr_restrict
from repro_torch.relational.encoding import Dictionary, EncodedRelation
from repro_torch.stats.collect import Statistics

SPLIT_MIN_SHARE = 0.15  # heavy-hitter share that marks a join attr skewed
SPLIT_MAX_HEAVY = 4  # heavy singleton ranges kept (top shares)
SPLIT_MAX_RANGES = 9  # heavy singletons + light chunks
SPLIT_MIN_DOMAIN = 64  # below this, splitting cannot pay for itself
SPLIT_MIN_BENEFIT = 2.0  # required est peak-bytes reduction


@dataclass(frozen=True)
class SplitDecision:
    """A chosen per-split plan: key ranges of ``attr`` + per-range root."""

    attr: str
    ranges: tuple[tuple[int, int], ...]  # [lo, hi) code ranges, disjoint
    roots: tuple[str, ...]  # decomposition root per range
    heavy: tuple[tuple[int, float], ...]  # (code, est share) triggers
    est_unsplit_peak: int
    est_split_peak: int

    @property
    def num_splits(self) -> int:
        return len(self.ranges)

    def describe(self) -> str:
        hshare = max((s for _, s in self.heavy), default=0.0)
        return (
            f"{self.attr!r} into {self.num_splits} range(s) "
            f"({len(self.heavy)} heavy key(s), top share {hshare:.2f}); "
            f"est peak {self.est_split_peak} B vs unsplit "
            f"{self.est_unsplit_peak} B"
        )


def _node_bytes_for(
    prep: Prepared, deco, dom_override: dict[str, int]
) -> int:
    """Peak dense message bytes of ``deco`` under overridden domains —
    ``node_message_bytes`` generalized to candidate (root, range) pairs."""

    def dom(a: str) -> int:
        return dom_override.get(a, prep.dicts[a].size)

    def subtree_gattrs(rel: str) -> list[str]:
        out = []
        g = prep.schema.group_of.get(rel)
        if g:
            out.append(g)
        for c in deco.nodes[rel].children:
            out.extend(subtree_gattrs(c))
        return out

    peak = 0
    for rel in deco.order:
        node = deco.nodes[rel]
        up: tuple[str, ...] = ()
        if node.parent is not None:
            up = tuple(
                set(prep.schema.relevant[rel])
                & set(prep.schema.relevant[node.parent])
            )
        size = 8
        for a in list(up) + subtree_gattrs(rel):
            size *= dom(a)
        peak = max(peak, size)
    return peak


def _range_plan(
    prep: Prepared, attr: str, width: int
) -> tuple[str, int, "object"]:
    """Best (root, est peak, decomposition) for one range of ``attr``."""
    hg = Hypergraph(
        {r: frozenset(prep.schema.relevant[r]) for r in prep.encoded}
    )
    cands = sorted(set(prep.schema.group_of)) or [prep.decomposition.root]
    best: tuple[int, str, object] | None = None
    for cand in cands:
        try:
            deco = decompose(prep.schema, hg, root=cand)
        except ValueError:
            continue
        peak = _node_bytes_for(prep, deco, {attr: width})
        if best is None or peak < best[0]:
            best = (peak, cand, deco)
    if best is None:  # the prepared root always decomposes
        deco = prep.decomposition
        return deco.root, _node_bytes_for(prep, deco, {attr: width}), deco
    return best[1], best[0], best[2]


def _build_ranges(
    dom: int, heavy_codes: list[int], max_ranges: int
) -> list[tuple[int, int]]:
    """Heavy singletons + light chunks covering ``[0, dom)``."""
    light_slots = max(1, max_ranges - len(heavy_codes))
    width = max(1, -(-dom // light_slots))
    ranges: list[tuple[int, int]] = []
    cursor = 0
    for h in sorted(heavy_codes):
        while cursor < h:
            hi = min(cursor + width, h)
            ranges.append((cursor, hi))
            cursor = hi
        ranges.append((h, h + 1))
        cursor = h + 1
    while cursor < dom:
        hi = min(cursor + width, dom)
        ranges.append((cursor, hi))
        cursor = hi
    return ranges


def decide_split(
    prep: Prepared, stats: Statistics
) -> SplitDecision | None:
    """Split iff a skewed join attr's partition cuts the estimated peak
    by at least ``SPLIT_MIN_BENEFIT``; ``None`` keeps the unsplit plan."""
    group_attrs = {a for _, a in prep.group_attrs}
    unsplit_peak = peak_message_bytes(prep)
    best: tuple[int, SplitDecision] | None = None
    for attr in sorted(prep.schema.join_attrs - group_attrs):
        dom = prep.dicts[attr].size
        if dom < SPLIT_MIN_DOMAIN:
            continue
        heavy: dict[int, float] = {}
        for rel in prep.encoded:
            if attr not in prep.encoded[rel].attrs:
                continue
            for code, share in stats.heavy_keys(rel, attr, SPLIT_MIN_SHARE):
                heavy[code] = max(heavy.get(code, 0.0), share)
        if not heavy:
            continue
        top = sorted(heavy.items(), key=lambda kv: (-kv[1], kv[0]))
        top = top[:SPLIT_MAX_HEAVY]
        ranges = _build_ranges(dom, [c for c, _ in top], SPLIT_MAX_RANGES)
        roots: list[str] = []
        split_peak = 0
        for lo, hi in ranges:
            root, peak, _ = _range_plan(prep, attr, hi - lo)
            roots.append(root)
            split_peak = max(split_peak, peak)
        if split_peak * SPLIT_MIN_BENEFIT > unsplit_peak:
            continue
        decision = SplitDecision(
            attr=attr,
            ranges=tuple(ranges),
            roots=tuple(roots),
            heavy=tuple(top),
            est_unsplit_peak=unsplit_peak,
            est_split_peak=split_peak,
        )
        if best is None or split_peak < best[0]:
            best = (split_peak, decision)
    return best[1] if best is not None else None


# ----------------------------------------------------------------------
# execution
# ----------------------------------------------------------------------


def _split_prepared(
    prep: Prepared, attr: str, lo: int, hi: int, deco,
    encoded: dict[str, EncodedRelation],
) -> Prepared:
    dicts = dict(prep.dicts)
    dicts[attr] = Dictionary(attr, prep.dicts[attr].values[lo:hi])
    return Prepared(
        prep.query,
        prep.schema,
        dicts,
        encoded,
        deco,
        prep.folded,
        dict(prep.fold_hosts),
        dict(prep.measure_moves),
    )


def split_parts(prep: Prepared, decision: SplitDecision) -> list[Prepared]:
    """One ``Prepared`` per key range that holds edges, over
    ``csr_restrict``-sliced relations and the range's own root; a range
    with no edges contributes nothing and is left out."""
    attr = decision.attr
    parts: list[Prepared] = []
    for (lo, hi), root in zip(decision.ranges, decision.roots):
        enc = csr_restrict(prep, attr, lo, hi)
        if all(enc[r].num_rows == 0 for r in enc if attr in enc[r].attrs):
            continue
        if root == prep.decomposition.root:
            deco = prep.decomposition
        else:
            _, _, deco = _range_plan(prep, attr, hi - lo)
        parts.append(_split_prepared(prep, attr, lo, hi, deco, enc))
    return parts


def _merge_outputs(
    outs: list[EngineOutput], num_group_attrs: int, k: int
) -> EngineOutput:
    """Sum channel partials per group across ranges (a group may join
    tuples from several key ranges)."""
    nonempty = [o for o in outs if len(o.group_codes)]
    if not nonempty:
        return EngineOutput(
            np.zeros((0, num_group_attrs), dtype=np.int64),
            np.zeros((0, k), dtype=np.float64),
            {},
        )
    codes = np.concatenate([o.group_codes for o in nonempty], axis=0)
    vals = np.concatenate([o.channel_values for o in nonempty], axis=0)
    uniq, inv = np.unique(codes, axis=0, return_inverse=True)
    merged = np.zeros((len(uniq), vals.shape[1]), dtype=np.float64)
    np.add.at(merged, inv.ravel(), vals)
    return EngineOutput(uniq.astype(np.int64), merged, {})


def execute_split(
    parts: list[Prepared],
    engine,
    channels: tuple[Channel, ...],
    num_group_attrs: int,
    fused: bool | None = None,
) -> list[EngineOutput]:
    """Run the plan once per key range (``split_parts``) and merge the
    group partials."""
    outs: list[EngineOutput] = []
    for part in parts:
        outs.extend(engine.run(part, channels, (), None, fused=fused))
    return [_merge_outputs(outs, num_group_attrs, len(channels))]
