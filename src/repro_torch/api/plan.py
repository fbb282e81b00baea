"""The logical plan: one planner, one :class:`Plan` (DESIGN.md §6).

``Q.over(...)...plan(db)`` compiles a declarative query spec into a
single :class:`Plan` through three stages:

1. **Logical rewrites** — self-join aliasing, per-relation selection
   pushdown (``where`` predicates filter *before* encoding), and the
   automatic column copy of group attributes that participate in joins
   (the paper's Section II-A convention; acyclic queries only, the GHD
   compiler copies inside its bags).
2. **Physical choice** — cyclic queries route through the GHD compiler
   (``repro_torch.ghd``), acyclic ones through a cost-based root search
   over the fold/decompose pipeline: the statistics-refined cost model
   (``repro_torch.planner.cost``) by default, the byte heuristic under
   ``Q.stats(False)``.  With statistics on, a skewed join attribute may
   split the plan into key ranges (``repro_torch.planner.split``).
3. **Channelization** — the named-aggregate bundle becomes one COUNT
   channel, one SUM channel per distinct measure (AVG = SUM/COUNT pair,
   derived at assembly), and MIN/MAX requests; all distributive channels
   run in a *single* contraction pass.

``Plan.execute()`` returns a columnar :class:`AggResult`;
``Plan.explain()`` renders the decisions, the dense-vs-sparse path choice
among them; ``Plan.verify()`` checks the plan's structural invariants
(``repro_torch.analysis.verify``); ``Plan.maintain()`` hands the same
query to the incremental maintainer (``repro_torch.incremental``).

Port of the JAX package's ``api/plan.py``, fused hops included
(``Q.fused``); meshes raise :class:`UnsupportedPlanOption`.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.aggregates.semiring import AggSpec, Count
from repro_torch.api.engines import (
    COUNT_CHANNEL,
    Channel,
    EngineOutput,
    MinMaxRequest,
    TorchChannelEngine,
    resolve_engine,
)
from repro_torch.core.operator import (
    DEFAULT_MEMORY_BUDGET,
    UnsupportedPlanOption,
    node_message_bytes,
    peak_message_bytes,
)
from repro_torch.core.prepare import Prepared, encode_query, finish_prepare
from repro_torch.core.query import JoinAggQuery, resolve_schema
from repro_torch.core.torch_engine import (
    choose_path,
    hop_launch_shapes,
    stream_tiles,
)
from repro_torch.ghd.rewrite import compile_ghd, is_cyclic_query
from repro_torch.kernels.ops import fused_enabled
from repro_torch.planner.cost import (
    actual_node_cards,
    node_card_estimates,
    plan_cost,
)
from repro_torch.relational.relation import Database, Relation, estimate_prepare_peak

COPY_SUFFIX = "__grp"


@dataclass(frozen=True)
class Predicate:
    """A pushed-down per-relation selection: ``fn(columns) -> bool mask``."""

    relation: str
    label: str
    fn: Callable[[dict[str, np.ndarray]], np.ndarray]


@dataclass
class AggResult:
    """Columnar result: one column per group attribute (display names in
    query order) plus one column per named aggregate, rows in ascending
    order of the group codes."""

    group_names: tuple[str, ...]
    agg_names: tuple[str, ...]
    agg_kinds: dict[str, str]
    relation: Relation

    @property
    def num_rows(self) -> int:
        return self.relation.num_rows

    def column(self, name: str) -> np.ndarray:
        return self.relation.columns[name]

    def group_tuples(self) -> list[tuple]:
        cols = [self.relation.columns[g] for g in self.group_names]
        return [tuple(c[i] for c in cols) for i in range(self.num_rows)]

    def to_dict(self, agg: str | None = None) -> dict[tuple, float]:
        """``{group values: value}`` dict for one aggregate (the only one
        when ``agg`` is None): COUNT/SUM/AVG drop exact-zero values;
        MIN/MAX keep every joined group, zeros included."""
        if agg is None:
            if len(self.agg_names) != 1:
                raise ValueError(f"result has aggregates {self.agg_names}; name one")
            agg = self.agg_names[0]
        vals = self.relation.columns[agg]
        keep_zero = self.agg_kinds[agg] in ("min", "max")
        out: dict[tuple, float] = {}
        for key, v in zip(self.group_tuples(), vals):
            v = float(v)
            if v == 0.0 and not keep_zero:
                continue
            out[key] = v
        return out

    def __repr__(self) -> str:
        return (
            f"AggResult({self.num_rows} groups × "
            f"{list(self.group_names)} | {list(self.agg_names)})"
        )


@dataclass
class Plan:
    """A compiled logical plan, ready to execute, explain, verify or
    maintain."""

    db: Database  # effective database (aliases + predicates + copies)
    query: JoinAggQuery  # rewritten query (primary aggregate)
    aggs: tuple[tuple[str, AggSpec], ...]
    group_display: tuple[str, ...]
    engine: TorchChannelEngine
    prep: Prepared | None  # None only for maintenance-only compiles
    channels: tuple[Channel, ...]
    minmax: tuple[MinMaxRequest, ...]
    assemble: dict[str, tuple]  # agg name -> assembly recipe
    rewrite_notes: tuple[str, ...]
    memory_budget: int | None
    stream: tuple[str, int] | None
    # fused hop kernels (DESIGN.md §13): True/False pins the choice,
    # None defers to the REPRO_FUSED environment switch at run time
    fused: bool | None = None
    cyclic: bool = False
    ghd_plan: "object | None" = None  # repro_torch.ghd.rewrite.GHDPlan
    # per-split execution decision (repro_torch.planner.split.
    # SplitDecision) when the statistics found qualifying skew; None =
    # unsplit plan
    split: "object | None" = None
    # False when the spec disabled statistics-driven planning (byte
    # heuristic only)
    stats_enabled: bool = True
    # why each rejected candidate root failed, for explain()
    root_notes: tuple[str, ...] = ()
    # the Q builder that produced this plan (maintain() replays its
    # aliases, renames and predicates on every delta batch)
    spec: "object | None" = None
    # the split plan's per-range Prepared set, built on the first
    # execute and kept, so warm executes reuse each range's device views
    _split_parts: "list[Prepared] | None" = field(
        default=None, init=False, repr=False
    )

    def _require_physical(self) -> None:
        if self.prep is None:
            raise RuntimeError(
                "this Plan was compiled for maintenance only (physical stage "
                "skipped); use Q.plan(db) for execute()/explain()"
            )

    @property
    def message_peak(self) -> int:
        self._require_physical()
        return peak_message_bytes(self.prep)

    @property
    def est_peak(self) -> int:
        """Estimated peak bytes: the bag materialization's working set
        where it is larger (cyclic), the largest range's peak message
        (split), else the peak message."""
        if self.ghd_plan is not None:
            return max(self.ghd_plan.bag_peak_bytes, self.message_peak)
        if self.split is not None:
            return self.split.est_split_peak
        return self.message_peak

    @property
    def stats(self):
        """Collected statistics (lazy; see ``Prepared.stats``)."""
        self._require_physical()
        return self.prep.stats

    def resolved_stream(self) -> tuple[str, int] | None:
        """The tile plan actually used: the explicit ``stream`` option, or
        auto-streaming over the largest group attribute when the
        estimated peak message exceeds the memory budget; None for a
        split plan, whose key ranges already bound the messages."""
        if self.stream is not None:
            return self.stream
        if self.split is not None:
            return None
        budget = (
            self.memory_budget
            if self.memory_budget is not None
            else DEFAULT_MEMORY_BUDGET
        )
        peak = self.message_peak
        if peak <= budget:
            return None
        prep = self.prep
        attr = max((a for _, a in prep.group_attrs), key=lambda a: prep.dicts[a].size)
        dom = prep.dicts[attr].size
        shrink = int(math.ceil(peak / budget))
        return (attr, max(1, dom // shrink))

    def split_parts(self) -> "list[Prepared]":
        """The split plan's per-range ``Prepared`` set, built on first use
        and kept, so warm executes reuse each range's device views."""
        if self._split_parts is None:
            from repro_torch.planner.split import split_parts

            self._split_parts = split_parts(self.prep, self.split)
        return self._split_parts

    def outputs(self) -> list[EngineOutput]:
        """The engine's sparse outputs for every channel and MIN/MAX
        request: one per stream tile, or for a split plan the per-range
        partials merged into one."""
        self._require_physical()
        if self.split is not None:
            from repro_torch.planner.split import execute_split

            return execute_split(
                self.split_parts(), self.engine, self.channels,
                len(self.prep.group_attrs), self.fused,
            )
        kwargs = {}
        if getattr(self.engine, "supports_fused", False):
            kwargs["fused"] = self.fused
        return self.engine.run(
            self.prep, self.channels, self.minmax, self.resolved_stream(),
            memory_budget=self.memory_budget, **kwargs,
        )

    def execute(self) -> AggResult:
        """Run every named aggregate in a single contraction pass (one
        per key range of a split plan)."""
        return _assemble(self, self.outputs())

    def maintain(self):
        """Incremental-maintenance handle(s) for this plan's query, their
        caches on the plan engine's device.

        Single-aggregate plans return a raw
        :class:`~repro_torch.incremental.maintained.MaintainedJoinAgg` when
        no logical rewrite is in play; otherwise a
        :class:`~repro_torch.api.maintain.MaintainedPlan` wrapper applies
        the plan's alias/predicate/copy rewrites to every delta batch and
        fans deltas out to one maintained handle per named aggregate.
        """
        from repro_torch.api.maintain import MaintainedPlan, raw_handle

        if self.stream is not None or self.memory_budget is not None:
            raise UnsupportedPlanOption(
                "maintain() does not support stream/memory_budget options"
            )
        if len(self.aggs) == 1 and not self._needs_delta_rewrite():
            return raw_handle(self)
        return MaintainedPlan(self)

    def _needs_delta_rewrite(self) -> bool:
        spec = self.spec
        return bool(
            spec.predicates
            or any(n != s for n, s in spec.relations)
            or any(m for _, m in spec.renames)
            or self._group_copies()
        )

    def _group_copies(self) -> dict[str, tuple[str, str]]:
        """relation -> (source attr, copy attr) for planner-made copies."""
        out = {}
        for (rel, attr), (_, attr0) in zip(
            self.query.group_by, self.spec.group_attrs
        ):
            if attr != attr0:
                out[rel] = (attr0, attr)
        return out

    # ------------------------------------------------------------------
    def verify(self, strict: bool = True) -> list:
        """Check every declared structural invariant of this compiled
        plan (DESIGN.md §11): decomposition-tree running intersection,
        encoded codes, semiring-channel wiring (AVG's SUM/COUNT pairing
        included), exact disjoint split key-range partitions, the fused
        hops' launch shapes and accumulator-overflow headroom at
        sketch-estimated cardinalities.

        Returns the (empty, when sound) list of
        :class:`~repro_torch.analysis.verify.Diagnostic` findings;
        ``strict=True`` (default) raises
        :class:`~repro_torch.analysis.verify.PlanInvariantError` on any.
        Runs inside :func:`compile_plan` when ``REPRO_VERIFY=1``."""
        self._require_physical()
        from repro_torch.analysis.verify import PlanInvariantError, verify_plan

        diags = verify_plan(self)
        if strict and diags:
            raise PlanInvariantError(diags)
        return diags

    # ------------------------------------------------------------------
    def explain(self, actuals: bool = False) -> str:
        """Human-readable plan: strategy, root, stats, rewrites, the
        dense-vs-sparse path, the fused hops' launch shapes, per-node
        peaks with estimated cardinalities.  ``actuals=True`` also runs
        one COUNT pass on the plan's device and renders the measured
        per-node message cardinalities next to the estimates
        (golden/bench scales only — it allocates the dense messages)."""
        self._require_physical()
        prep = self.prep
        lines = [
            f"Plan: JOIN-AGG over {len(self.query.relations)} relations "
            f"-> {len(self.group_display)} group attrs "
            f"(engine={self.engine.name})"
        ]
        if self.cyclic:
            g = self.ghd_plan
            lines.append(
                f"strategy: GHD (cyclic) — {len(g.ghd.order)} bags, "
                f"est bag peak {_fmt_bytes(g.bag_peak_bytes)}; derived "
                f"acyclic tree root={prep.decomposition.root}, "
                f"est peak message {_fmt_bytes(self.message_peak)}"
            )
        else:
            lines.append(
                f"strategy: acyclic contraction, "
                f"root={prep.decomposition.root}, "
                f"est peak message {_fmt_bytes(self.message_peak)}"
            )
        stream = self.resolved_stream()
        if stream is not None:
            lines.append(
                f"stream: tile group attr {stream[0]!r} × {stream[1]} "
                f"(memory budget "
                f"{_fmt_bytes(self.memory_budget or DEFAULT_MEMORY_BUDGET)})"
            )
        sources = [self.db[r] for r in self.query.relations]
        lines.append(
            "storage: whole-column, est prepare peak "
            f"{_fmt_bytes(estimate_prepare_peak(sources))}"
        )
        for rname, src in zip(self.query.relations, sources):
            lines.append(f"  {rname}: {src.storage_kind} ({src.num_rows} rows)")
        if not self.stats_enabled:
            lines.append("stats: disabled (byte-heuristic planning)")
        else:
            st = prep.stats
            lines.append(
                f"stats: generation {st.generation}, "
                f"{len(st.relations)} relation(s) sketched, "
                f"{len(st.fanouts)} sampled fanout(s)"
            )
            lines.extend(f"  {t}" for t in st.summary_lines())
            if self.split is not None:
                lines.append(f"split: {self.split.describe()}")
                for (lo, hi), root in zip(self.split.ranges, self.split.roots):
                    lines.append(f"  [{lo},{hi}) root={root}")
            elif not self.cyclic:
                lines.append("split: none (no qualifying skew)")
        lines.extend(self._explain_path(stream))
        lines.extend(self._explain_kernels())
        lines.append(
            f"aggregates ({len(self.channels)} semiring channel(s), "
            f"{len(self.minmax)} min/max request(s), one pass):"
        )
        for name, agg in self.aggs:
            lines.append(f"  {name} = {agg.describe()}")
        if self.rewrite_notes:
            lines.append("rewrites:")
            lines.extend(f"  {note}" for note in self.rewrite_notes)
        if self.root_notes:
            lines.append("rejected roots:")
            lines.extend(f"  {note}" for note in self.root_notes)
        cards = acts = None
        if self.stats_enabled:
            cards = node_card_estimates(prep, prep.stats)
            if actuals:
                acts = actual_node_cards(prep, self.engine.device)
        lines.append("tree:")
        lines.extend("  " + t for t in _render_tree(prep, cards, acts))
        if prep.folded:
            folds = ", ".join(f"{f}->{prep.fold_hosts[f]}" for f in prep.folded)
            lines.append(f"  folded: {folds}")
        return "\n".join(lines)

    def _explain_path(self, stream) -> list[str]:
        """Dense-vs-sparse choice + per-node byte estimates."""
        choice = choose_path(
            self.prep,
            k=max(len(self.channels), 1),
            memory_budget=self.memory_budget,
            stream=stream,
            measured=tuple(
                ch.measure[0] for ch in self.channels if ch.kind == "sum" and ch.measure
            ),
            stats=self.prep.stats if self.stats_enabled else None,
        )
        lines = [
            f"torch path: {choice.path} — {choice.reason}; "
            f"est dense peak {_fmt_bytes(choice.dense_peak)} "
            f"vs sparse peak {_fmt_bytes(choice.sparse_peak)}"
        ]
        mode = getattr(self.engine, "mode", "auto")
        if mode != "auto" and mode != choice.path:
            lines.append(f"  pinned: {mode} (engine mode={mode!r})")
        elif choice.path == "dense" and self.fused is True:
            lines.append(
                "  pinned: sparse (.fused(True) — fused hop megakernels "
                "have no dense-einsum form)"
            )
        for rel in choice.dense_node_bytes:
            lines.append(
                f"  {rel}: dense {_fmt_bytes(choice.dense_node_bytes[rel])} "
                f"/ sparse {_fmt_bytes(choice.sparse_node_bytes[rel])}"
            )
        return lines

    def fused_runs(self) -> list[dict]:
        """Every pass that ``execute()`` runs on the fused path, in order:
        per key range of a split plan (its own ``Prepared``), per stream
        tile (the tile's relations and domains), the ``k``-channel pass,
        then the MIN/MAX passes (``k`` = 1, one per request, alike).
        Entries hold ``run`` (a label, "" for the one run of a plain
        plan), ``pass`` ("channels" | "min/max"), ``repeat`` (passes of
        that entry), ``k``, ``prep``, ``encoded`` and ``domains`` (None
        = the ``Prepared``'s own); :func:`~repro_torch.core.torch_engine.
        hop_launch_shapes` of each gives its launches' shapes."""
        self._require_physical()
        if self.split is not None:
            parts = self.split_parts()
            attr = self.split.attr
            runs = [(f"key range {i} of {len(parts)} ({p.dicts[attr].size} keys of "
                     f"{attr})", p) for i, p in enumerate(parts)]
        else:
            runs = [("", self.prep)]
        stream = self.resolved_stream()
        out: list[dict] = []
        for label, prep in runs:
            tiles = [(label, None, None)]
            if stream is not None:
                found = list(stream_tiles(prep, *stream))
                tiles = [
                    (f"stream tile {i} of {len(found)} ({stream[0]} from "
                     f"{offsets[stream[0]]})", enc, domains)
                    for i, (enc, domains, offsets) in enumerate(found)
                ]
            for tile, enc, domains in tiles:
                passes = [("channels", 1, max(len(self.channels), 1))]
                if self.minmax and self.split is None:
                    passes.append(("min/max", len(self.minmax), 1))
                out.extend(
                    {"run": tile, "pass": kind, "repeat": repeat, "k": k,
                     "prep": prep, "encoded": enc, "domains": domains}
                    for kind, repeat, k in passes
                )
        return out

    def _explain_kernels(self) -> list[str]:
        """Per-hop launch shapes of every fused pass (when fused hops are
        on; :meth:`fused_runs`), from
        :func:`~repro_torch.core.torch_engine.hop_launch_shapes` —
        computed from the plan's sizes alone, so the same on every
        machine.  A plan of one run and one pass lists its hops; others
        head each pass with its run and kind."""
        if not fused_enabled(self.fused):
            return []
        lines = [
            "kernels: fused hop (gather+product+scatter in one launch; "
            "launch shapes of ops.walk_plan / ops.gather_plan)"
        ]
        runs = self.fused_runs()
        for r in runs:
            indent = "  "
            if len(runs) > 1:
                head = ", ".join(x for x in (r["run"], f"{r['pass']} pass") if x)
                times = f" x{r['repeat']}" if r["repeat"] > 1 else ""
                lines.append(f"  {head} (k={r['k']}){times}:")
                indent = "    "
            for e in hop_launch_shapes(r["prep"], r["k"], r["encoded"], r["domains"]):
                shape = repr(e["plan"]) if e["plan"] is not None else e["error"]
                lines.append(
                    f"{indent}{e['rel']}: {e['walk']} walk {shape}  edges={e['edges']}  "
                    f"segs={e['num_segments']}  width={e['width']}  acc={e['acc_dtype']}"
                )
        return lines

    def __repr__(self) -> str:
        kind = "ghd" if self.cyclic else "acyclic"
        root = None if self.prep is None else self.prep.decomposition.root
        return (
            f"Plan({kind}, engine={self.engine.name}, "
            f"root={root}, "
            f"aggs={[n for n, _ in self.aggs]})"
        )


# ----------------------------------------------------------------------
# compilation
# ----------------------------------------------------------------------


def compile_plan(spec, db: Database, physical: bool = True) -> Plan:
    """Compile a builder spec against ``db`` into a :class:`Plan`.

    ``physical=False`` runs every logical stage (rewrites, validation,
    option checks) but skips root search / GHD compilation and
    channelization — the maintenance path (``Q.maintain``), where the
    incremental maintainer builds its own growable prepared state and a
    full ``Prepared`` would be thrown away.
    """
    if not spec.relations:
        raise ValueError("query has no relations; start with Q.over(...)")
    if not spec.group_attrs:
        raise ValueError("query needs .group_by(...)")
    aggs = spec.aggs or (("count", Count()),)

    engine = resolve_engine(spec.engine_name)
    engine.device  # raises here, before encoding, when the card is absent
    if spec.fused_opt is not None and not getattr(engine, "supports_fused", False):
        raise UnsupportedPlanOption(
            f"engine {engine.name!r} has no fused hop kernels; drop "
            ".fused(...) or use the 'torch' engine"
        )

    notes: list[str] = []
    edb = _apply_aliases(spec, db, notes)
    edb = _apply_predicates(spec, edb, notes)

    rel_names = tuple(n for n, _ in spec.relations)
    group_by = list(spec.group_attrs)
    for rel, attr in group_by:
        if rel not in rel_names:
            raise ValueError(f"group-by relation {rel!r} not in query")
        if attr not in edb[rel].attrs:
            raise ValueError(f"group attr {rel}.{attr} does not exist")

    measures = _collect_measures(aggs, rel_names, edb)
    names = [n for n, _ in aggs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate aggregate names: {names}")

    primary = aggs[0][1]
    query0 = JoinAggQuery(rel_names, tuple(group_by), primary)
    cyclic = is_cyclic_query(query0, edb)
    if not cyclic:
        edb, group_by = _copy_joining_group_attrs(rel_names, edb, group_by, notes)
        query0 = JoinAggQuery(rel_names, tuple(group_by), primary)

    group_display = _display_names(spec.group_attrs)
    clash = set(group_display) & set(names)
    if clash:
        raise ValueError(f"aggregate names collide with group columns: {sorted(clash)}")

    stats_on = bool(spec.stats_opt)
    if not physical:
        return Plan(
            db=edb, query=query0, aggs=aggs, group_display=group_display,
            engine=engine, prep=None, channels=(), minmax=(), assemble={},
            rewrite_notes=tuple(notes), memory_budget=spec.budget,
            stream=spec.stream_opt, fused=spec.fused_opt, cyclic=cyclic,
            stats_enabled=stats_on, spec=spec,
        )
    ghd_plan = None
    root_notes: tuple[str, ...] = ()
    if cyclic:
        ghd_plan = compile_ghd(query0, edb, measures=measures)
        prep = ghd_plan.prepared
        bag_of = dict(ghd_plan.measure_bags)

        def resolve_rel(rel: str) -> str:
            rel = bag_of.get(rel, rel)
            return prep.measure_moves.get(rel, rel)

    else:
        prep, root_notes = _best_root(query0, edb, measures, use_stats=stats_on)

        def resolve_rel(rel: str) -> str:
            return prep.measure_moves.get(rel, rel)

    channels, minmax, assemble = _channelize(aggs, resolve_rel)
    split = None
    if (
        stats_on
        and not cyclic
        and not minmax
        and spec.stream_opt is None
        and engine.name == "torch"
    ):
        from repro_torch.planner.split import decide_split

        split = decide_split(prep, prep.stats)
        budget = spec.budget if spec.budget is not None else DEFAULT_MEMORY_BUDGET
        if split is not None and split.est_split_peak > budget:
            split = None  # the split cannot fit either; stream instead
    plan = Plan(
        db=edb,
        query=query0,
        aggs=aggs,
        group_display=group_display,
        engine=engine,
        prep=prep,
        channels=channels,
        minmax=minmax,
        assemble=assemble,
        rewrite_notes=tuple(notes),
        memory_budget=spec.budget,
        stream=spec.stream_opt,
        fused=spec.fused_opt,
        cyclic=cyclic,
        ghd_plan=ghd_plan,
        split=split,
        stats_enabled=stats_on,
        root_notes=root_notes,
        spec=spec,
    )
    if os.environ.get("REPRO_VERIFY", "") not in ("", "0"):
        plan.verify()  # debug-mode assert (DESIGN.md §11)
    return plan


def _apply_aliases(spec, db: Database, notes: list[str]) -> Database:
    renames = dict(spec.renames)
    edb = Database()
    for name, source in spec.relations:
        if source not in db:
            raise KeyError(f"relation {source!r} not in database")
        mapping = dict(renames.get(name, ()))
        if name == source and not mapping:
            edb.add(db[source])
            continue
        edb.add(db[source].renamed(name, mapping))
        if name != source:
            note = f"alias {name} := {source}"
            if mapping:
                note += " (" + ", ".join(
                    f"{a}->{b}" for a, b in mapping.items()
                ) + ")"
            notes.append(note)
    return edb


def _apply_predicates(spec, edb: Database, notes: list[str]) -> Database:
    for pred in spec.predicates:
        if pred.relation not in edb:
            raise KeyError(f"where: relation {pred.relation!r} not in query")
        rel = edb[pred.relation]
        filtered = rel.filter(np.asarray(pred.fn(rel.columns)))
        edb.add(filtered)
        notes.append(
            f"where {pred.relation}: {pred.label} "
            f"({rel.num_rows} -> {filtered.num_rows} rows)"
        )
    return edb


def _collect_measures(
    aggs, rel_names: tuple[str, ...], edb: Database
) -> dict[str, str]:
    measures: dict[str, str] = {}
    for name, agg in aggs:
        m = agg.measure
        if m is None:
            continue
        rel, attr = m
        if rel not in rel_names:
            raise ValueError(
                f"aggregate {name!r} measures {rel}.{attr}, but {rel!r} "
                "is not a query relation"
            )
        if attr not in edb[rel].attrs:
            raise ValueError(
                f"aggregate {name!r}: measure column {rel}.{attr} "
                "does not exist"
            )
        if measures.setdefault(rel, attr) != attr:
            raise UnsupportedPlanOption(
                f"aggregates measure two different columns of {rel!r} "
                f"({measures[rel]!r} and {attr!r}); payloads share one "
                "key space per relation — alias a second copy of the "
                "relation instead"
            )
    return measures


def _copy_joining_group_attrs(rel_names, edb: Database, group_by, notes: list[str]):
    """The paper's Section II-A column-copy convention, automated: a group
    attribute that participates in a join is copied under a fresh name
    inside its relation and the query groups by the copy."""
    attr_count: dict[str, int] = {}
    for r in rel_names:
        for a in edb[r].attrs:
            attr_count[a] = attr_count.get(a, 0) + 1
    used = set(attr_count)
    out_group_by = []
    for rel, attr in group_by:
        if attr_count.get(attr, 0) < 2:
            out_group_by.append((rel, attr))
            continue
        copy = attr + COPY_SUFFIX
        while copy in used:
            copy += "_"
        used.add(copy)
        edb.add(edb[rel].with_column(copy, edb[rel].columns[attr]))
        out_group_by.append((rel, copy))
        joined_in = sorted(r for r in rel_names if attr in edb[r].attrs)
        notes.append(
            f"copy group attr {rel}.{attr} -> {copy} "
            f"(joins {', '.join(joined_in)})"
        )
    return edb, out_group_by


def _best_root(
    query: JoinAggQuery,
    db: Database,
    measures: dict[str, str],
    use_stats: bool = True,
) -> tuple[Prepared, tuple[str, ...]]:
    """Cost-based root search: encode once, fold/decompose per candidate
    group-relation root, rank by the statistics-refined cost model
    (:func:`repro_torch.planner.cost.plan_cost`) — or the raw dense-bytes
    heuristic when ``use_stats`` is off; the first candidate wins ties.
    Every rejected root's reason is kept for ``explain()`` and for the
    error raised when no candidate is valid."""
    schema = resolve_schema(query, db)
    dicts, encoded = encode_query(query, db, schema, measures=measures)
    best: tuple[Prepared, tuple] | None = None
    failures: list[str] = []
    stats = None
    for root in dict.fromkeys(r for r, _ in query.group_by):
        try:
            p = finish_prepare(
                query, schema, dicts, encoded, root=root, measures=measures
            )
        except ValueError as e:
            failures.append(f"{root}: {e}")
            continue
        if use_stats:
            if stats is None:
                # fold/encode are root-independent: the first candidate's
                # statistics describe every candidate's encodings
                stats = p.stats
            else:
                p.attach_stats(stats)
            cost: tuple = plan_cost(p, stats)
        else:
            cost = (peak_message_bytes(p),)
        if best is None or cost < best[1]:
            best = (p, cost)
    if best is None:
        detail = "; ".join(failures) if failures else "no candidates"
        raise ValueError(f"no valid group-relation root ({detail})")
    return best[0], tuple(failures)


def _channelize(aggs, resolve_rel):
    """Named aggregates -> (channels, minmax requests, assembly recipes)."""
    channels: list[Channel] = [COUNT_CHANNEL]
    minmax: list[MinMaxRequest] = []
    assemble: dict[str, tuple] = {}
    for name, agg in aggs:
        if agg.kind == "count":
            assemble[name] = ("count",)
            continue
        rel, attr = agg.measure
        target = (resolve_rel(rel), attr)
        if agg.kind in ("sum", "avg"):
            ch = Channel("sum", target)
            if ch not in channels:
                channels.append(ch)
            assemble[name] = (agg.kind, ch)
        elif agg.kind in ("min", "max"):
            req = MinMaxRequest(agg.kind, target)
            if req not in minmax:
                minmax.append(req)
            assemble[name] = ("minmax", req)
        else:
            raise ValueError(f"unknown aggregate kind {agg.kind!r}")
    return tuple(channels), tuple(minmax), assemble


def _display_names(group_attrs) -> tuple[str, ...]:
    attrs = [a for _, a in group_attrs]
    return tuple(a if attrs.count(a) == 1 else f"{r}.{a}" for r, a in group_attrs)


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.0f} {unit}" if unit == "B" else f"{n:.1f} {unit}"
        n /= 1024
    raise AssertionError


def _render_tree(
    prep: Prepared,
    cards: dict[str, float] | None = None,
    actuals: dict[str, int] | None = None,
) -> list[str]:
    sizes = node_message_bytes(prep)
    deco = prep.decomposition

    def annotate(rel: str) -> str:
        text = f"{rel}  msg {_fmt_bytes(sizes[rel])}"
        if cards is not None:
            text += f"  est {cards[rel]:.0f} rows"
            if actuals is not None:
                text += f" / actual {actuals[rel]} rows"
        return text

    lines = [annotate(deco.root).replace("  msg", " (root)  msg", 1)]

    def walk(rel: str, prefix: str) -> None:
        kids = deco.nodes[rel].children
        for i, c in enumerate(kids):
            last = i == len(kids) - 1
            lines.append(prefix + ("└─ " if last else "├─ ") + annotate(c))
            walk(c, prefix + ("   " if last else "│  "))

    walk(deco.root, "")
    return lines


def _assemble(plan: Plan, outputs: list[EngineOutput]) -> AggResult:
    """Concatenate the tiles' outputs column by column, decode the group
    columns and derive each named aggregate, all vectorised.

    Each tile's rows arrive in ascending order of their group codes, so
    the concatenation is sorted unless some tile starts below where the
    one before it ended (a stream attribute that is not the first group
    attribute); only then are the rows sorted."""
    prep = plan.prep

    def column(values) -> np.ndarray:
        return np.concatenate(list(values))

    codes = [
        column(o.group_codes[:, i] for o in outputs)
        for i in range(len(prep.group_attrs))
    ]
    chan = [
        column(o.channel_values[:, c] for o in outputs)
        for c in range(len(plan.channels))
    ]
    mm = {req: column(o.minmax_values[req] for o in outputs) for req in plan.minmax}
    edges = [o.group_codes for o in outputs if len(o.group_codes)]
    if any(tuple(b[0]) < tuple(a[-1]) for a, b in zip(edges, edges[1:])):
        order = np.lexsort(codes[::-1])
        codes = [c[order] for c in codes]
        chan = [c[order] for c in chan]
        mm = {req: v[order] for req, v in mm.items()}

    cols: dict[str, np.ndarray] = {}
    for i, (disp, (_, attr)) in enumerate(zip(plan.group_display, prep.group_attrs)):
        cols[disp] = prep.dicts[attr].decode(codes[i])

    # every row has COUNT > 0: sparsify keeps no other group
    cnt = chan[plan.channels.index(COUNT_CHANNEL)]
    kinds: dict[str, str] = {}
    for name, agg in plan.aggs:
        recipe = plan.assemble[name]
        kinds[name] = agg.kind
        if recipe[0] == "count":
            cols[name] = cnt
        elif recipe[0] == "sum":
            cols[name] = chan[plan.channels.index(recipe[1])]
        elif recipe[0] == "avg":
            cols[name] = chan[plan.channels.index(recipe[1])] / cnt
        else:  # minmax
            cols[name] = mm[recipe[1]]

    return AggResult(
        group_names=plan.group_display,
        agg_names=tuple(n for n, _ in plan.aggs),
        agg_kinds=kinds,
        relation=Relation("result", cols),
    )
