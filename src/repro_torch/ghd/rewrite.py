"""Cyclic → acyclic query rewrite over a GHD (the compiler's back end).

``compile_ghd`` turns a cyclic :class:`JoinAggQuery` into

* a derived acyclic ``JoinAggQuery`` whose relations are the GHD's bags,
  and
* a ready :class:`Prepared` whose encoded relations carry the bag
  multiplicities — fed through the *unchanged* fold/decompose/engine
  pipeline via :func:`repro_torch.core.prepare.finish_prepare`.

Group attributes that land inside bags follow the paper's column-copy
convention (Section II-A): a group attribute shared between bags (a
derived join attribute) is copied under a fresh name inside its group
relation's bag, and the derived query groups by the copy.  This also
lifts the acyclic pipeline's "group attrs must not join" restriction for
cyclic inputs — e.g. counting 4-cycles *per vertex* works out of the box.

Copy of the JAX package's ``ghd/rewrite.py`` without the decoded bag
database; bag materialization stays on the host, as there, and the plan
records how long each stage of the compile took.  The ``GHDPlan`` keeps
the pre-fold derived inputs the incremental maintainer re-finishes after
re-materializing the bags a delta made dirty
(:meth:`GHDPlan.invalidated_bags`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core.hypergraph import Hypergraph
from repro_torch.core.operator import UnsupportedPlanOption, peak_message_bytes
from repro_torch.core.prepare import (
    Prepared,
    encode_query,
    finish_prepare,
    query_measures,
)
from repro_torch.core.query import JoinAggQuery, QuerySchema, resolve_schema
from repro_torch.ghd.bags import MAX_DENSE_ELEMS, BagTable, materialize_bag
from repro_torch.ghd.hypertree import GHD, build_ghd
from repro_torch.relational.encoding import Dictionary, EncodedRelation
from repro_torch.relational.relation import Database
from repro_torch.stats.sketches import DistinctSketch

COPY_SUFFIX = "__grp"  # column-copy naming for group attrs shared across bags


def is_cyclic_query(query: JoinAggQuery, db: Database) -> bool:
    """GYO test on the query's own hypergraph (group-join attrs allowed)."""
    schema = resolve_schema(query, db, allow_group_join_attrs=True)
    hg = Hypergraph({r: frozenset(a) for r, a in schema.relevant.items()})
    return not hg.is_acyclic()


@dataclass
class GHDPlan:
    """Everything the GHD compiler produced for one cyclic query."""

    query: JoinAggQuery  # the original (cyclic) query
    ghd: GHD
    bag_tables: dict[str, BagTable]
    derived_query: JoinAggQuery  # acyclic, over bag relations
    prepared: Prepared  # ready for the engine
    copied_attrs: dict[str, str]  # original group attr -> copy column
    bag_peak_bytes: int  # high-water working set of bag materialization
    # original measure relation -> covering bag (the logical planner
    # re-points each aggregate channel through this, then through the
    # derived Prepared.measure_moves)
    measure_bags: dict[str, str]
    # host seconds of each compile stage: "encode", "build_ghd", "bags"
    # (materialization) and "finish_prepare" (fold, decompose, root)
    seconds: dict[str, float]
    # input relation -> its relevant attrs (the hypergraph the GHD
    # covers), kept for the verifier's cover check
    edges: dict[str, frozenset[str]]
    # pre-fold derived pipeline inputs, kept so the incremental
    # maintainer can re-finish_prepare after re-materializing dirty bags
    derived_schema: QuerySchema
    derived_dicts: dict[str, Dictionary]
    bag_out_attrs: dict[str, tuple[str, ...]]

    def invalidated_bags(self, rel: str) -> list[str]:
        """Bags whose materialization a delta on input relation ``rel``
        can change (assigned relations and filler sources alike) — the
        dirty set; every other bag table is reusable verbatim."""
        return [
            b for b in self.ghd.order
            if rel in self.bag_tables[b].sources
        ]


def _effective_domains(
    domains: dict[str, int], encoded: dict[str, EncodedRelation]
) -> dict[str, int]:
    """Statistics-refined attr domains for bag-size estimation: cap each
    dictionary size by the attr's sketched distinct count in every
    relation carrying it (exact below the sketch capacity — a join can
    only keep codes present on both sides), so the elimination-order
    search scores bags with the domains the data actually populates."""
    eff = dict(domains)
    for er in encoded.values():
        for i, a in enumerate(er.attrs):
            if a not in eff or er.num_rows == 0:
                continue
            est = DistinctSketch().update(er.codes[:, i]).estimate()
            eff[a] = min(eff[a], max(1, int(est)))
    return eff


def _append_copy_column(bt: BagTable, src: str, copy: str) -> BagTable:
    i = bt.attrs.index(src)
    codes = np.concatenate([bt.codes, bt.codes[:, i : i + 1]], axis=1)
    return BagTable(
        bt.name, bt.attrs + (copy,), codes, bt.count, bt.payloads,
        bt.peak_bytes,
    )


def compile_ghd(
    query: JoinAggQuery,
    db: Database,
    root: str | None = None,
    cap_rows: int = MAX_DENSE_ELEMS,
    measures: dict[str, str] | None = None,
    schema: QuerySchema | None = None,
    dicts: dict[str, Dictionary] | None = None,
    encoded: dict[str, EncodedRelation] | None = None,
) -> GHDPlan:
    """Compile a (cyclic) query down to the acyclic JOIN-AGG pipeline.

    ``measures`` widens the measure set to a whole multi-aggregate bundle
    (DESIGN.md §6); each measure relation's payloads ride into its
    covering bag.  ``cap_rows`` bounds the tuples any bag join may
    materialize (``MemoryError`` beyond it).  ``schema``/``dicts``/
    ``encoded`` let a caller that already holds the encoded input state
    (the incremental maintainer, which keeps it live under deltas) skip
    re-encoding the database.
    """
    if not query.group_by:
        raise ValueError("query needs at least one group-by attribute")
    seconds: dict[str, float] = {}
    t0 = time.perf_counter()
    measures = query_measures(query, measures)
    if schema is None:
        schema = resolve_schema(query, db, allow_group_join_attrs=True)
    if dicts is None or encoded is None:
        dicts, encoded = encode_query(query, db, schema, measures=measures)
    seconds["encode"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    edges = {r: frozenset(schema.relevant[r]) for r in query.relations}
    domains = {a: dicts[a].size for attrs in edges.values() for a in attrs}
    rows = {r: encoded[r].num_rows for r in query.relations}
    ghd = build_ghd(
        edges, _effective_domains(domains, encoded), rows,
        group_of=schema.group_of,
    )
    seconds["build_ghd"] = time.perf_counter() - t0

    measure_bag: dict[str, str] = {}
    for m_rel in measures:
        b = ghd.cover_of[m_rel]
        if b in measure_bag.values():
            raise UnsupportedPlanOption(
                "two measure relations land in the same GHD bag; their "
                "sum/min/max payloads cannot share one bag key space — "
                "split the query or measure a single relation"
            )
        measure_bag[m_rel] = b

    bag_attr_count: dict[str, int] = {}
    for b in ghd.order:
        for a in ghd.bags[b].attrs:
            bag_attr_count[a] = bag_attr_count.get(a, 0) + 1
    derived_join_attrs = frozenset(a for a, c in bag_attr_count.items() if c >= 2)

    # --- group-by mapping (column copy where a group attr joins bags) ---
    derived_group_by: list[tuple[str, str]] = []
    copied: dict[str, str] = {}
    copy_src: dict[str, str] = {}  # copy column -> source attr
    group_attr_of_bag: dict[str, str] = {}
    for rel, g in query.group_by:
        b = ghd.cover_of[rel]
        if b in group_attr_of_bag:
            raise AssertionError(f"bag {b!r} hosts two group attrs")
        if bag_attr_count[g] >= 2:
            copy = g + COPY_SUFFIX
            while copy in copy_src:  # same attr grouped from several relations
                copy += "_"
            copied[g] = copy
            copy_src[copy] = g
            derived_group_by.append((b, copy))
            group_attr_of_bag[b] = copy
        else:
            derived_group_by.append((b, g))
            group_attr_of_bag[b] = g

    # --- materialize each bag, projected to its derived-relevant attrs ---
    t0 = time.perf_counter()
    bag_tables: dict[str, BagTable] = {}
    relevant_d: dict[str, tuple[str, ...]] = {}
    bag_out_attrs: dict[str, tuple[str, ...]] = {}
    for b in ghd.order:
        bag = ghd.bags[b]
        gattr = group_attr_of_bag.get(b)
        out_attrs = tuple(
            a for a in bag.attrs
            if a in derived_join_attrs or a == gattr or copy_src.get(gattr) == a
        )
        if not out_attrs:
            raise ValueError(
                f"bag {b!r} shares no attrs with the rest of the query "
                "(cross product: unsupported)"
            )
        bag_out_attrs[b] = out_attrs
        bt = materialize_bag(bag, encoded, out_attrs, cap_rows=cap_rows)
        if gattr in copy_src:
            bt = _append_copy_column(bt, copy_src[gattr], gattr)
        bag_tables[b] = bt
        relevant_d[b] = bt.attrs
    seconds["bags"] = time.perf_counter() - t0

    # --- derived query / schema / dictionaries ---
    t0 = time.perf_counter()
    agg = query.agg
    if agg.measure is not None:
        agg = type(agg)(ghd.cover_of[agg.measure[0]], agg.measure[1])
    derived_query = JoinAggQuery(tuple(ghd.order), tuple(derived_group_by), agg)
    derived_measures = {measure_bag[r]: a for r, a in measures.items()}

    dicts_d: dict[str, Dictionary] = {}
    for b, bt in bag_tables.items():
        for a in bt.attrs:
            if a in dicts_d:
                continue
            src = copy_src.get(a, a)
            dicts_d[a] = dicts[src] if a == src else Dictionary(a, dicts[src].values)
    schema_d = QuerySchema(
        query=derived_query,
        join_attrs=derived_join_attrs,
        group_attrs=tuple(derived_group_by),
        relevant=relevant_d,
        group_of=dict(derived_group_by),
    )
    encoded_d: dict[str, EncodedRelation] = {
        b: bt.to_encoded() for b, bt in bag_tables.items()
    }

    # --- route through the unchanged acyclic pipeline (cost-based root) ---
    if root is not None:
        prep = finish_prepare(
            derived_query, schema_d, dicts_d, encoded_d, root=root,
            measures=derived_measures,
        )
    else:
        best: tuple[Prepared, int] | None = None
        failures: list[str] = []
        # sorted: peak ties must not depend on set (string-hash) order,
        # or the chosen root varies across processes
        for cand in sorted({b for b, _ in derived_group_by}):
            try:
                p = finish_prepare(
                    derived_query, schema_d, dicts_d, encoded_d, root=cand,
                    measures=derived_measures,
                )
            except ValueError as e:
                failures.append(f"{cand}: {e}")
                continue
            peak = peak_message_bytes(p)
            if best is None or peak < best[1]:
                best = (p, peak)
        if best is None:
            detail = (
                "; ".join(failures) if failures else "no group-relation bags"
            )
            raise ValueError(
                f"no valid group-relation root for the bag tree ({detail})"
            )
        prep = best[0]
    seconds["finish_prepare"] = time.perf_counter() - t0

    bag_peak = max((bt.peak_bytes for bt in bag_tables.values()), default=0)
    return GHDPlan(
        query=query,
        ghd=ghd,
        bag_tables=bag_tables,
        derived_query=derived_query,
        prepared=prep,
        copied_attrs=copied,
        bag_peak_bytes=bag_peak,
        measure_bags=measure_bag,
        seconds=seconds,
        edges=edges,
        derived_schema=schema_d,
        derived_dicts=dicts_d,
        bag_out_attrs=bag_out_attrs,
    )


def ghd_join_agg(
    query: JoinAggQuery,
    db: Database,
    engine="torch",
    memory_budget: int | None = None,
    stream: tuple[str, int] | None = None,
    plan: GHDPlan | None = None,
    mesh=None,
) -> dict[tuple, float]:
    """Execute a cyclic join-aggregate query through the GHD compiler.

    ``engine`` is ``"torch"`` (on CUDA; raises when no card is present)
    or an engine instance such as ``TorchChannelEngine(device="cpu")``.
    Pass a precompiled ``plan`` (from :func:`compile_ghd`) to amortize
    bag materialization across runs.  The derived plan runs on the
    engine's device as a cyclic ``Plan`` runs (auto-streaming past
    ``memory_budget``, or the explicit ``stream`` tile).  ``mesh`` (a
    shard count or a ``DeviceMesh``) shards the derived bag tree over a
    process group instead, partitioned on the root bag's group attribute
    (DESIGN.md §8)."""
    from repro_torch.api.engines import resolve_engine
    from repro_torch.api.plan import Plan, _channelize, _display_names

    eng = resolve_engine(engine)
    device = eng.device  # raises here, before the compile, without a card
    if plan is None:
        plan = compile_ghd(query, db)
    prep = plan.prepared
    if mesh is not None:
        if stream is not None:
            raise UnsupportedPlanOption(
                "explicit stream tiling cannot run on a device mesh "
                "(the shard partition replaces group-axis tiles)"
            )
        from repro_torch.core import distributed

        return distributed.run_query(prep, mesh, device=device)
    display = _display_names(prep.group_attrs)
    name = "value"
    while name in display:  # the aggregate's column sits beside the groups'
        name += "_"
    # the fold has already re-pointed the derived query's measure
    aggs = ((name, prep.query.agg),)
    channels, minmax, assemble = _channelize(aggs, lambda rel: rel)
    return Plan(
        db=db, query=query, aggs=aggs, group_display=display, engine=eng, prep=prep,
        channels=channels, minmax=minmax, assemble=assemble, rewrite_notes=(),
        memory_budget=memory_budget, stream=stream, cyclic=True, ghd_plan=plan,
    ).execute().to_dict()
