"""Public JOIN-AGG operator API (paper Section II-B), over the planner.

Port of the JAX package's ``core/operator.py``: the message-memory
budget before group-axis streaming, the error for options an engine
cannot honor, the per-node message-byte estimates that rank candidate
roots, the legacy root choice (:func:`estimate_plan`,
:func:`choose_root`), and the :func:`join_agg` and :func:`maintain`
shims over the logical planner.  The reference's ``run_tensor`` drives
its numpy ``"tensor"`` engine, which the port does not have.
"""
from __future__ import annotations

from repro_torch.core.prepare import Prepared
from repro_torch.core.query import JoinAggQuery
from repro_torch.relational.relation import Database

DEFAULT_MEMORY_BUDGET = 512 << 20  # bytes of message memory before streaming


class UnsupportedPlanOption(ValueError):
    """A plan option the chosen engine (or this port) cannot honor —
    raised instead of silently ignoring the option."""


def node_message_bytes(prep: Prepared) -> dict[str, int]:
    """Estimated message bytes per decomposition-tree node — the currency
    of byte-heuristic root choice and of auto-streaming."""
    deco = prep.decomposition

    def subtree_gattrs(rel: str) -> list[str]:
        out = []
        g = prep.schema.group_of.get(rel)
        if g:
            out.append(g)
        for c in deco.nodes[rel].children:
            out.extend(subtree_gattrs(c))
        return out

    sizes: dict[str, int] = {}
    for rel in deco.order:
        node = deco.nodes[rel]
        if node.parent is None:
            up: tuple[str, ...] = ()
        else:
            up = tuple(
                set(prep.schema.relevant[rel])
                & set(prep.schema.relevant[node.parent])
            )
        size = 8
        for a in list(up) + subtree_gattrs(rel):
            size *= prep.dicts[a].size
        sizes[rel] = size
    return sizes


def peak_message_bytes(prep: Prepared) -> int:
    """Estimated peak message bytes of the leaves-to-root contraction."""
    return max(node_message_bytes(prep).values())


def estimate_plan(
    query: JoinAggQuery, db: Database, root: str | None = None
) -> tuple[Prepared, int]:
    """Prepare + estimate peak bytes of the leaves-to-root contraction.

    Cyclic queries route through the GHD compiler; their estimate is the
    max of the derived plan's message peak and the bag-materialization
    working-set peak, so acyclic and GHD plans are cost-compared in the
    same currency."""
    from repro_torch.core.prepare import prepare
    from repro_torch.ghd.rewrite import compile_ghd, is_cyclic_query

    if is_cyclic_query(query, db):
        plan = compile_ghd(query, db, root=root)
        return plan.prepared, max(
            plan.bag_peak_bytes, peak_message_bytes(plan.prepared)
        )
    prep = prepare(query, db, root=root)
    return prep, peak_message_bytes(prep)


def choose_root(query: JoinAggQuery, db: Database) -> tuple[Prepared, int]:
    """Cost-based root choice over the statistics-refined cost model
    (DESIGN.md §10): candidates are ranked by
    :func:`repro_torch.planner.cost.plan_cost` — dense message bytes plus
    an estimated-cardinality work term from the collected sketches — and
    the returned peak stays in ``peak_message_bytes`` currency (it feeds
    the streaming fallback's tile arithmetic).

    Mirrors the paper's freedom to 'start from any group relation'
    (Section III-A) made cost-based."""
    from repro_torch.ghd.rewrite import is_cyclic_query
    from repro_torch.planner.cost import plan_cost

    if is_cyclic_query(query, db):
        # the GHD compiler optimizes the bag-tree root internally
        return estimate_plan(query, db)
    best: tuple[Prepared, tuple[float, float]] | None = None
    group_rels = {r for r, _ in query.group_by}
    failures: list[str] = []
    stats = None
    for root in query.relations:
        if root not in group_rels:
            continue
        try:
            prep, _ = estimate_plan(query, db, root=root)
        except ValueError as e:
            failures.append(f"{root}: {e}")
            continue
        if stats is None:
            # the fold rewrite is root-independent, so one candidate's
            # statistics describe every candidate's encodings
            stats = prep.stats
        else:
            prep.attach_stats(stats)
        cost = plan_cost(prep, stats)
        if best is None or cost < best[1]:
            best = (prep, cost)
    if best is None:
        detail = "; ".join(failures) if failures else "no group relation in query"
        raise ValueError(f"no valid group-relation root ({detail})")
    return best[0], peak_message_bytes(best[0])


def join_agg(
    query: JoinAggQuery,
    db: Database,
    engine="torch",
    memory_budget: int | None = None,
    stream: tuple[str, int] | None = None,
) -> dict[tuple, float]:
    """Execute a group-by aggregate over a multi-way join.

    ``engine`` is ``"torch"`` (on CUDA; raises when no card is present)
    or an engine instance such as ``TorchChannelEngine(device="cpu")``;
    any other name raises as ``resolve_engine`` does.  Cyclic joins are
    compiled through a generalized hypertree decomposition
    (``repro_torch.ghd``) into an equivalent acyclic query over
    materialized bag relations, then run on the same engine.

    Thin shim over the logical planner (:mod:`repro_torch.api`): builds a
    single-aggregate plan and returns its result as the legacy
    ``{group values: aggregate}`` dict.
    """
    from repro_torch.api import Q

    q = Q.from_query(query).engine(engine)
    if memory_budget is not None:
        q = q.memory_budget(memory_budget)
    if stream is not None:
        q = q.stream(*stream)
    return q.plan(db).execute().to_dict()


def maintain(query: JoinAggQuery, db: Database, engine="torch"):
    """Prepare ``query`` once and return a handle that keeps the result
    maintained under batched inserts/deletes (``repro_torch.incremental``,
    DESIGN.md §4): subtree messages are cached on the engine's device per
    decomposition-tree node and a delta re-propagates only along its
    dirty root-path.  Cyclic queries compose with the GHD compiler —
    only the bags a delta touches re-materialize.

    Thin shim over the logical planner (:mod:`repro_torch.api`):
    equivalent to ``Q.from_query(query).engine(engine).maintain(db)``;
    ``engine`` is ``"torch"`` (on CUDA) or an engine instance such as
    ``TorchChannelEngine(device="cpu")``.
    """
    from repro_torch.api import Q

    return Q.from_query(query).engine(engine).maintain(db)
