"""Paper-faithful JOIN-AGG execution (Sections IV-A/B/C) on a device.

Stage 2 walks the data graph from every source node, multiplying edge
weights along each path; meeting a *branching* node pushes the running
value into that path-id's count ``C_p`` and restarts from 1 (the paper's
"caching effect": a path-id already met only accumulates ``C_p`` and is
not explored again).  Group sinks record c-pairs ``(path-id, code,
value)``.  Stage 3 combines the c-pairs by a *prefix join* on path-ids,
recursively over the branching hierarchy: each resolved subtree
multiplies its distinct path-id counts exactly once.

Port of the JAX package's ``core/ref_engine.py``, whose depth-first
search runs in Python one source at a time.  Here the traversal is
breadth-first over every source of a *source tile* at once:

* A state is a row ``(path-id, node, value)``: the path-id an int64 id
  into a table of ``(parent path-id, branching node, C_p)`` from which
  the reference's path-id tuple can be rebuilt, the value k float32
  channels.  Each level expands the rows over their CSR out-edges
  (``repeat_interleave`` on the degrees, then a gather), multiplies by
  the edge weights, and sums the rows of equal ``(path-id, node)`` keys:
  a stable sort of the keys, ``unique_consecutive``, then the
  ``segment_sum`` kernel.  The summed rows route by the node's type:
  group nodes become c-pairs, branching nodes new path-ids (one row of
  value 1 each, explored once), intermediate nodes the next frontier.
* Merging equal ``(path-id, node)`` rows is sound.  The graph is
  layered by the decomposition tree, so every path from a source into a
  node has the same length and every row of that key lies in one level;
  what a state contributes downstream is linear in its value, and
  products distribute over the sum.
* Stage 3 runs bottom-up over the branching hierarchy
  (``direct_groups``/``child_branchings``): a child branching's results
  are weighted by their path counts and summed per parent path-id, then
  each path-id's parts are joined by segmented cartesian products.  A
  path-id missing a part contributes nothing, the reference's ``None``.
* A query folded to its root alone sums, per source, the values of its
  maximal paths (rows at nodes without out-edges), as the reference's
  ``_count_terminal`` does.

Source tiles bound the rows of every expansion and cross product to
:data:`TILE_ROWS`.  A tile whose next step would exceed it is split by
the rows each of its sources needs at that step and run again; a lone
source runs whole however many rows it needs.  The bound is a constant,
so a query takes the same tiles on every card.

Values are float32, as everywhere in the port: exact for integer data
below 2**24 (the reference accumulates in float64).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.datagraph import (
    BRANCHING,
    GROUP,
    INTERMEDIATE,
    DataGraph,
    build_data_graph,
)
from repro_torch.core.prepare import Prepared, prepare
from repro_torch.core.query import JoinAggQuery
from repro_torch.core.torch_engine import require_device
from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.relational.relation import Database

# rows of one expansion or cross product a source tile may make
TILE_ROWS = 1 << 24
_KEY_LIMIT = 2**63


class _TileTooLarge(Exception):
    """A tile's next step needs more than the bound: ``rows[i]`` is what
    the tile's source ``i`` needs at that step."""

    def __init__(self, rows: np.ndarray):
        super().__init__(f"{int(rows.sum())} rows")
        self.rows = rows


def _sorted_groups(cols: list[torch.Tensor], dims: list[int]):
    """Group rows by their key tuple (columns ``cols``, the first most
    significant, ``dims`` their ranges): ``(perm, seg, first)`` where
    ``perm`` sorts the rows by key, stably, ``seg`` is the ascending
    group id of each sorted row and ``first`` the sorted position of
    each group's first row.  Past 2**63 key values the tuples go to
    ``torch.unique(dim=0)``."""
    dev = cols[0].device
    if math.prod(dims) < _KEY_LIMIT:
        key = torch.zeros_like(cols[0])
        for c, d in zip(cols, dims):
            key.mul_(d).add_(c)
        skey, perm = torch.sort(key, stable=True)
        _, seg, counts = torch.unique_consecutive(skey, return_inverse=True, return_counts=True)
    else:
        _, inv = torch.unique(torch.stack(cols, 1), dim=0, return_inverse=True)
        seg, perm = torch.sort(inv, stable=True)
        counts = torch.unique_consecutive(seg, return_counts=True)[1]
    first = torch.cumsum(counts, 0) - counts
    return perm, seg, first.to(dev)


def _keyed_sum(cols: list[torch.Tensor], dims: list[int], vals: torch.Tensor):
    """Σ ``vals`` over the rows of equal key tuple, on ``segment_sum``:
    each group's first row (an index into the input) and its sum, in
    ascending key order."""
    if vals.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=vals.device), vals
    perm, seg, first = _sorted_groups(cols, dims)
    sums = segment_sum(vals[perm].contiguous(), seg, first.shape[0])
    return perm[first], sums


@dataclass
class Traversal:
    """What Stage 2 made for one tile of sources; path-ids ``0..S-1``
    are the sources' own (the reference's empty tuple)."""

    sources: torch.Tensor  # (S,) node ids
    pid_parent: torch.Tensor  # (P,) parent path-id, -1 at a source
    pid_node: torch.Tensor  # (P,) the branching node (a source's node)
    pid_count: torch.Tensor  # (P, k) the path count C_p (1 at a source)
    pid_source: torch.Tensor  # (P,) tile index of the path-id's source
    cp_pid: torch.Tensor  # (C,) c-pairs: path-id
    cp_node: torch.Tensor  # (C,) group node
    cp_val: torch.Tensor  # (C, k)
    terminal: torch.Tensor | None  # (S, k) Σ over maximal paths
    peak_rows: int = 0


def _per_source(rows: torch.Tensor, source: torch.Tensor, num: int) -> np.ndarray:
    """Rows each source needs, counted on the host (tile planning only)."""
    return np.bincount(source.cpu().numpy(), weights=rows.cpu().numpy(), minlength=num)


def traverse(
    g: DataGraph, sources: torch.Tensor, terminal: bool = False,
    max_rows: int | None = None,
) -> Traversal:
    """Stage 2 for the tile ``sources``, level by level.  With
    ``terminal`` every node is walked through and rows at nodes without
    out-edges are summed per source (the folded single-group query).
    ``max_rows`` raises :class:`_TileTooLarge` before an expansion past
    it, unless the tile is one source."""
    dev, k = g.device, g.edge_w.shape[1]
    S, N = sources.shape[0], g.num_nodes
    i64 = dict(dtype=torch.int64, device=dev)
    pid_parent = [torch.full((S,), -1, **i64)]
    pid_node = [sources]
    pid_count = [torch.ones((S, k), dtype=torch.float32, device=dev)]
    pid_source = torch.arange(S, **i64)
    num_pids = S
    f_pid, f_node = torch.arange(S, **i64), sources
    f_val = torch.ones((S, k), dtype=torch.float32, device=dev)
    cp_pid, cp_node, cp_val = [], [], []
    term = torch.zeros((S, k), dtype=torch.float32, device=dev) if terminal else None
    peak = 0
    while f_pid.shape[0]:
        lo = g.offsets[f_node]
        deg = g.offsets[f_node + 1] - lo
        if terminal:
            dead = torch.nonzero(deg == 0).squeeze(1)
            if dead.shape[0]:
                ids, order = torch.sort(pid_source[f_pid[dead]], stable=True)
                term += segment_sum(f_val[dead[order]].contiguous(), ids, S)
        total = int(deg.sum())
        if max_rows is not None and total > max_rows and S > 1:
            raise _TileTooLarge(_per_source(deg, pid_source[f_pid], S))
        peak = max(peak, total)
        rep = torch.repeat_interleave(torch.arange(f_pid.shape[0], **i64), deg, output_size=total)
        edge = lo[rep] + torch.arange(total, **i64) - (torch.cumsum(deg, 0) - deg)[rep]
        dst = g.edge_dst[edge]
        pid = f_pid[rep]
        val = f_val[rep] * g.edge_w[edge]
        first, val = _keyed_sum([pid, dst], [num_pids, N], val)
        pid, dst = pid[first], dst[first]
        typ = g.node_type[dst]
        if terminal:
            typ = torch.full_like(typ, INTERMEDIATE)
        grp, br, mid = typ == GROUP, typ == BRANCHING, typ == INTERMEDIATE
        cp_pid.append(pid[grp])
        cp_node.append(dst[grp])
        cp_val.append(val[grp])
        m = int(br.sum())
        new = torch.arange(num_pids, num_pids + m, **i64)
        pid_parent.append(pid[br])
        pid_node.append(dst[br])
        pid_count.append(val[br])
        pid_source = torch.cat([pid_source, pid_source[pid[br]]])
        num_pids += m
        f_pid = torch.cat([pid[mid], new])
        f_node = torch.cat([dst[mid], dst[br]])
        f_val = torch.cat([val[mid], torch.ones((m, k), dtype=torch.float32, device=dev)])
    cat = torch.cat
    return Traversal(
        sources, cat(pid_parent), cat(pid_node), cat(pid_count), pid_source,
        cat(cp_pid) if cp_pid else torch.zeros(0, **i64),
        cat(cp_node) if cp_node else torch.zeros(0, **i64),
        cat(cp_val) if cp_val else torch.zeros((0, k), dtype=torch.float32, device=dev),
        term, peak,
    )


@dataclass
class _Part:
    """Rows ``(path-id, group codes, value)`` ascending by path-id."""

    pid: torch.Tensor
    codes: dict[str, torch.Tensor]  # group relation -> (R,) codes
    val: torch.Tensor  # (R, k)


def _cross(parts: list[_Part], num_pids: int, tr: Traversal, max_rows) -> _Part:
    """Per path-id cartesian product of ``parts`` (each ascending by
    path-id), values multiplied; path-ids missing from a part drop out."""
    if len(parts) == 1:
        return parts[0]
    i64 = dict(dtype=torch.int64, device=tr.pid_parent.device)
    S = tr.sources.shape[0]
    counts, starts = [], []
    for p in parts:
        upid, cnt = torch.unique_consecutive(p.pid, return_counts=True)
        c = torch.zeros(num_pids, **i64)
        c[upid] = cnt
        s = torch.zeros(num_pids, **i64)
        s[upid] = torch.cumsum(cnt, 0) - cnt
        counts.append(c)
        starts.append(s)
    prod = counts[0].clone()
    for c in counts[1:]:
        prod *= c
    total = int(prod.sum())
    if max_rows is not None and total > max_rows and S > 1:
        raise _TileTooLarge(_per_source(prod, tr.pid_source, S))
    tr.peak_rows = max(tr.peak_rows, total)
    pids = torch.nonzero(prod).squeeze(1)
    n_out = prod[pids]
    which = torch.repeat_interleave(torch.arange(pids.shape[0], **i64), n_out, output_size=total)
    row_pid = pids[which]
    t = torch.arange(total, **i64) - (torch.cumsum(n_out, 0) - n_out)[which]
    rows = [None] * len(parts)
    for i in reversed(range(len(parts))):
        c = counts[i][row_pid]
        rows[i] = starts[i][row_pid] + t % c
        t = t // c
    codes, val = {}, None
    for p, r in zip(parts, rows):
        codes.update({rel: col[r] for rel, col in p.codes.items()})
        val = p.val[r] if val is None else val * p.val[r]
    return _Part(row_pid, codes, val)


def combine(g: DataGraph, tr: Traversal, max_rows: int | None = None) -> _Part | None:
    """Stage 3: the prefix join over the branching hierarchy, bottom-up.
    Returns the source-level rows (path-id = tile index of the source),
    or None when the source level has no parts."""
    prep = g.prepared
    deco = prep.decomposition
    P, k = tr.pid_parent.shape[0], tr.cp_val.shape[1]
    dev = tr.pid_parent.device
    empty = _Part(torch.zeros(0, dtype=torch.int64, device=dev), {},
                  torch.zeros((0, k), dtype=torch.float32, device=dev))
    dom = {r: prep.dicts[a].size for r, a in prep.group_attrs}
    done: dict[str | None, _Part | None] = {}
    levels = [r for r in reversed(deco.order) if deco.nodes[r].is_branching] + [None]
    for b in levels:
        parts = []
        for grel in deco.direct_groups(b):
            blk = g.blocks[(grel, "r")]
            # a group block lies in one level of the walk, whose c-pairs
            # are in key order: its rows are ascending by path-id
            sel = (tr.cp_node >= blk.start) & (tr.cp_node < blk.stop)
            nodes = tr.cp_node[sel]
            parts.append(_Part(tr.cp_pid[sel], {grel: blk.codes[nodes - blk.start, 0]},
                               tr.cp_val[sel]))
        for b2 in deco.child_branchings(b):
            sub = done[b2] or empty
            rels = list(sub.codes)
            parent = tr.pid_parent[sub.pid]
            first, val = _keyed_sum(
                [parent] + [sub.codes[r] for r in rels], [P] + [dom[r] for r in rels],
                sub.val * tr.pid_count[sub.pid],
            )
            parts.append(_Part(parent[first], {r: sub.codes[r][first] for r in rels}, val))
        done[b] = _cross(parts, P, tr, max_rows) if parts else None
    return done[None]


@dataclass
class RefRun:
    """One run of the engine: group codes (canonical order, ascending)
    and their channel values, on the device, plus what it took."""

    codes: torch.Tensor  # (R, G) int64
    values: torch.Tensor  # (R, k) float32
    graph_s: float = 0.0
    stage2_s: float = 0.0
    stage3_s: float = 0.0
    peak_rows: int = 0
    tiles: int = 0
    splits: int = 0


def _split(rows: np.ndarray, max_rows: int) -> list[tuple[int, int]]:
    """Consecutive source ranges of at most ``max_rows`` rows each (a
    source that needs more runs alone)."""
    out, lo, acc = [], 0, 0
    for i, r in enumerate(rows.tolist()):
        if i > lo and acc + r > max_rows:
            out.append((lo, i))
            lo, acc = i, 0
        acc += r
    out.append((lo, len(rows)))
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ref_run(
    prep: Prepared,
    channel_measures: tuple[str | None, ...],
    device="cuda",
    tile: int | None = None,
) -> RefRun:
    """Stages 1-3 for k COUNT/SUM channels (``channel_measures[c]``
    names the relation whose ``sum`` payload rides channel ``c``, None =
    COUNT).  Rows whose every channel is 0 are dropped.  ``tile`` (for
    tests) runs fixed tiles of that many sources with no row bound."""
    device = require_device(device, "engine 'ref'", '.engine(RefChannelEngine(device="cpu"))')
    k = len(channel_measures)
    weight_channels: dict[str, np.ndarray] = {}
    for rel in {r for r in channel_measures if r is not None}:
        er = prep.encoded[rel]
        cols = [
            er.payloads["sum"] if channel_measures[c] == rel else er.count
            for c in range(k)
        ]
        weight_channels[rel] = np.stack(cols, axis=1).astype(np.float32)
    run = RefRun(None, None)
    t0 = time.perf_counter()
    g = build_data_graph(prep, weight_channels=weight_channels, channels=k, device=device)
    _sync(device)
    run.graph_s = time.perf_counter() - t0
    deco = prep.decomposition
    canonical = [r for r, _ in prep.group_attrs]
    terminal = all(r == deco.root for r in canonical)
    root = g.blocks[(deco.root, "l")]
    sources = g.sources
    S = sources.shape[0]
    if tile is None:
        pending, bound = [(0, S)], TILE_ROWS
    else:
        pending, bound = [(lo, min(lo + tile, S)) for lo in range(0, S, tile)], None
    codes, values = [], []
    while pending:
        lo, hi = pending.pop(0)
        try:
            t0 = time.perf_counter()
            tr = traverse(g, sources[lo:hi], terminal, bound)
            _sync(device)
            t1 = time.perf_counter()
            if terminal:
                out = _Part(torch.arange(hi - lo, device=device), {}, tr.terminal)
            else:
                out = combine(g, tr, bound)
            _sync(device)
        except _TileTooLarge as e:
            run.splits += 1
            pending[:0] = [(lo + a, lo + b) for a, b in _split(e.rows, TILE_ROWS)]
            continue
        run.stage2_s += t1 - t0
        run.stage3_s += time.perf_counter() - t1
        run.tiles += 1
        run.peak_rows = max(run.peak_rows, tr.peak_rows)
        if out is None:
            continue
        src_code = root.codes[tr.sources[out.pid] - root.start, 0]
        keep = (out.val != 0).any(1)
        codes.append(torch.stack(
            [src_code[keep] if r == deco.root else out.codes[r][keep] for r in canonical], 1
        ))
        values.append(out.val[keep])
    if not codes:
        run.codes = torch.zeros((0, len(canonical)), dtype=torch.int64, device=device)
        run.values = torch.zeros((0, k), dtype=torch.float32, device=device)
        return run
    codes, values = torch.cat(codes), torch.cat(values)
    if codes.shape[0]:
        dims = [prep.dicts[a].size for _, a in prep.group_attrs]
        perm, _, _ = _sorted_groups(list(codes.T), dims)
        codes, values = codes[perm], values[perm]
    run.codes, run.values = codes.contiguous(), values.contiguous()
    return run


def execute_ref_channels(
    prep: Prepared,
    channel_measures: tuple[str | None, ...],
    device="cuda",
) -> dict[tuple[int, ...], np.ndarray]:
    """Run k COUNT/SUM channels in one paper-faithful traversal.

    Returns group *code* tuples (canonical group order) mapped to (k,)
    float64 value vectors, as the reference's does; decoding is the
    caller's job."""
    run = ref_run(prep, channel_measures, device)
    codes = run.codes.cpu().numpy()
    vals = run.values.cpu().numpy().astype(np.float64)
    return {tuple(int(c) for c in row): v for row, v in zip(codes, vals)}


def execute_ref(
    query: JoinAggQuery,
    db: Database,
    prep: Prepared | None = None,
    device="cuda",
) -> dict[tuple, float]:
    """Run the paper-faithful JOIN-AGG on ``device``; returns {group
    values: count}.  COUNT only, as the reference."""
    if query.agg.kind != "count":
        raise NotImplementedError("ref engine implements COUNT (paper's experiments)")
    device = require_device(device, "execute_ref", 'device="cpu"')
    if prep is None:
        prep = prepare(query, db)
    run = ref_run(prep, (None,), device)
    codes = run.codes.cpu().numpy()
    vals = run.values[:, 0].cpu().numpy()
    cols = [
        prep.dicts[attr].decode(codes[:, i]) for i, (_, attr) in enumerate(prep.group_attrs)
    ]
    return {tuple(c[j] for c in cols): float(v) for j, v in enumerate(vals)}

