"""The **data graph** (paper Sections III-C/D/E), built and held on a device.

Nodes are the distinct values (or value tuples) of each relation's
``x_l``/``x_r`` attribute sets; an intra-relation edge per pre-aggregated
row carries its *multiplicity*; inter-relation edges (multiplicity 1)
connect a relation's *connector* nodes to each child relation's left
nodes whose shared attribute values agree.  Stored CSR-style: per-node
``offsets`` into flat ``edge_dst``/``edge_mult`` arrays, the paper's
Section VI layout.

Port of the JAX package's ``core/datagraph.py``, which registers nodes
one row at a time in Python.  Here every ``(relation, side)`` owns one
contiguous block of node ids whose ``(n, width)`` int64 code matrix is
the side's distinct code tuples in lexicographic order (``torch.unique``
over the rows), so a node's block gives its relation, side and type.
Inter-relation edges come from sorting the child's left nodes on the
shared-attribute projection and searching each parent connector's
projection there; a parent with no match is a dead end.  The node ids
differ from the reference's (it numbers nodes by first appearance); the
node set, the edge multiset, the sources and :meth:`DataGraph.memory_bytes`
are the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.prepare import Prepared
from repro_torch.core.torch_engine import _chunk_of, require_device, to_device_rows

SOURCE, INTERMEDIATE, BRANCHING, GROUP = 0, 1, 2, 3


@dataclass
class NodeBlock:
    """The nodes of one ``(relation, side)``: ids ``start .. start + size``."""

    rel: str
    side: str  # "l" | "r"
    attrs: tuple[str, ...]
    typ: int
    start: int
    codes: torch.Tensor  # (size, width) int64, distinct rows, ascending

    @property
    def size(self) -> int:
        return self.codes.shape[0]

    @property
    def stop(self) -> int:
        return self.start + self.size


@dataclass
class DataGraph:
    prepared: Prepared
    blocks: dict[tuple[str, str], NodeBlock]  # in node-id order
    offsets: torch.Tensor  # (num_nodes + 1,) int64
    edge_dst: torch.Tensor  # (E,) int64
    edge_mult: torch.Tensor  # (E,) int64
    node_type: torch.Tensor  # (num_nodes,) uint8
    # channel mode: (E, k) float32 weights, one row per edge
    edge_w: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    @property
    def num_nodes(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.edge_dst.shape[0]

    @property
    def sources(self) -> torch.Tensor:
        """Node ids of the root relation's left side, ascending."""
        b = self.blocks[(self.prepared.decomposition.root, "l")]
        return torch.arange(b.start, b.stop, device=self.device)

    def out(self, n: int) -> list[tuple[int, int]]:
        """Node ``n``'s out-edges as ``(dst, multiplicity)`` pairs, read
        from the device's CSR on the host."""
        lo, hi = self.offsets[n:n + 2].tolist()
        return list(zip(self.edge_dst[lo:hi].tolist(), self.edge_mult[lo:hi].tolist()))

    def out_w(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """Channel-mode adjacency on the host: (dst ids, (deg, k) weight
        matrix)."""
        lo, hi = self.offsets[n:n + 2].tolist()
        return self.edge_dst[lo:hi].cpu().numpy(), self.edge_w[lo:hi].cpu().numpy()

    def memory_bytes(self) -> int:
        """The reference's footprint formula (nodes + CSR edges), which
        the paper's Table I reports: ``8 * max(width, 1) + 24`` bytes a
        node, 8 bytes an edge target, an edge multiplicity and an
        offset."""
        node_bytes = sum(b.size * (8 * max(len(b.attrs), 1) + 24) for b in self.blocks.values())
        return node_bytes + 16 * self.num_edges + 8 * (self.num_nodes + 1)

    def device_bytes(self) -> int:
        """Bytes the graph's tensors actually hold on the device."""
        held = [self.offsets, self.edge_dst, self.edge_mult, self.node_type]
        held += [b.codes for b in self.blocks.values()]
        if self.edge_w is not None:
            held.append(self.edge_w)
        return sum(t.numel() * t.element_size() for t in held)

    def node_table(self) -> list[tuple[str, str, tuple[int, ...], int]]:
        """``(rel, side, code tuple, type)`` of every node, by id, on the
        host: the reference's node registry, for inspection."""
        out = []
        for b in self.blocks.values():
            out += [(b.rel, b.side, tuple(row), b.typ) for row in b.codes.cpu().tolist()]
        return out


def side_type(prep: Prepared, rel: str, side: str) -> int:
    """The node type of ``rel``'s ``side`` (paper Section III-C)."""
    n = prep.decomposition.nodes[rel]
    if n.is_source and side == "l":
        return SOURCE
    if n.is_group and not n.is_source and side == "r":
        return GROUP
    connector_side = "l" if (n.is_group and not n.is_source) else "r"
    if n.is_branching and side == connector_side:
        return BRANCHING
    return INTERMEDIATE


def _distinct_rows(cols: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The distinct rows of ``cols (n, w)`` ascending, and each row's
    index among them; a zero-width side has one (empty) value."""
    n, w = cols.shape
    if w == 0:
        return cols[: min(n, 1)], torch.zeros(n, dtype=torch.int64, device=cols.device)
    if w == 1:
        uniq, inv = torch.unique(cols[:, 0], sorted=True, return_inverse=True)
        return uniq[:, None], inv
    uniq, inv = torch.unique(cols, dim=0, sorted=True, return_inverse=True)
    return uniq, inv


def _match_ids(left: torch.Tensor, right: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Equal ids for equal rows across ``left (a, w)`` and ``right (b, w)``."""
    _, inv = _distinct_rows(torch.cat([left, right]))
    return inv[: left.shape[0]], inv[left.shape[0]:]


def _weights(rel, er, channels, weight_channels, device) -> torch.Tensor:
    """``rel``'s per-row (n, k) float32 edge weights: its
    ``weight_channels`` matrix, else its multiplicity in every channel."""
    chunk = _chunk_of(er)
    wc = weight_channels.get(rel)
    if wc is not None:
        return to_device_rows(
            (er.num_rows, channels), torch.float32, device, chunk, lambda lo, hi: wc[lo:hi]
        )
    cnt = to_device_rows(
        (er.num_rows,), torch.float32, device, chunk, lambda lo, hi: er.count[lo:hi]
    )
    return cnt[:, None].expand(-1, channels).contiguous()


def build_data_graph(
    prep: Prepared,
    weight_channels: dict[str, np.ndarray] | None = None,
    channels: int | None = None,
    device="cuda",
) -> DataGraph:
    """Stage 1: load relations into the data graph (Section III-E), on
    ``device`` (CUDA unless the caller asks for the CPU).

    ``channels=k`` builds the graph in *channel mode*: every edge carries a
    (k,) float32 weight vector — a relation's rows default to their
    multiplicity replicated, ``weight_channels[rel]`` (an (n, k) matrix)
    overrides a measure relation's rows with per-channel payloads, and
    inter-relation hops weigh 1 — so one traversal propagates k semiring
    channels at once.
    """
    device = require_device(device, "build_data_graph", 'device="cpu"')
    deco = prep.decomposition
    weight_channels = weight_channels or {}
    i64 = dict(dtype=torch.int64, device=device)

    blocks: dict[tuple[str, str], NodeBlock] = {}
    src, dst, mult, wts = [], [], [], []
    start = 0
    # --- nodes and intra-relation edges (multiplicity = pre-aggregated count)
    for rel in deco.order:
        node = deco.nodes[rel]
        er = prep.encoded[rel]
        chunk = _chunk_of(er)
        ids = {}
        for side, attrs in (("l", node.x_l), ("r", node.x_r)):
            pos = [er.attrs.index(a) for a in attrs]
            cols = to_device_rows(
                (er.num_rows, len(pos)), torch.int64, device, chunk,
                lambda lo, hi, pos=pos: np.asarray(er.codes[lo:hi])[:, pos],
            )
            uniq, inv = _distinct_rows(cols)
            blocks[(rel, side)] = NodeBlock(
                rel, side, tuple(attrs), side_type(prep, rel, side), start, uniq.contiguous()
            )
            ids[side] = inv + start
            start += uniq.shape[0]
        src.append(ids["l"])
        dst.append(ids["r"])
        mult.append(to_device_rows(
            (er.num_rows,), torch.int64, device, chunk, lambda lo, hi: er.count[lo:hi]
        ))
        if channels is not None:
            wts.append(_weights(rel, er, channels, weight_channels, device))

    # --- inter-relation edges: parent connector -> child left (mult 1) ---
    for rel in deco.order:
        pnode = deco.nodes[rel]
        pside = "l" if (pnode.is_group and not pnode.is_source) else "r"
        pblock = blocks[(rel, pside)]
        for child in pnode.children:
            cnode = deco.nodes[child]
            cblock = blocks[(child, "l")]
            shared = [a for a in cnode.x_l if a in pblock.attrs]
            pkey, ckey = _match_ids(
                pblock.codes[:, [pblock.attrs.index(a) for a in shared]],
                cblock.codes[:, [cnode.x_l.index(a) for a in shared]],
            )
            ckey, corder = torch.sort(ckey, stable=True)
            lo = torch.searchsorted(ckey, pkey, right=False)
            cnt = torch.searchsorted(ckey, pkey, right=True) - lo
            total = int(cnt.sum())
            rep = torch.repeat_interleave(
                torch.arange(pblock.size, **i64), cnt, output_size=total
            )
            within = torch.arange(total, **i64) - (torch.cumsum(cnt, 0) - cnt)[rep]
            src.append(pblock.start + rep)
            dst.append(cblock.start + corder[lo[rep] + within])
            mult.append(torch.ones(total, **i64))
            if channels is not None:
                wts.append(torch.ones((total, channels), dtype=torch.float32, device=device))

    # --- CSR: edges grouped by source node, each node's in build order ---
    src = torch.cat(src) if src else torch.zeros(0, **i64)
    src, order = torch.sort(src, stable=True)
    offsets = torch.searchsorted(src, torch.arange(start + 1, **i64))
    node_type = torch.empty(start, dtype=torch.uint8, device=device)
    for b in blocks.values():
        node_type[b.start:b.stop] = b.typ
    return DataGraph(
        prepared=prep,
        blocks=blocks,
        offsets=offsets,
        edge_dst=torch.cat(dst)[order] if dst else torch.zeros(0, **i64),
        edge_mult=torch.cat(mult)[order] if mult else torch.zeros(0, **i64),
        node_type=node_type,
        edge_w=torch.cat(wts)[order].contiguous() if wts else None,
    )

