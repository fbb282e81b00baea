"""Mesh-sharded **sparse** JOIN-AGG execution over ``torch.distributed``
(DESIGN.md §8).

Port of the JAX package's ``core/distributed.py``.  The paper's outer
loop ("for every source node, walk the decomposition tree") is
embarrassingly parallel, and the width bounds survive partitioned
evaluation, so the distributed path shards the **root group attribute**:
its code range is cut into contiguous grouped-CSR row ranges
(:meth:`~repro_torch.core.prepare.CSRView.shard`), one per rank of the
mesh's ``data`` axis.  Each rank holds only

* its slice of every relation containing the shard attribute (one
  binary-search CSR block per relation, never a COO scan), moved to its
  device once, and
* the full (small) messages of subtrees that do not touch the shard
  attribute, computed on every rank: the paper's per-source iteration
  spread over the ranks.

The JAX package drives every device from one controller through
``shard_map``.  Here the program is SPMD, PyTorch's idiom: every rank of
the axis group makes the same call, walks its own shard with the
single-device sparse walk (:meth:`SparseProgram.run_channels` and
:meth:`~SparseProgram.run_minmax`, so every hop runs on ``segment_sum``,
``coo_spmm``, ``segment_reduce`` or, fused, ``fused_hop``, routed as on
one device), and one ``all_gather`` over the axis group hands every rank
every shard's partial.  The partials are disjoint along the shard axis
(running intersection), so nothing is summed.  A mesh of one shard with
no process group runs locally, with no collective.

Two pieces of the reference are not ported, on purpose: the ``(S,
n_pad)`` stacks and ``EDGE_BUCKET`` padding (``shard_map`` needs static
shapes; each rank here holds its own shard's real rows), and the
ahead-of-time pieces of the multi-pod dry run (``jit``, ``lower``,
``input_shardings``, ``lower_distributed``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.prepare import Prepared, csr_restrict, grouped_csr
from repro_torch.core.tensor_engine import _decode_result
from repro_torch.core.torch_engine import DeviceView, SparseProgram
from repro_torch.kernels.ops import fused_enabled


@dataclass(frozen=True)
class Axis:
    """A resolved mesh axis: its shard count, this rank's shard, and the
    process group the shards gather over (None: one local shard, no
    collective)."""

    shards: int
    rank: int
    group: object | None


LOCAL = Axis(1, 0, None)


def _is_device_mesh(mesh) -> bool:
    if not dist.is_available():
        return False
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(mesh, DeviceMesh)


def mesh_axis(mesh) -> str | int:
    """The axis of a ``DeviceMesh`` the source partition rides: ``data``
    when present, else its first dimension (by name, or index 0)."""
    names = mesh.mesh_dim_names or ()
    if "data" in names:
        return "data"
    return names[0] if names else 0


def _axis_size(mesh, axis: str | int) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis) if isinstance(axis, str) else axis)


def resolve_mesh(mesh) -> Axis:
    """Accept a ``torch.distributed.device_mesh.DeviceMesh`` or a shard
    count.  A count needs an initialised process group of exactly that
    many ranks (this rank's shard is its rank); with no group only ``1``
    is accepted, and it runs locally.  An :class:`Axis` passes through as
    already resolved: :data:`LOCAL` runs one shard here whatever group is
    initialised (the query server's ``.mesh(1)``)."""
    if isinstance(mesh, Axis):
        return mesh
    if _is_device_mesh(mesh):
        axis = mesh_axis(mesh)
        return Axis(_axis_size(mesh, axis), mesh.get_local_rank(axis), mesh.get_group(axis))
    n = int(mesh)
    if n < 1:
        raise ValueError(f"a mesh needs at least 1 shard, got {n}")
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if world != n:
            raise ValueError(
                f"mesh over {n} shards needs a process group of {n} ranks; "
                f"the initialised one has {world}"
            )
        return Axis(n, dist.get_rank(), dist.group.WORLD)
    if n != 1:
        raise ValueError(
            f"mesh over {n} shards needs a process group of {n} ranks and none "
            f"is initialised: launch with `torchrun --nproc-per-node {n}`, or "
            f"call torch.distributed.init_process_group(world_size={n}, "
            "rank=...) on every rank"
        )
    return Axis(1, 0, None)


def mesh_shards(mesh) -> int:
    """Shard count of a mesh spec (int or ``DeviceMesh``): no process
    group needed for an int, so ``Plan.explain()`` works anywhere."""
    if _is_device_mesh(mesh):
        return _axis_size(mesh, mesh_axis(mesh))
    return int(mesh)


def shard_attr(prep: Prepared) -> str:
    """The partitioned attribute: the root relation's group attribute."""
    root = prep.decomposition.root
    attr = prep.schema.group_of.get(root)
    if attr is None:  # decompose() always roots at a group relation
        raise ValueError(f"root {root!r} carries no group attribute")
    return attr


def shard_layout(
    prep: Prepared, num_shards: int
) -> tuple[str, tuple[tuple[int, int], ...], dict[str, int]]:
    """The shard attribute, its per-shard ``[lo, hi)`` code ranges
    (``CSRView.shard`` of the root's view) and the walk's domains, in
    which the shard attribute spans the uniform tile: the widest range,
    so a re-based shard code always lies inside it."""
    attr = shard_attr(prep)
    view = prep.csr_view(prep.decomposition.root, (attr,))
    ranges = tuple((lo, hi) for lo, hi, _ in view.shard(num_shards))
    domains = {a: prep.dicts[a].size for a in prep.dicts}
    domains[attr] = max(max(hi - lo for lo, hi in ranges), 1)
    return attr, ranges, domains


@dataclass(frozen=True)
class _Hop:
    """Static metadata for one decomposition-tree hop (alike on every
    rank: the shard attribute's domain is the uniform tile width).

    ``kept_attrs``/``child_shared`` are the key layout the walk ravels;
    ``perm`` the canonical transpose of its output."""

    rel: str
    children: tuple[str, ...]
    knum: int  # local output-key space (Π kept dims)
    width: int  # Π of child group widths
    kept_attrs: tuple[str, ...]  # up attrs + own group attr (key ravel)
    kept_dims: tuple[int, ...]
    child_shared: tuple[tuple[str, ...], ...]  # per child: gather ravel
    child_shapes: tuple[tuple[int, int], ...]  # (shared_prod, group_prod)
    gdims_all: tuple[int, ...]  # concatenated child group dims
    perm: tuple[int, ...]  # raw -> canonical-order transpose
    out_dims: tuple[int, ...]  # message dims after the transpose


def _build_schedule(prep: Prepared, domains: dict[str, int]) -> tuple[_Hop, ...]:
    """Post-order hop schedule mirroring ``TensorEngine.contract_rows``
    (same kept/shared attr math, same canonical transpose)."""
    deco = prep.decomposition
    canonical = [attr for _, attr in prep.group_attrs]
    hops: list[_Hop] = []
    msg_attrs: dict[str, tuple[tuple[str, ...], int]] = {}

    def dims(attrs: tuple[str, ...]) -> tuple[int, ...]:
        return tuple(domains[a] for a in attrs)

    def walk(rel: str, parent: str | None) -> None:
        er = prep.encoded[rel]
        children = tuple(deco.nodes[rel].children)
        for c in children:
            walk(c, rel)
        own_g = prep.schema.group_of.get(rel)
        up: tuple[str, ...] = ()
        if parent is not None:
            up = tuple(sorted(set(er.attrs) & set(prep.encoded[parent].attrs)))
        child_gattrs: list[str] = []
        child_shapes: list[tuple[int, int]] = []
        child_shared: list[tuple[str, ...]] = []
        for c in children:
            cattrs, nsh = msg_attrs[c]
            shared, gattrs = cattrs[:nsh], cattrs[nsh:]
            child_shared.append(shared)
            child_shapes.append((math.prod(dims(shared)), math.prod(dims(gattrs))))
            child_gattrs.extend(gattrs)
        kept_own = up + ((own_g,) if own_g else ())
        kept_dims = dims(kept_own)
        gattrs_all = ([own_g] if own_g else []) + child_gattrs
        want_g = sorted(gattrs_all, key=canonical.index)
        raw = list(kept_own) + child_gattrs
        want = list(up) + want_g
        msg_attrs[rel] = (tuple(want), len(up))
        hops.append(
            _Hop(
                rel=rel,
                children=children,
                knum=math.prod(kept_dims),
                width=math.prod(gp for _, gp in child_shapes),
                kept_attrs=kept_own,
                kept_dims=kept_dims,
                child_shared=tuple(child_shared),
                child_shapes=tuple(child_shapes),
                gdims_all=dims(tuple(child_gattrs)),
                perm=tuple(raw.index(a) for a in want),
                out_dims=dims(tuple(want)),
            )
        )

    walk(deco.root, None)
    root_attrs, _ = msg_attrs[deco.root]
    if root_attrs != tuple(canonical):
        raise AssertionError((root_attrs, canonical))
    return tuple(hops)


@dataclass
class DistributedSparseProgram:
    """One rank's part of a sharded sparse execution of a ``Prepared``.

    ``channel_measures`` as in :class:`~repro_torch.core.torch_engine.
    SparseProgram`; ``minmax`` is a tuple of ``(kind, relation)`` pairs,
    each one ``(min, +)`` / ``(max, +)`` pass over the same shard.
    ``encoded`` holds this rank's relations: its shard's slice of each
    relation that carries the shard attribute (re-based to the shard's
    range, over a domain of ``tile`` codes), the prepared relation
    elsewhere.  ``views`` holds the slices' grouped-CSR views on
    ``device``, uploaded once at build; the replicated relations' views
    are the ``Prepared``'s own device views, shared with single-device
    runs.  Built once per (plan, mesh) by
    :func:`build_distributed_program`; ``run()`` is a collective call.
    """

    prep: Prepared
    channel_measures: tuple[str | None, ...]
    minmax: tuple[tuple[str, str], ...]
    axis: Axis
    attr: str
    ranges: tuple[tuple[int, int], ...]  # per-shard [lo, hi) code ranges
    tile: int  # uniform local domain of the shard attr
    hops: tuple[_Hop, ...]
    encoded: dict
    domains: dict[str, int]
    device: torch.device
    fused: bool = False
    views: dict = field(default_factory=dict, repr=False)

    @property
    def k(self) -> int:
        return len(self.channel_measures)

    @property
    def num_shards(self) -> int:
        return len(self.ranges)

    # ------------------------------------------------------------------
    def walk(self) -> torch.Tensor:
        """This rank's partial over the canonical group axes, the shard
        axis ``tile`` codes wide: ``(*group dims, k + len(minmax))``
        float64 on the device, the ``k`` channels (float32 sums, held
        exactly) and then each MIN/MAX (0.0 where unreached)."""
        prog = SparseProgram(self.prep, self.channel_measures, self.device, self.fused)
        parts = [prog.run_channels(self.encoded, self.domains, view_cache=self.views)]
        for kind, rel in self.minmax:
            mm = prog.run_minmax(kind, rel, self.encoded, self.domains, view_cache=self.views)
            parts.append(mm.unsqueeze(-1))
        return torch.cat([p.to(torch.float64) for p in parts], dim=-1)

    def gather(self, partial: torch.Tensor) -> list[torch.Tensor]:
        """Every shard's partial, in shard order, on every rank: one
        ``all_gather`` over the axis group, none on a local mesh of one.
        A gloo group gathers on the host, so a partial on a card moves
        there first."""
        group = self.axis.group
        if group is None:
            return [partial]
        if partial.is_cuda and dist.get_backend(group) == "gloo":
            partial = partial.cpu()
        out = [torch.empty_like(partial) for _ in range(self.num_shards)]
        dist.all_gather(out, partial.contiguous(), group=group)
        return out

    def run(self) -> list[tuple[torch.Tensor, list[torch.Tensor], dict[str, int]]]:
        """Execute (every rank of the axis group calls it); one
        ``(channels, minmax arrays, offsets)`` triple per shard, in shard
        order.  ``channels`` is ``(*local group dims, k)`` with the shard
        axis cut back to the shard's real range; the MIN/MAX arrays hold
        0.0 where no row was reached (mask with the COUNT channel)."""
        pos = [a for _, a in self.prep.group_attrs].index(self.attr)
        k = self.k
        results = []
        for part, (lo, hi) in zip(self.gather(self.walk()), self.ranges):
            part = part.narrow(pos, 0, hi - lo)
            mms = [part[..., k + j] for j in range(len(self.minmax))]
            results.append((part[..., :k], mms, {self.attr: lo}))
        return results

    # ------------------------------------------------------------------
    def per_device_bytes(self) -> int:
        """This rank's working set: the edge tensors its walk reads (each
        relation's keys, codes and gather indices in int64 and its
        float32 weights per pass, for the slice it holds), plus the peak
        bytes of simultaneously live messages across the tree walk: a
        child's message stays live until its parent hop consumes it."""
        passes = self.k + len(self.minmax)  # a weight column per channel and per MIN/MAX
        edges = 0
        for hop in self.hops:
            er = self.encoded[hop.rel]
            ints = 1 + len(er.attrs) + len(hop.children)  # keys, codes, gathers
            edges += er.num_rows * (8 * ints + 4 * passes)
        per_msg = 4 * passes
        live: dict[str, int] = {}
        peak = 0
        for hop in self.hops:
            out_bytes = math.prod(hop.out_dims) * per_msg
            peak = max(peak, sum(live.values()) + out_bytes)
            for c in hop.children:
                live.pop(c)
            live[hop.rel] = out_bytes
        return edges + peak

    def host_keys(self, hop: _Hop) -> np.ndarray:
        """The hop's output keys as this rank's walk reads them, ascending:
        its slice's view, or the prepared relation's for a replicated
        one."""
        view = self.views.get((hop.rel, hop.kept_attrs))
        if view is not None:
            return view.keys_host
        return self.prep.csr_view(hop.rel, hop.kept_attrs).keys


def build_distributed_program(
    prep: Prepared,
    channel_measures: tuple[str | None, ...] = (None,),
    mesh=1,
    minmax: tuple[tuple[str, str], ...] = (),
    fused: bool | None = None,
    device="cuda",
) -> DistributedSparseProgram:
    """Partition ``prep`` over the mesh's data axis and bind this rank's
    shard (sliced, its views uploaded to ``device``) into a runnable
    program.

    ``fused=None`` defers to the ``REPRO_FUSED`` environment switch; the
    resolved flag joins the memo key, so fused and three-dispatch
    programs coexist.  Memoized on the ``Prepared`` per (channels,
    minmax, shard count, axis group, fused, device): a warm
    ``Plan.execute(mesh=...)`` re-slices and uploads nothing."""
    axis = resolve_mesh(mesh)
    fused = fused_enabled(fused)
    device = torch.device(device)
    key = (tuple(channel_measures), tuple(minmax), axis.shards, axis.group, fused, str(device))
    cached = prep.shard_programs.get(key)
    if cached is not None:
        return cached
    attr, ranges, domains = shard_layout(prep, axis.shards)
    hops = _build_schedule(prep, domains)

    lo, hi = ranges[axis.rank]
    encoded = csr_restrict(prep, attr, lo, hi)
    views = {}
    for hop in hops:
        er = encoded[hop.rel]
        if er is prep.encoded[hop.rel]:
            continue  # replicated: the Prepared's own device views
        host = grouped_csr(er, hop.kept_attrs, hop.kept_dims)
        views[(hop.rel, hop.kept_attrs)] = DeviceView.build(er, host, device)
    prog = DistributedSparseProgram(
        prep=prep,
        channel_measures=tuple(channel_measures),
        minmax=tuple(minmax),
        axis=axis,
        attr=attr,
        ranges=ranges,
        tile=domains[attr],
        hops=hops,
        encoded=encoded,
        domains=domains,
        device=device,
        fused=fused,
        views=views,
    )
    return prep.shard_programs.setdefault(key, prog)


def run(prep: Prepared, mesh, device="cuda") -> dict[tuple, float]:
    """Sharded COUNT over the mesh; ``{group values: count}`` (the legacy
    entry point; multi-aggregate bundles go through ``Plan.execute``)."""
    prog = build_distributed_program(prep, (None,), mesh, device=device)
    out: dict[tuple, float] = {}
    for arr, _, offsets in prog.run():
        out.update(_decode_result(prep, arr[..., 0], offsets=offsets))
    return out


def run_query(prep: Prepared, mesh, device="cuda") -> dict[tuple, float]:
    """Sharded single-aggregate execution of ``prep.query``, the
    distributed analogue of ``execute_torch`` (COUNT/SUM/MIN/MAX; AVG
    assembles on the planner, like everywhere else)."""
    query = prep.query
    kind = query.agg.kind
    if kind in ("count", "sum"):
        cm = (query.agg.measure[0] if kind == "sum" else None,)
        prog = build_distributed_program(prep, cm, mesh, device=device)
        out: dict[tuple, float] = {}
        for arr, _, offsets in prog.run():
            out.update(_decode_result(prep, arr[..., 0], offsets=offsets))
        return out
    if kind not in ("min", "max"):
        raise NotImplementedError(
            "distributed-sparse: COUNT/SUM/MIN/MAX (AVG assembles on the planner)"
        )
    prog = build_distributed_program(
        prep, (None,), mesh, minmax=((kind, query.agg.measure[0]),), device=device
    )
    out = {}
    for arr, mms, offsets in prog.run():
        # keep every joined group, zeros included (MIN/MAX semantics)
        out.update(_decode_result(prep, mms[0], arr[..., 0] > 0, offsets))
    return out
