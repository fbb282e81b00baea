"""The JOIN-AGG contraction on the card: two physical paths and the
choice between them (DESIGN.md §2, §7).

Port of the JAX package's ``core/jax_engine.py``.

* **dense** — every relation becomes a float32 multiplicity tensor over
  its attr domains, built on the engine's device from the pre-aggregated
  COO rows and memoized on the ``Prepared``; the decomposition tree
  contracts as one ``torch.einsum`` term per node (:class:`DenseProgram`).
  Fast at small domains, but the per-relation ``Π|dom(attrs)|`` tensors
  are the intermediate blowup JOIN-AGG exists to avoid.
* **sparse** — relations stay in grouped-CSR coordinate form and every
  hop runs on the hand-written kernels, with the JAX engine's routing:

  - single-child hop with channel-uniform weights → ``coo_spmm``, the
    child message as the dense operand (its ``k`` channels ride the
    columns);
  - leaf / multi-child / measure-weighted hop → the per-edge
    channel-diagonal product of gathered child message rows (plain
    tensor code), reduced with ``segment_sum``;
  - MIN/MAX → ``(min, +)`` / ``(max, +)`` semiring hops on
    ``segment_reduce``;
  - fused (``Q.fused(True)`` or ``REPRO_FUSED``) → every hop, sum or
    MIN/MAX, is one ``fused_hop`` launch: no edge chunks, no edge-sized
    product (DESIGN.md §13).

  What lives on the device: each grouped-CSR view (sorted keys, permuted
  codes and weights), moved once per ``Prepared`` or stream tile, and
  every message of the walk; peak memory is the largest message, and
  group-axis stream tiles bound even that.  Every view, weight and
  dense relation tensor moves to the device in row ranges
  (:func:`to_device_rows`) of the encoding's chunk size (a stored
  database's plan chunk, DESIGN.md §12, else ``DEFAULT_CHUNK_ROWS``), so
  host memory stays bounded by one range through the first execute as
  through a stored prepare.  The JAX engine's
  ``EDGE_BUCKET`` padding (static shapes for jit) and its numpy fallback
  for ``≥ 2**31`` segments are gone: the kernels index in int64.

:func:`choose_path` prices both paths per node and picks one as the JAX
package's ``choose_jax_path`` does (and, given a shard count, prices the
distributed-sparse path of ``core/distributed.py``, whose ranks each run
the sparse walk below on their shard); :func:`execute_torch` is the
single-aggregate entry.  Counts are exact in float32 up to 2**24 per
partial product on both paths.

Concurrent executes of one plan (the query server's workers) share the
``Prepared``'s memos: device views, their weights, dense tensors and
MIN/MAX payload values.  Each is built completely and then stored by
one assignment, so a race costs at most a second build of the same
value, never a reader of a half-built one.  Every launch goes to its
thread's current stream, the default one: a per-worker stream would let
one worker read a view whose upload is still queued on another's.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.operator import DEFAULT_MEMORY_BUDGET, node_message_bytes
from repro_torch.core.prepare import (
    CSRView,
    Prepared,
    csr_restrict,
    grouped_csr,
    prepare,
)
from repro_torch.core.query import JoinAggQuery
from repro_torch.core.tensor_engine import (
    ChannelTensorEngine,
    TensorEngine,
    _decode_result,
)
from repro_torch.kernels import ops
from repro_torch.kernels.coo_spmm import coo_spmm
from repro_torch.kernels.fused_hop import fused_hop, gathers_one_child
from repro_torch.kernels.ops import fused_enabled
from repro_torch.kernels.segment_reduce import segment_reduce
from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.relational.relation import Database
from repro_torch.relational.source import DEFAULT_CHUNK_ROWS


def require_device(
    device, what: str = "engine 'torch'",
    cpu: str = '.engine(TorchChannelEngine(device="cpu"))',
) -> torch.device:
    """``device`` as a ``torch.device``; raises when it is a card that is
    absent (nothing falls back to the CPU).  ``what`` names the caller
    and ``cpu`` the argument that puts it on the CPU, for the error."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on CUDA and no CUDA device is available; "
            f"pass {cpu} to run on the CPU"
        )
    return device


# ----------------------------------------------------------------------
# the dense einsum program
# ----------------------------------------------------------------------

MAX_DENSE_ELEMS = 1 << 26
# a single relation tensor beyond this many elements pushes the dense
# einsum path over its memory cliff; auto mode switches to sparse
DENSE_PROMOTE_ELEMS = 1 << 24


def _axis_letters(prep: Prepared) -> dict[str, str]:
    letters = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
    attrs = sorted({a for attrs in prep.schema.relevant.values() for a in attrs})
    if len(attrs) > len(letters):
        raise ValueError("too many attributes for einsum letters")
    return {a: letters[i] for i, a in enumerate(attrs)}


def dense_plan(prep: Prepared) -> tuple[tuple, str]:
    """Post-order einsum plan ``((rel, expr, child rels), ...)`` and the
    root: each node's term contracts its relation tensor with its
    children's messages into the attrs shared with its parent, then the
    subtree's group attrs in canonical order."""
    ax = _axis_letters(prep)
    deco = prep.decomposition
    canonical = [attr for _, attr in prep.group_attrs]
    plan: list[tuple[str, str, tuple[str, ...]]] = []

    def subtree(rel: str, parent: str | None) -> str:
        er = prep.encoded[rel]
        exprs = ["".join(ax[a] for a in er.attrs)]
        gattrs = [prep.schema.group_of[rel]] if rel in prep.schema.group_of else []
        children = tuple(deco.nodes[rel].children)
        for child in children:
            cexpr = subtree(child, rel)
            exprs.append(cexpr)
            gattrs.extend(
                a for a in canonical if ax[a] in cexpr and a not in gattrs
            )
        if parent is None:
            up: list[str] = []
        else:
            up = sorted(set(er.attrs) & set(prep.encoded[parent].attrs))
        out_attrs = list(up) + [a for a in canonical if a in gattrs]
        out_axes = "".join(ax[a] for a in out_attrs)
        plan.append((rel, ",".join(exprs) + "->" + out_axes, children))
        return out_axes

    subtree(deco.root, None)
    return tuple(plan), deco.root


def _channelize_plan(
    plan: tuple, root: str, z_flags: dict[str, bool]
) -> tuple[tuple, bool]:
    """Add a leading batch axis ``Z`` to every einsum term whose tensor (or
    subtree message) carries per-channel weights.

    ``Z`` as a batch axis gives exactly the diagonal semantics a channel
    needs: channel ``c`` of the output combines channel ``c`` of every
    channelized operand — k independent scalar programs fused into one
    einsum (DESIGN.md §6).
    """
    carries: dict[str, bool] = {}
    out_plan = []
    for rel, expr, children in plan:
        ins, out = expr.split("->")
        if "Z" in expr:
            raise ValueError("einsum axis letters exhausted (Z is reserved)")
        terms = ins.split(",")
        flags = [z_flags.get(rel, False)] + [carries[c] for c in children]
        carry = any(flags)
        if carry:
            terms = [("Z" + t) if fl else t for t, fl in zip(terms, flags)]
            out = "Z" + out
        carries[rel] = carry
        out_plan.append((rel, ",".join(terms) + "->" + out, children))
    return tuple(out_plan), carries[root]


def contract_term(expr: str, operands: list[torch.Tensor]) -> torch.Tensor:
    """``torch.einsum(expr, *operands)`` contracted pairwise, left to
    right: each step keeps only the axes a later operand or the output
    still needs.  ``torch.einsum`` orders three or more operands by
    ``opt_einsum`` where that package is installed and left to right
    where it is not; a fixed pairwise order gives every machine the same
    intermediates, peak memory and float rounding."""
    ins, out = expr.split("->")
    terms = ins.split(",")
    acc, acc_axes = operands[0], terms[0]
    for i in range(1, len(terms)):
        if i == len(terms) - 1:
            axes = out
        else:
            need = set(out).union(*terms[i + 1:])
            axes = "".join(dict.fromkeys(a for a in acc_axes + terms[i] if a in need))
        acc = torch.einsum(f"{acc_axes},{terms[i]}->{axes}", acc, operands[i])
        acc_axes = axes
    if len(terms) == 1:
        acc = torch.einsum(f"{acc_axes}->{out}", acc)
    return acc


def _set_full_fp32():
    """Switch float32 products to full FP32; return the function that
    restores the caller's setting.  Callers that set TF32 through the
    per-backend ``fp32_precision`` switch are restored through it
    (reading the process-wide precision then raises)."""
    try:
        saved = torch.get_float32_matmul_precision()
    except RuntimeError:
        matmul = torch.backends.cuda.matmul
        saved = matmul.fp32_precision
        matmul.fp32_precision = "ieee"
        return lambda: setattr(matmul, "fp32_precision", saved)
    torch.set_float32_matmul_precision("highest")
    return lambda: torch.set_float32_matmul_precision(saved)


# the precision is one process-wide switch: concurrent dense runs share
# one save and one restore, or the first to leave would restore the
# caller's TF32 under the others' products
_fp32_lock = threading.Lock()
_fp32_users = 0  # guarded-by: _fp32_lock
_fp32_restore = None  # guarded-by: _fp32_lock


@contextlib.contextmanager
def full_fp32_matmul():
    """Run the enclosed products in full FP32, then restore the caller's
    setting: float32 counts are exact below 2**24 only without TF32.
    Entries are counted across threads: the first sets FP32 and saves
    the caller's setting, the last out restores it."""
    global _fp32_users, _fp32_restore
    with _fp32_lock:
        if _fp32_users == 0:
            _fp32_restore = _set_full_fp32()
        _fp32_users += 1
    try:
        yield
    finally:
        with _fp32_lock:
            _fp32_users -= 1
            if _fp32_users == 0:
                restore, _fp32_restore = _fp32_restore, None
                restore()


def _chunk_of(er) -> int:
    """Rows per host range when ``er``'s rows move to the device: its
    streaming chunk (a stored database's plan chunk), else
    ``DEFAULT_CHUNK_ROWS``."""
    return int(getattr(er, "_chunk_rows", None) or DEFAULT_CHUNK_ROWS)


def to_device_rows(shape, dtype, device, chunk: int, rows_of) -> torch.Tensor:
    """A ``shape`` tensor of ``dtype`` on ``device``, filled in row ranges
    of ``chunk`` rows: ``rows_of(lo, hi)`` gives rows ``lo:hi`` on the
    host (a gather, or a slice of a memmap).  Host memory holds one range
    at a time; a read-only range (a stored memmap's pages) is copied
    before torch sees it, so no memmap is shared or written."""
    dst = torch.empty(shape, dtype=dtype, device=device)
    host_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    for lo in range(0, shape[0], chunk):
        hi = min(lo + chunk, shape[0])
        rows = np.require(rows_of(lo, hi), host_dtype, ["C", "W"])
        dst[lo:hi].copy_(torch.from_numpy(rows))
    return dst


def _scatter(prep: Prepared, rel: str, values: np.ndarray, device) -> torch.Tensor:
    """``rel``'s per-row ``values`` in a dense float32 tensor over its attr
    domains on ``device``.  The relation's grouped-CSR view keyed on all
    its attrs holds each row's row-major position, ascending: where those
    positions are unique (pre-aggregation makes them so) one indexed
    store places every value; otherwise ``segment_sum`` reduces the rows
    of each position in that fixed order, without atomics, so the same
    rows give the same bits on every run."""
    er = prep.encoded[rel]
    dims = tuple(prep.dicts[a].size for a in er.attrs)
    elems = math.prod(dims)
    if elems > MAX_DENSE_ELEMS:
        raise MemoryError(
            f"dense tensor for {rel} would have {elems} elems; use the "
            "sparse path"
        )
    flat = torch.zeros(elems, dtype=torch.float32, device=device)
    if er.num_rows == 0:
        return flat.reshape(dims)
    view = prep.csr_view(rel, er.attrs)
    n, chunk = len(view.keys), _chunk_of(er)
    keys = to_device_rows(
        (n,), torch.int64, device, chunk, lambda lo, hi: view.keys[lo:hi]
    )
    vals = to_device_rows(
        (n,), torch.float32, device, chunk,
        lambda lo, hi: values[np.asarray(view.order[lo:hi])],
    )
    if bool((keys[1:] != keys[:-1]).all()):
        flat[keys] = vals
    else:
        flat = segment_sum(vals.reshape(-1, 1), keys, elems).reshape(-1)
    return flat.reshape(dims)


def dense_tensor(
    prep: Prepared, rel: str, device, channel_measures: tuple = ()
) -> torch.Tensor:
    """``rel``'s dense float32 tensor on ``device``: its multiplicities,
    or, when ``channel_measures`` names it, a leading channel axis whose
    channel ``c`` carries the ``sum`` payload where ``channel_measures[c]
    == rel`` and the multiplicities elsewhere.  Memoized on the
    ``Prepared`` beside the sparse path's device views, so a warm
    execute only contracts; a split plan's key-range part
    (``memo_dense`` False) builds it per run instead."""
    layout = tuple(channel_measures) if rel in channel_measures else ()
    key = ("dense", str(device), rel, layout)
    memo = prep.device_views
    if key in memo:
        return memo[key]
    er = prep.encoded[rel]
    tensor = _scatter(prep, rel, er.count, device)
    if layout:
        pay = _scatter(prep, rel, er.payloads["sum"], device)
        tensor = torch.stack([pay if m == rel else tensor for m in layout])
    if prep.memo_dense:
        memo[key] = tensor
    return tensor


@dataclass
class DenseProgram:
    """The einsum message-passing program of one ``Prepared`` on
    ``device``: :func:`dense_plan`'s terms, each contracted by
    :func:`contract_term` in full FP32."""

    prep: Prepared
    plan: tuple
    root: str
    device: torch.device

    def terms(self, channel_measures: tuple[str | None, ...]) -> tuple:
        """The pass's ``(rel, einsum expr, child rels)`` terms in post
        order: :func:`dense_plan`'s, with a leading channel axis ``Z``
        on every term a measure relation's channels reach."""
        z_rels = {r for r in channel_measures if r is not None}
        if not z_rels:
            return self.plan
        return _channelize_plan(self.plan, self.root, {r: True for r in z_rels})[0]

    def run_channels(self, channel_measures: tuple[str | None, ...]) -> torch.Tensor:
        """One pass for ``k`` COUNT/SUM channels (entry ``c`` names the
        relation whose ``sum`` payload rides channel ``c``, None =
        COUNT); ``(*group_dims, k)`` float32 on the device.  Measure
        relations carry a channel axis ``Z`` through every term above
        them; an all-COUNT bundle runs one scalar program."""
        k = len(channel_measures)
        z_rels = {r for r in channel_measures if r is not None}
        tensors = {
            r: dense_tensor(self.prep, r, self.device, channel_measures)
            for r in self.prep.encoded
        }
        results: dict[str, torch.Tensor] = {}
        with full_fp32_matmul():
            for rel, expr, children in self.terms(channel_measures):
                results[rel] = contract_term(
                    expr, [tensors[rel]] + [results[c] for c in children]
                )
        arr = results[self.root]
        if not z_rels:
            return arr.unsqueeze(-1).expand(arr.shape + (k,))
        return arr.movedim(0, -1)


def build_dense_program(prep: Prepared, device) -> DenseProgram:
    """Bind ``Prepared`` + device into a :class:`DenseProgram`."""
    plan, root = dense_plan(prep)
    return DenseProgram(prep, plan, root, torch.device(device))


def execute_torch(
    query: JoinAggQuery,
    db: Database,
    prep: Prepared | None = None,
    mode: str = "auto",
    device="cuda",
    memory_budget: int | None = None,
) -> dict[tuple, float]:
    """Single-aggregate execution on ``device``.

    ``mode``: ``"auto"`` (:func:`choose_path`), ``"dense"`` (einsum;
    COUNT/SUM only) or ``"sparse"`` (the kernels over grouped-CSR
    relations; COUNT/SUM/MIN/MAX).  MIN/MAX always run sparse: the dense
    einsum has no ``(min, +)`` form."""
    device = require_device(device)
    if prep is None:
        prep = prepare(query, db)
    query = prep.query  # fold may re-point the aggregate's measure relation
    kind = query.agg.kind
    if kind not in ("count", "sum", "min", "max"):
        raise NotImplementedError(
            "torch engine: COUNT/SUM/MIN/MAX (AVG assembles on the planner)"
        )
    if mode == "auto":
        if kind in ("min", "max"):
            mode = "sparse"
        else:
            mode = choose_path(prep, memory_budget=memory_budget).path
    measure = query.agg.measure[0] if kind == "sum" else None
    if mode == "dense":
        if kind not in ("count", "sum"):
            raise NotImplementedError("torch dense mode: COUNT/SUM only")
        arr = build_dense_program(prep, device).run_channels((measure,))
        return _decode_result(prep, arr[..., 0])
    if mode == "sparse":
        prog = build_sparse_program(prep, (measure,), device)
        arr = prog.run_channels()[..., 0]
        if kind in ("count", "sum"):
            return _decode_result(prep, arr)
        # MIN/MAX: the COUNT channel is the support (a zero can be a
        # genuine MIN/MAX value, so joined groups are kept by count)
        return _decode_result(prep, prog.run_minmax(kind, query.agg.measure[0]), arr > 0)
    raise ValueError(f"unknown mode {mode!r}; use 'auto', 'dense' or 'sparse'")


# ----------------------------------------------------------------------
# the sparse program
# ----------------------------------------------------------------------

# the general hop's per-edge product materializes (edges × width·k)
# floats; the edge axis is chunked so that temporary stays within this
# bound however large the relation
_REF_GATHER_BYTES = 64 << 20


@dataclass
class DeviceView:
    """A :class:`~repro_torch.core.prepare.CSRView` moved to the device:
    the relation's codes in ascending-key order and the keys themselves
    (kept on the host too, where edge chunks are planned without reading
    the device), plus the engines' memo of weights uploaded in that
    order."""

    attrs: tuple[str, ...]
    keys: torch.Tensor  # (n,) int64, ascending
    keys_host: np.ndarray  # the same keys on the host
    codes: torch.Tensor  # (n, arity) int64
    order: np.ndarray  # sorted position -> encoded row
    memo: dict = field(default_factory=dict)
    # rows per host range of its uploads (:func:`to_device_rows`)
    chunk_rows: int = DEFAULT_CHUNK_ROWS

    @staticmethod
    def build(er, view: CSRView, device: torch.device) -> "DeviceView":
        """``view`` on ``device``, moved in row ranges of ``er``'s chunk
        size.  The host keys stay the view's own (a memmap is only
        read)."""
        n, chunk = len(view.keys), _chunk_of(er)
        keys = to_device_rows(
            (n,), torch.int64, device, chunk, lambda lo, hi: view.keys[lo:hi]
        )
        codes = to_device_rows(
            (n, len(er.attrs)), torch.int64, device, chunk,
            lambda lo, hi: er.codes[np.asarray(view.order[lo:hi])],
        )
        return DeviceView(view.attrs, keys, view.keys, codes, view.order, chunk_rows=chunk)

    def upload(self, rows_of, tail: tuple[int, ...] = ()) -> torch.Tensor:
        """Per-edge values in key order, float32 on the view's device:
        ``rows_of(idx)`` gives the host values (rows of shape ``tail``) of
        encoded rows ``idx``, one row range at a time."""
        return to_device_rows(
            (len(self.order),) + tuple(tail), torch.float32, self.keys.device,
            self.chunk_rows, lambda lo, hi: rows_of(np.asarray(self.order[lo:hi])),
        )


def key_chunks(
    keys: np.ndarray, num_keys: int, chunk: int
) -> Iterator[tuple[int, int, int, int, bool]]:
    """Split ascending ``keys`` into edge ranges of at most ``chunk`` edges.

    Yields ``(e_lo, e_hi, k_lo, k_hi, shared)``: edges ``[e_lo, e_hi)``
    hold every edge with a key in ``[k_lo, k_hi)`` except, when
    ``shared``, the earlier edges of key ``k_lo`` (a run longer than a
    chunk is split, and its key appears in two ranges).  The key ranges
    tile ``[0, num_keys)``, so one kernel launch per chunk writes each
    output row once and only split runs need combining.
    """
    n = len(keys)
    if n == 0:
        yield 0, 0, 0, num_keys, False
        return
    bounds = [0]
    while bounds[-1] < n:
        lo = bounds[-1]
        hi = min(lo + chunk, n)
        if hi < n:
            cut = int(np.searchsorted(keys, keys[hi], "left"))
            if cut > lo:  # end at a run boundary unless the run fills the chunk
                hi = cut
        bounds.append(hi)
    for i in range(len(bounds) - 1):
        lo, hi = bounds[i], bounds[i + 1]
        shared = i > 0 and keys[lo - 1] == keys[lo]
        k_lo = 0 if i == 0 else int(keys[lo])
        if hi == n:
            k_hi = num_keys
        else:
            k_hi = int(keys[hi]) + int(keys[hi - 1] == keys[hi])
        yield lo, hi, k_lo, k_hi, shared


class _CsrHopMixin:
    """Feed every hop its relation in grouped-CSR order on the device:
    edges sorted by the hop's raveled output key (up attrs + own group
    attr), so each output row's edges form one contiguous run.  Views of
    the prepared relations are memoized on the ``Prepared``; a stream
    tile's views in ``view_cache``, shared by the tile's channel pass and
    each MIN/MAX pass, so every relation moves to the device once."""

    view_cache: dict

    def _view(self, rel: str, key_attrs: tuple[str, ...]) -> DeviceView:
        er = self.encoded[rel]
        if er is self.prep.encoded.get(rel):
            cache, key = self.prep.device_views, (str(self.device), rel, key_attrs)
        else:  # stream tile: restricted domains, tile-local view
            cache, key = self.view_cache, (rel, key_attrs)
        view = cache.get(key)
        if view is None:
            if cache is self.view_cache:
                host = grouped_csr(er, key_attrs, self._dims(key_attrs))
            else:
                host = self.prep.csr_view(rel, key_attrs)
            # built whole, then stored once: concurrent executes may
            # build it twice, never read it half built
            view = cache[key] = DeviceView.build(er, host, self.device)
        return view


def _gathered_products(vals, gathers, sl, combine, chan: tuple[int, ...]):
    """Per-edge outer product (``combine`` = ``*`` or ``+``) of the edge
    weights with each child's gathered message rows, channel-diagonal."""
    for m2, idx in gathers:
        rows = m2[idx[sl]]  # (c, Wc, *chan)
        width = vals.shape[1] * rows.shape[1]
        vals = combine(
            vals.unsqueeze(2), rows.unsqueeze(1)
        ).reshape((vals.shape[0], width) + chan)
    return vals


def _reduce_in_chunks(
    keys: torch.Tensor, keys_host: np.ndarray, out: torch.Tensor, chunk: int,
    edge_values, reduce, combine,
) -> torch.Tensor:
    """Fill ``out`` (one row per key) chunk by chunk: for each key range
    of :func:`key_chunks`, form the chunk's per-edge values
    (``edge_values(edge slice)``) and let the kernel (``reduce(values,
    ids, num_keys, out=rows)``) write the range's rows; a run split
    across two chunks combines its two partials with ``combine``."""
    for e_lo, e_hi, k_lo, k_hi, shared in key_chunks(keys_host, out.shape[0], chunk):
        sl = slice(e_lo, e_hi)
        dst = out[k_lo:k_hi]
        carry = dst[0].clone() if shared else None
        reduce(edge_values(sl), keys[sl] - k_lo, k_hi - k_lo, out=dst)
        if carry is not None:
            dst[0] = combine(dst[0], carry)
    return out


def contract_hop(
    keys: torch.Tensor,
    keys_host: np.ndarray,
    w: torch.Tensor,
    gathers,
    knum: int,
    kind: str,
    fused: bool,
    uniform: bool = False,
) -> torch.Tensor:
    """One hop into ``(knum, width·k)``: ``out[keys[e]] ⊕= w[e] ⊗ Π_c
    m2_c[idx_c[e]]`` (outer product over the children's widths,
    channel-diagonal) for edges in grouped-CSR order — ``keys`` ascending
    on the device, ``keys_host`` the same keys on the host —, ``w (n,
    k)``, ``gathers`` of ``(m2 (rows, width_c[, k]), idx (n,))`` pairs and
    ``kind`` ``"sum"`` (×, +) or ``"min"``/``"max"`` (+, min/max; k = 1).

    ``fused`` → one ``fused_hop`` launch.  Otherwise the JAX engine's
    three-dispatch routing: a single-child sum hop with channel-
    ``uniform`` weights on ``coo_spmm``; every other hop as the per-edge
    product of gathered child rows, in edge chunks bounded by
    ``_REF_GATHER_BYTES``, reduced by ``segment_sum`` or
    ``segment_reduce``."""
    k = w.shape[1]
    gathers = [(m2.reshape(m2.shape[0], m2.shape[1], k), idx) for m2, idx in gathers]
    if fused:
        return fused_hop(
            keys, w, [m2.reshape(m2.shape[0], -1) for m2, _ in gathers],
            [idx for _, idx in gathers], knum, k, kind,
        )
    if kind == "sum" and len(gathers) == 1 and uniform:
        m2, idx = gathers[0]
        return coo_spmm(
            keys, idx, w[:, 0].contiguous(), m2.reshape(m2.shape[0], -1), knum
        )
    width = math.prod(m2.shape[1] for m2, _ in gathers)
    out = torch.empty((knum, width * k), dtype=torch.float32, device=w.device)
    if kind == "sum":
        combine, reduce, merge = torch.mul, segment_sum, torch.add
    else:
        combine = torch.add
        reduce = functools.partial(segment_reduce, kind=kind)
        merge = torch.minimum if kind == "min" else torch.maximum
    return _reduce_in_chunks(
        keys, keys_host, out, max(1024, _REF_GATHER_BYTES // max(4 * width * k, 1)),
        lambda sl: _gathered_products(
            w[sl].reshape(-1, 1, k), gathers, sl, combine, (k,)
        ).reshape(sl.stop - sl.start, width * k),
        reduce, merge,
    )


class _KernelChannelEngine(_CsrHopMixin, ChannelTensorEngine):
    """k-channel contraction whose hops run on ``coo_spmm`` (single child,
    channel-uniform weights) or ``segment_sum`` (everything else), or each
    on one ``fused_hop`` launch when ``fused``."""

    def __init__(
        self, *args, view_cache: dict | None = None, fused: bool = False, **kwargs
    ):
        super().__init__(*args, **kwargs)
        self.view_cache = {} if view_cache is None else view_cache
        self.fused = fused

    def _weights(self, rel: str, view: DeviceView):
        """``((n, k) weights, uniform)``; ``uniform`` (every channel
        weighs an edge alike) is decided once per view on the host.  Each
        channel's column (its ``sum`` payload or the multiplicities, as
        :func:`channel_weight_matrices` lays them out) is formed in
        float64, then float32, one row range at a time."""
        key = ("channels", self.channel_measures)
        if key not in view.memo:
            er = self.encoded[rel]
            cols = [
                er.payloads["sum"] if m == rel else er.count
                for m in self.channel_measures
            ]
            flags = []

            def rows_of(idx):
                w = np.stack([np.asarray(c[idx], np.float64) for c in cols], axis=1)
                w = w.astype(np.float32)
                flags.append(self.k == 1 or bool((w == w[:, :1]).all()))
                return w

            dev = view.upload(rows_of, (self.k,))
            view.memo[key] = (dev, all(flags))
        return view.memo[key]

    def _contract_block(self, weights, gathers, view, knum):
        w, uniform = weights
        return contract_hop(
            view.keys, view.keys_host, w, gathers, knum, "sum", self.fused, uniform
        )


# MIN/MAX walk payload ranks while they stay exact in float32
_MAX_EXACT_RANKS = 1 << 24


class _MinMaxKernelEngine(_CsrHopMixin, TensorEngine):
    """(min, +) / (max, +) semiring message passing over the tree: the
    measure relation contributes its per-edge payload rank (its position
    in ``values``, the sorted distinct payloads; or, with ``values``
    None, the payload itself in float32), every other relation
    contributes 0, and each hop reduces the per-edge candidate sums into
    their row keys with ``segment_reduce`` (or forms and reduces them in
    one ``fused_hop`` launch when ``fused``).  Unreached entries hold the
    identity (±inf) until :meth:`SparseProgram.run_minmax` masks them."""

    def __init__(
        self, prep, kind: str, rel_m: str, device, *,
        values: np.ndarray | None = None,
        domains=None, encoded=None, view_cache: dict | None = None,
        fused: bool = False,
    ):
        super().__init__(prep, device, domains=domains, encoded=encoded)
        self.kind = kind
        self.rel_m = rel_m
        self.values = values
        self.view_cache = {} if view_cache is None else view_cache
        self.fused = fused

    def _weights(self, rel: str, view: DeviceView) -> torch.Tensor:
        er = self.encoded[rel]
        if rel != self.rel_m:
            return torch.zeros(er.num_rows, dtype=torch.float32, device=self.device)
        key = ("payload", self.kind, self.values is None)
        if key not in view.memo:
            payload = er.payloads[self.kind]
            view.memo[key] = view.upload(
                lambda idx: payload[idx] if self.values is None
                else np.searchsorted(self.values, payload[idx])
            )
        return view.memo[key]

    def _contract_block(self, weights, gathers, view, knum):
        return contract_hop(
            view.keys, view.keys_host, weights.reshape(-1, 1), gathers, knum,
            self.kind, self.fused,
        )


def _distinct(values: np.ndarray, chunk: int) -> np.ndarray:
    """``np.unique(values)``, folded over row ranges of ``chunk`` as a
    running sorted union (the same array, read a range at a time)."""
    if len(values) <= chunk:
        return np.unique(values)
    out = np.unique(values[:0])
    for lo in range(0, len(values), chunk):
        out = np.union1d(out, values[lo:lo + chunk])
    return out


@dataclass
class SparseProgram:
    """A sparse execution of one ``Prepared`` on ``device``.

    ``channel_measures`` entry ``c`` names the relation whose ``sum``
    payload rides channel ``c`` (None = COUNT).  Grouped-CSR views are
    memoized on the ``Prepared`` (host and device), so repeated runs and
    stream tiles reuse the sorted, uploaded edge blocks.  ``fused``
    (True/False pins it, None follows ``REPRO_FUSED``, read once per
    pass) runs every hop on ``fused_hop``.
    """

    prep: Prepared
    channel_measures: tuple[str | None, ...]
    device: torch.device
    fused: bool | None = None

    @property
    def k(self) -> int:
        return len(self.channel_measures)

    def run_channels(
        self, encoded=None, domains=None, view_cache: dict | None = None
    ) -> torch.Tensor:
        """One leaves→root kernel pass; ``(*group_dims, k)`` float32 on
        the device."""
        eng = _KernelChannelEngine(
            self.prep, self.channel_measures, self.device,
            domains=domains, encoded=encoded, view_cache=view_cache,
            fused=fused_enabled(self.fused),
        )
        return eng.run()

    def _payload_values(self, kind: str, rel_m: str):
        """Sorted distinct ``kind`` payloads of ``rel_m`` (host, and as
        float64 on the device), memoized on the ``Prepared``; None when
        there are too many for their ranks to stay exact in float32."""
        key = (str(self.device), rel_m, kind)
        memo = self.prep.payload_values
        if key not in memo:
            er = self.prep.encoded[rel_m]
            host = _distinct(er.payloads[kind], _chunk_of(er))
            memo[key] = (
                (host, torch.from_numpy(host).to(self.device))
                if len(host) <= _MAX_EXACT_RANKS else None
            )
        return memo[key]

    def run_minmax(
        self, kind: str, rel_m: str, encoded=None, domains=None,
        view_cache: dict | None = None,
    ) -> torch.Tensor:
        """MIN/MAX(rel_m) over canonical group axes on the device, float64;
        unreached groups hold 0.0 — mask with a COUNT support before use.

        The walk runs on payload ranks, which float32 holds exactly, and
        the reached ranks map back to the float64 payloads here, so
        fractional measures come back unrounded (a min or max is one of
        the payloads, and ranks order as the payloads do)."""
        values = self._payload_values(kind, rel_m)
        eng = _MinMaxKernelEngine(
            self.prep, kind, rel_m, self.device,
            values=None if values is None else values[0],
            domains=domains, encoded=encoded, view_cache=view_cache,
            fused=fused_enabled(self.fused),
        )
        arr = eng.run()
        reached = torch.isfinite(arr)
        out = torch.where(reached, arr, torch.zeros_like(arr))
        if values is None or not len(values[0]):  # no payloads: none reached
            return out.to(torch.float64)
        return torch.where(reached, values[1][out.long()], 0.0)

    def run_stream(self, attr: str, tile: int):
        """Yield ``(encoded, domains, offsets)`` per group-axis row tile
        (:func:`stream_tiles`)."""
        return stream_tiles(self.prep, attr, tile)


def stream_tiles(prep: Prepared, attr: str, tile: int):
    """Yield ``(encoded, domains, offsets)`` per row tile of group attr
    ``attr``; relations are sliced through their grouped-CSR views,
    re-based to the tile-local code range."""
    total = prep.dicts[attr].size
    for lo in range(0, total, tile):
        hi = min(lo + tile, total)
        enc = csr_restrict(prep, attr, lo, hi)
        domains = {a: prep.dicts[a].size for a in prep.dicts}
        domains[attr] = hi - lo
        yield enc, domains, {attr: lo}


def build_sparse_program(
    prep: Prepared,
    channel_measures: tuple[str | None, ...],
    device,
    fused: bool | None = None,
) -> SparseProgram:
    """Bind ``Prepared`` + channel spec + device (+ the fused-hop option)
    into a :class:`SparseProgram`."""
    return SparseProgram(prep, tuple(channel_measures), torch.device(device), fused)


# ----------------------------------------------------------------------
# the launch shape of each fused hop
# ----------------------------------------------------------------------


def hop_launch_shapes(
    prep: Prepared, k: int = 1, encoded=None, domains: dict[str, int] | None = None
) -> list[dict]:
    """Per-hop launch shapes of one fused pass of ``k`` channels over
    ``prep`` (or a stream tile's ``encoded`` relations and ``domains``),
    in tree order (root first; the walk launches children first): each
    hop's ``fused_hop`` launch takes :func:`ops.gather_plan` (one child,
    rows of 32 floats or more) or :func:`ops.walk_plan` for its edges
    into ``(num_segments, width·k)``.  Entries hold ``rel``, ``walk`` ("gather" | "tile"),
    ``edges``, ``num_segments``, ``width`` (floats per output row),
    ``plan`` (None where the launch shape cannot be made, ``error`` then
    says why) and ``acc_dtype``.  Hops with no output row launch nothing
    and have no entry.  ``Plan.fused_runs()`` names every pass of an
    execute; ``Plan.explain()`` renders their shapes and the verifier
    checks them."""
    deco = prep.decomposition
    group_of = prep.schema.group_of
    encoded = prep.encoded if encoded is None else encoded

    def dom(a: str) -> int:
        return domains[a] if domains is not None else prep.dicts[a].size

    def group_width(rel: str) -> int:
        g = group_of.get(rel)
        width = dom(g) if g else 1
        for c in deco.nodes[rel].children:
            width *= group_width(c)
        return width

    out: list[dict] = []
    for rel in deco.order:
        node = deco.nodes[rel]
        er = encoded[rel]
        up: tuple[str, ...] = ()
        if node.parent is not None:
            up = tuple(sorted(set(er.attrs) & set(encoded[node.parent].attrs)))
        own_g = group_of.get(rel)
        knum = math.prod(dom(a) for a in up + ((own_g,) if own_g else ()))
        d = math.prod(group_width(c) for c in node.children) * k
        if knum < 1 or d < 1:
            continue
        walk = "gather" if gathers_one_child(len(node.children), d) else "tile"
        entry = {
            "rel": rel, "walk": walk, "edges": er.num_rows, "num_segments": knum,
            "width": d, "plan": None, "error": None, "acc_dtype": "float32",
        }
        try:
            make = ops.gather_plan if walk == "gather" else ops.walk_plan
            entry["plan"] = make(er.num_rows, knum, d)
        except ValueError as e:
            entry["error"] = str(e)
        out.append(entry)
    return out


# ----------------------------------------------------------------------
# cost-based dense-vs-sparse path choice
# ----------------------------------------------------------------------


@dataclass
class PathChoice:
    """Outcome of :func:`choose_path`, rendered by ``Plan.explain()``."""

    path: str  # "dense" | "sparse" | "distributed-sparse"
    reason: str
    dense_node_bytes: dict[str, int] = field(default_factory=dict)
    sparse_node_bytes: dict[str, int] = field(default_factory=dict)
    # meshed plans only: per-node bytes on ONE rank of the shard mesh
    # (sharded relations and messages divide by the shard count,
    # replicated subtrees do not): the currency of the distributed
    # path's explain
    per_device_node_bytes: dict[str, int] = field(default_factory=dict)
    shards: int = 1

    @property
    def dense_peak(self) -> int:
        # the einsum program holds every relation tensor at once
        return sum(self.dense_node_bytes.values())

    @property
    def sparse_peak(self) -> int:
        return max(self.sparse_node_bytes.values(), default=0)

    @property
    def per_device_peak(self) -> int:
        return max(self.per_device_node_bytes.values(), default=0)


def _node_message_attrs(prep: Prepared) -> dict[str, set[str]]:
    """Attrs carried by each node's upward message (shared-with-parent +
    subtree group attrs): membership only, for shard-split estimates."""
    deco = prep.decomposition

    def subtree_gattrs(rel: str) -> set[str]:
        out = set()
        g = prep.schema.group_of.get(rel)
        if g:
            out.add(g)
        for c in deco.nodes[rel].children:
            out |= subtree_gattrs(c)
        return out

    out: dict[str, set[str]] = {}
    for rel in deco.order:
        node = deco.nodes[rel]
        up: set[str] = set()
        if node.parent is not None:
            up = set(prep.schema.relevant[rel]) & set(prep.schema.relevant[node.parent])
        out[rel] = up | subtree_gattrs(rel)
    return out


def choose_path(
    prep: Prepared,
    k: int = 1,
    memory_budget: int | None = None,
    stream: tuple[str, int] | None = None,
    measured: tuple[str | None, ...] = (),
    shards: int | None = None,
    stats=None,
) -> PathChoice:
    """Estimate per-node dense-vs-sparse peak bytes and pick the path, as
    the JAX package's ``choose_jax_path`` does.

    Dense cost per node: the f32 relation tensor over its attr domains
    (×k only for ``measured`` relations — the dense channel program only
    k-stacks the measure tensors, everything else keeps one tensor) plus
    the f32 einsum message (``node_message_bytes`` re-scaled; messages
    carry the channel axis only when a measure channelizes the program).
    Sparse cost per node: the CSR edge arrays plus the f32 k-channel
    message.  Sparse wins when an explicit ``stream`` is set (dense
    cannot tile), when any dense tensor crosses the 2^24 element cliff,
    when the dense program exceeds the memory budget, or when
    statistics (``stats``, defaulting to the plan's collection when one
    was materialized) estimate a large dense tensor to be
    extreme-sparse.

    ``shards`` (a mesh's data-axis extent) forces the third path,
    ``distributed-sparse`` (the dense program does not run on meshes),
    and fills ``per_device_node_bytes``: edge arrays and messages that
    carry the shard attribute divide by the shard count, replicated
    subtrees keep their full size (DESIGN.md §8).  With statistics the
    divisor caps at the shard attribute's heavy-hitter share: a skewed
    key pins its rows to one rank, so dividing by the full shard count
    would under-estimate the hot rank.
    """
    if stats is None:
        stats = prep._stats_cache
    budget = DEFAULT_MEMORY_BUDGET if memory_budget is None else memory_budget
    measured_set = {m for m in measured if m}
    dense_msg_k = k if measured_set else 1  # all-COUNT: one scalar einsum
    msg = node_message_bytes(prep)  # 8 bytes/elem estimates
    dense_nodes: dict[str, int] = {}
    sparse_nodes: dict[str, int] = {}
    over_cliff: str | None = None
    for rel, er in prep.encoded.items():
        elems = 1
        for a in er.attrs:
            elems *= prep.dicts[a].size
        if elems > DENSE_PROMOTE_ELEMS and over_cliff is None:
            over_cliff = rel
        msg_f32 = msg[rel] // 2
        tensor_k = k if rel in measured_set else 1
        dense_nodes[rel] = 4 * elems * tensor_k + msg_f32 * dense_msg_k
        edge_bytes = er.codes.nbytes + 4 * k * er.num_rows
        sparse_nodes[rel] = edge_bytes + msg_f32 * k
    choice = PathChoice("dense", "", dense_nodes, sparse_nodes)
    if shards is not None:
        return _distributed_choice(prep, choice, k, msg, shards, stats)
    if stream is not None:
        choice.path = "sparse"
        choice.reason = f"stream tiles over {stream[0]!r} (dense cannot tile)"
    elif over_cliff is not None:
        choice.path = "sparse"
        choice.reason = f"dense tensor for {over_cliff!r} exceeds 2^24 elements"
    elif choice.dense_peak > budget:
        choice.path = "sparse"
        choice.reason = (
            f"dense program needs {choice.dense_peak} B > budget {budget} B"
        )
    elif (sparse := _extreme_sparsity(prep, stats)) is not None:
        choice.path = "sparse"
        choice.reason = (
            f"stats: dense tensor for {sparse[0]!r} is extreme-sparse "
            f"(est occupancy {sparse[1]:.2e})"
        )
    else:
        choice.reason = (
            f"dense program fits ({choice.dense_peak} B ≤ budget {budget} B)"
        )
    return choice


def _distributed_choice(
    prep: Prepared, choice: PathChoice, k: int, msg: dict[str, int], shards: int, stats
) -> PathChoice:
    """``choice`` as the ``distributed-sparse`` path over ``shards``
    shards of the root group attribute, with its per-rank node bytes."""
    from repro_torch.core.distributed import shard_attr

    attr = shard_attr(prep)
    msg_attrs = _node_message_attrs(prep)
    # skew caps the useful divisor: a heavy key's rows all land on one
    # rank, so the hot shard holds at least max_share of the edges
    div = shards
    skew_note = ""
    if stats is not None:
        share = max(
            (stats.max_share(rel, attr) for rel, er in prep.encoded.items()
             if attr in er.attrs),
            default=0.0,
        )
        if share > 0.0:
            div = min(shards, max(1, int(1.0 / share)))
            if div < shards:
                skew_note = (
                    f"; skew-capped divisor {div} (top share {share:.2f} of {attr!r})"
                )
    per_dev: dict[str, int] = {}
    for rel, er in prep.encoded.items():
        edge_bytes = er.codes.nbytes + 4 * k * er.num_rows
        if attr in er.attrs:
            edge_bytes //= div
        msg_f32 = (msg[rel] // 2) * k
        if attr in msg_attrs[rel]:
            msg_f32 //= div
        per_dev[rel] = edge_bytes + msg_f32
    choice.path = "distributed-sparse"
    choice.shards = shards
    choice.per_device_node_bytes = per_dev
    choice.reason = (
        f"mesh over {shards} shard(s) of {attr!r} on the data axis "
        "(dense einsum is retired on meshes)" + skew_note
    )
    return choice


# dense tensors this large with occupancy this low waste both the
# materialization and the einsum FLOPs; the CSR program touches only edges
SPARSITY_MIN_ELEMS = 1 << 20
SPARSITY_MAX_OCCUPANCY = 1e-3


def _extreme_sparsity(prep: Prepared, stats) -> tuple[str, float] | None:
    """Largest relation whose dense tensor's estimated occupancy (weighted
    rows / dense cells) is below ``SPARSITY_MAX_OCCUPANCY`` — ``None``
    when statistics are absent or no tensor qualifies."""
    if stats is None:
        return None
    worst: tuple[str, float] | None = None
    for rel, er in prep.encoded.items():
        elems = 1
        for a in er.attrs:
            elems *= prep.dicts[a].size
        if elems < SPARSITY_MIN_ELEMS:
            continue
        rs = stats.relations.get(rel)
        rows = rs.rows if rs is not None else er.num_rows
        occ = max(rows, 1) / elems
        if occ < SPARSITY_MAX_OCCUPANCY and (worst is None or occ < worst[1]):
            worst = (rel, occ)
    return worst
