"""The leaves→root walk of the JOIN-AGG contraction, on torch tensors.

The data graph's edge multiplicities are sparse *multiplicity tensors*
``T_r[attrs...] = #tuples``; the paper's traversal + prefix-join is a
sum-product contraction of those tensors along the query decomposition
tree with group attributes kept and join attributes contracted (see
DESIGN.md §2).  Messages flow leaves -> root; each message's axes are the
attrs shared with the parent plus every group attribute in the subtree —
the exact analogue of the paper's c-pair lists.

Port of the walk in the JAX package's ``core/tensor_engine.py``
(``Message``, ``TensorEngine.contract_rows``/``message``/``run``,
``ChannelTensorEngine``, ``channel_weight_matrices``,
``_decode_result``).  Here every hop reads its relation through a
device-resident grouped-CSR view keyed on the hop's output key, and
every message is a tensor on the engine's device; the subclasses in
``torch_engine.py`` supply the views, the weights and the hop itself
(:meth:`TensorEngine._contract_block`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.prepare import Prepared


@dataclass
class Message:
    attrs: tuple[str, ...]  # shared-with-parent attrs, then group attrs
    num_shared: int
    array: torch.Tensor  # shape = domains(attrs) + channel axes, contiguous

    @property
    def group_attrs(self) -> tuple[str, ...]:
        return self.attrs[self.num_shared:]


def ravel_columns(
    codes: torch.Tensor, cols: list[int], dims: tuple[int, ...]
) -> torch.Tensor:
    """Row-major composite key over columns ``cols`` of a code matrix
    (``np.ravel_multi_index`` as integer arithmetic on a tensor)."""
    if not cols:
        return torch.zeros(codes.shape[0], dtype=torch.int64, device=codes.device)
    key = codes[:, cols[0]]
    for c, d in zip(cols[1:], dims[1:]):
        key = key * d + codes[:, c]
    return key.contiguous()


class TensorEngine:
    """One leaves→root pass over the decomposition tree.

    Subclasses provide :meth:`_view` (the relation's rows in grouped-CSR
    order on the device), :meth:`_weights` (its per-edge semiring
    payload in that order) and :meth:`_contract_block` (the hop).
    """

    # trailing axes carried unchanged through every message: () for a
    # scalar semiring, (k,) for the k-channel subclass below
    _chan: tuple[int, ...] = ()

    def __init__(
        self,
        prep: Prepared,
        device: torch.device,
        domains: dict[str, int] | None = None,
        encoded=None,
    ):
        self.prep = prep
        self.deco = prep.decomposition
        self.device = torch.device(device)
        self.encoded = encoded if encoded is not None else prep.encoded
        self.domains = domains or {a: prep.dicts[a].size for a in prep.dicts}
        # canonical group-attr order = query group-by order
        self.canonical = [attr for _, attr in prep.group_attrs]

    def _dims(self, attrs: tuple[str, ...]) -> tuple[int, ...]:
        return tuple(self.domains[a] for a in attrs)

    def _canon_sort(self, gattrs: list[str]) -> list[str]:
        return sorted(gattrs, key=self.canonical.index)

    def _hop_key_attrs(self, rel: str, parent: str | None) -> tuple[str, ...]:
        """The hop's output key: attrs shared with the parent, then the
        relation's own group attribute."""
        er = self.encoded[rel]
        own_g = self.prep.schema.group_of.get(rel)
        up: tuple[str, ...] = ()
        if parent is not None:
            up = tuple(sorted(set(er.attrs) & set(self.encoded[parent].attrs)))
        return up + ((own_g,) if own_g else ())

    def _view(self, rel: str, key_attrs: tuple[str, ...]):
        raise NotImplementedError

    def _weights(self, rel: str, view):
        raise NotImplementedError

    def _contract_block(self, weights, gathers, view, knum: int) -> torch.Tensor:
        """``out[keys[i]] ⊕= w[i] ⊗ Π_c m2_c[idx_c[i]]`` (outer product
        over the children's group axes) into ``(knum, width, *chan)``,
        or the same elements in that order with the trailing axes
        flattened."""
        raise NotImplementedError

    def contract_rows(self, rel: str, parent: str | None, view, weights, child_msgs):
        """Contract ``rel``'s rows (``view``, in grouped-CSR order of the
        hop's output key) against ``child_msgs``.  Children are consumed
        in decomposition order, then the output axes are permuted to
        ``up attrs + group attrs in canonical order``."""
        er = self.encoded[rel]
        node = self.deco.nodes[rel]

        gathers: list[tuple[torch.Tensor, torch.Tensor]] = []  # (child m2, row idx)
        child_gattrs: list[str] = []
        for child in node.children:
            msg = child_msgs[child]
            shared = msg.attrs[: msg.num_shared]
            pos = [er.attrs.index(a) for a in shared]
            sh_dims = self._dims(shared)
            g_dims = self._dims(msg.group_attrs)
            m2 = msg.array.reshape((math.prod(sh_dims), math.prod(g_dims)) + self._chan)
            gathers.append((m2, ravel_columns(view.codes, pos, sh_dims)))
            child_gattrs.extend(msg.group_attrs)

        own_g = self.prep.schema.group_of.get(rel)
        kept_own = self._hop_key_attrs(rel, parent)
        up_attrs = kept_own[: len(kept_own) - (1 if own_g else 0)]
        kept_dims = self._dims(kept_own)
        out2 = self._contract_block(weights, gathers, view, math.prod(kept_dims))

        # assemble axes: up_attrs, then group attrs in canonical order
        # (any trailing channel axes stay last)
        gattrs = ([own_g] if own_g else []) + child_gattrs
        raw_attrs = list(kept_own) + child_gattrs
        arr = out2.reshape(kept_dims + self._dims(tuple(child_gattrs)) + self._chan)
        want = list(up_attrs) + self._canon_sort(gattrs)
        perm = [raw_attrs.index(a) for a in want]
        perm += list(range(len(raw_attrs), arr.ndim))
        if perm != list(range(len(perm))):
            arr = arr.permute(perm).contiguous()
        return Message(tuple(want), len(up_attrs), arr)

    def message(self, rel: str, parent: str | None) -> Message:
        """Compute the upward message of ``rel``'s subtree."""
        child_msgs = {
            child: self.message(child, rel)
            for child in self.deco.nodes[rel].children
        }
        view = self._view(rel, self._hop_key_attrs(rel, parent))
        return self.contract_rows(
            rel, parent, view, self._weights(rel, view), child_msgs
        )

    def run(self) -> torch.Tensor:
        """Dense result tensor over canonical group axes (+ channel axes)."""
        msg = self.message(self.deco.root, None)
        if msg.attrs != tuple(self.canonical):
            raise AssertionError((msg.attrs, self.canonical))
        return msg.array


class ChannelTensorEngine(TensorEngine):
    """``k`` semiring channels contracted in one leaves→root pass.

    Weight vectors become ``(n, k)`` matrices — column ``c`` is channel
    ``c``'s weight for that relation (its multiplicity, or a measure
    payload; see :func:`channel_weight_matrices`) — and every message
    carries a trailing channel axis.  Per channel the float operations
    run in the same order as a scalar pass with that channel's weights,
    so one k-channel pass equals k scalar passes (DESIGN.md §6).
    """

    def __init__(
        self,
        prep: Prepared,
        channel_measures: tuple[str | None, ...],
        device: torch.device,
        domains: dict[str, int] | None = None,
        encoded=None,
    ):
        super().__init__(prep, device, domains, encoded)
        self.channel_measures = tuple(channel_measures)
        self.k = len(self.channel_measures)
        self._chan = (self.k,)

    def _host_weights(self, rel: str) -> np.ndarray:
        """``rel``'s ``(n, k)`` channel weights in encoded-row order."""
        over = channel_weight_matrices({rel: self.encoded[rel]}, self.channel_measures)
        if rel in over:
            return over[rel]
        c = self.encoded[rel].count.astype(np.float64)
        return np.repeat(c[:, None], self.k, axis=1)


def channel_weight_matrices(
    encoded, channel_measures, dtype=np.float64
) -> dict[str, np.ndarray]:
    """Per-relation (n, k) weight matrices for the measure relations among
    ``encoded``: column c carries the ``sum`` payload where channel c
    measures that relation, its multiplicity everywhere else.
    ``channel_measures[c]`` names channel c's measure relation (None =
    COUNT)."""
    over: dict[str, np.ndarray] = {}
    for rel in {r for r in channel_measures if r is not None and r in encoded}:
        er = encoded[rel]
        cols = [
            er.payloads["sum"] if m == rel else er.count
            for m in channel_measures
        ]
        over[rel] = np.stack([np.asarray(c, dtype) for c in cols], axis=1)
    return over


def _decode_result(
    prep: Prepared, arr: torch.Tensor, support: torch.Tensor | None = None
) -> dict[tuple, float]:
    """``{group values: value}`` over the ``support`` cells (default: the
    nonzero ones) of a dense group-axes result on any device."""
    support = arr != 0 if support is None else support
    idx = torch.nonzero(support).cpu().numpy()
    vals = arr[support].cpu().numpy()
    cols = [
        prep.dicts[attr].decode(idx[:, i])
        for i, (_, attr) in enumerate(prep.group_attrs)
    ]
    return {tuple(c[i] for c in cols): float(v) for i, v in enumerate(vals)}
