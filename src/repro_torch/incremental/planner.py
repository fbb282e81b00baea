"""Message cache + dirty-path planner on the card (DESIGN.md §4).

The decomposition tree localizes change: a delta in relation ``r`` only
invalidates the messages on the path from ``r`` to the root — every
other subtree message is reused verbatim.  For the distributive
semiring aggregates (COUNT/SUM, and AVG as a SUM/COUNT pair) the
contraction is *multilinear* in each relation's weight vector, so

    msg' = msg ⊕ Δmsg

where ``Δmsg`` is computed by contracting only the delta rows (at the
dirty relation) or only the parent rows that match the delta's support
(at each ancestor hop).  The support of a delta message — the nonzero
slice keys along its shared-with-parent axes — shrinks the rows an
ancestor must rescan.

Port of the JAX package's ``incremental/planner.py`` onto the port's
engine.  The cached messages are float32 tensors on the engine's device
(with the channel engine's trailing channel axis of 1), built by one
leaves→root kernel pass, and the ⊕ is an in-place add there; the support
and the rescan mask are computed on the card too.  What the host must
see — whether a delta message is all zero, and which parent rows it
reaches — is one device→host read each per hop, counted in
:attr:`MessageCache.host_reads`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.prepare import Prepared
from repro_torch.core.tensor_engine import Message, ravel_columns
from repro_torch.incremental.torch_delta import KernelDeltaEngine


class _RecordingEngine(KernelDeltaEngine):
    """Kernel engine that records every subtree message into a cache."""

    def __init__(self, *args, cache: dict[str, Message], **kwargs):
        super().__init__(*args, **kwargs)
        self._cache = cache

    def message(self, rel: str, parent: str | None) -> Message:
        msg = super().message(rel, parent)
        self._cache[rel] = msg
        return msg


class MessageCache:
    """Every subtree message of one contraction tree, kept up to date by
    delta propagation along dirty root-paths.

    ``measure_rel`` switches the cached tree to SUM semantics (that
    relation's weight vector is its live ``sum`` payload, as
    :func:`~repro_torch.core.tensor_engine.channel_weight_matrices`
    lays it out); ``None`` means COUNT.  Messages live on ``device``.
    """

    def __init__(self, prep: Prepared, measure_rel: str | None = None, device="cuda"):
        self.prep = prep
        self.measure_rel = measure_rel
        self.device = torch.device(device)
        self.msgs: dict[str, Message] = {}
        self.peak_delta_bytes = 0
        self.rows_rescanned = 0
        self.host_reads = 0  # device→host reads on the dirty paths
        self.build()

    def _engine(self, recording: bool = False) -> KernelDeltaEngine:
        if recording:
            return _RecordingEngine(
                self.prep, self.measure_rel, self.device, cache=self.msgs
            )
        return KernelDeltaEngine(self.prep, self.measure_rel, self.device)

    # --- full build / domain growth ---------------------------------
    def build(self) -> torch.Tensor:
        """Full leaves→root pass on the card; (re)fills the cache."""
        self.msgs.clear()
        self._engine(recording=True).run()
        return self.root_array

    @property
    def root_array(self) -> torch.Tensor:
        """The result over the canonical group axes, on the device."""
        return self.msgs[self.prep.decomposition.root].array[..., 0]

    def _dims(self, attrs: tuple[str, ...]) -> tuple[int, ...]:
        return tuple(self.prep.dicts[a].size for a in attrs)

    def sync_domains(self) -> None:
        """Zero-pad cached messages after dictionary growth (new codes
        append, so existing entries keep their positions)."""
        for msg in self.msgs.values():
            target = self._dims(msg.attrs) + (1,)
            if tuple(msg.array.shape) != target:
                grown = msg.array.new_zeros(target)
                grown[tuple(slice(0, s) for s in msg.array.shape)] = msg.array
                msg.array = grown

    # --- delta propagation -------------------------------------------
    def _charge(self, nbytes: int) -> None:
        self.peak_delta_bytes = max(self.peak_delta_bytes, nbytes)

    def _read(self, t: torch.Tensor):
        """``t`` on the host: a device→host read, counted."""
        self.host_reads += 1
        return t.cpu().numpy()

    def _select_rows(self, eng: KernelDeltaEngine, parent: str, dmsg: Message):
        """The parent's rows that can see ``dmsg``'s support (the nonzero
        keys of its shared-with-parent axes), as a block in the parent
        view's grouped-CSR order with their weights; None when no row
        does."""
        pnode = self.prep.decomposition.nodes[parent]
        view = eng.hop_view(parent, pnode.parent)
        weights = eng._weights(parent, view)
        shared = dmsg.attrs[: dmsg.num_shared]
        if not shared:
            mask = torch.ones(view.keys.shape[0], dtype=torch.bool, device=eng.device)
            return eng.masked_block(view, weights, mask, np.ones(len(mask), bool))
        sh_dims = self._dims(shared)
        flat = dmsg.array.reshape(math.prod(sh_dims), -1)
        support = (flat != 0).any(dim=1)
        ep = self.prep.encoded[parent]
        keys = ravel_columns(view.codes, [ep.attrs.index(a) for a in shared], sh_dims)
        mask = support[keys]
        mask_host = self._read(mask)
        if not mask_host.any():
            return None
        return eng.masked_block(view, weights, mask, mask_host)

    def propagate(
        self, rel: str, d_codes: np.ndarray, d_weights: np.ndarray
    ) -> torch.Tensor | None:
        """Apply a delta at ``rel`` (COO rows in the relation's attr
        layout, signed float weights) to every cached message on the
        path to the root.  Returns the root-array delta (dense, canonical
        group axes, on the device) or ``None`` if the delta annihilated
        before the root.
        """
        deco = self.prep.decomposition
        eng = self._engine()
        node = deco.nodes[rel]
        child_msgs = {c: self.msgs[c] for c in node.children}
        block, w = eng.delta_block(rel, node.parent, d_codes, d_weights)
        dmsg = eng.contract_rows(rel, node.parent, block, w, child_msgs)
        self._charge(d_codes.nbytes + 4 * dmsg.array.numel())
        cur = rel
        while True:
            cached = self.msgs[cur]
            if dmsg.attrs != cached.attrs:
                raise AssertionError((dmsg.attrs, cached.attrs))
            cached.array += dmsg.array  # ⊕ on the card, in place
            parent = deco.nodes[cur].parent
            if parent is None:
                return dmsg.array[..., 0]
            if not self._read(dmsg.array.any()):
                return None
            sel = self._select_rows(eng, parent, dmsg)
            if sel is None:
                return None
            block, w = sel
            self.rows_rescanned += len(block.keys_host)
            pnode = deco.nodes[parent]
            cmsgs = {c: self.msgs[c] for c in pnode.children}
            cmsgs[cur] = dmsg
            dmsg = eng.contract_rows(parent, pnode.parent, block, w, cmsgs)
            self._charge(8 * block.codes.numel() + 4 * dmsg.array.numel())
            cur = parent
