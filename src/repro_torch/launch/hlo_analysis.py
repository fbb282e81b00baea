"""No HLO here: one recorded call of a cell, counted by the ops it
dispatched and the collectives it made.

Port of the JAX package's ``launch/hlo_analysis.py``.  The reference
parses a compiled HLO module's text, builds its call graph and scales each
computation's dot FLOPs, materialised bytes and collectives by how often
the module runs it (while-loop trip counts).  The port has no HLO.  Eager
PyTorch dispatches every op each time it runs (every layer, every
attention chunk, every recompute of a checkpointed layer), so what a call
dispatches is trip-count-aware by construction.  :func:`analyze` runs
``fn(*args)`` once under :class:`CallCounter`, a ``TorchDispatchMode``,
and ``launch/mesh.py:recording``, on fake tensors (``launch/dryrun.py``)
or on real ones on the CPU or the card, and returns the reference's keys:

* ``dot_flops``: the matmul-family FLOPs of every op the call ran (``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, convolutions, the attention kernels;
  ``einsum`` reaches them as ``bmm``), by ``torch.utils.flop_counter``'s
  formulas;
* ``hbm_bytes``: 2 × the bytes of every op output that lands in memory: a
  fresh tensor or one written in place; views and other aliases of an
  input are left out (the eager counterpart of the reference's
  ``_MATERIALIZING_OPS``: eager fuses nothing, so every other op counts);
* ``collective_bytes``, ``collectives_by_kind`` (``{bytes, count}``),
  ``collectives_detail`` (by kind, group size, axis and member span),
  ``top_collectives`` (the 12 largest) and ``collectives``: from the
  recorder, each call once (``mult`` 1);
* ``memory``: ``argument_size_in_bytes`` (the caller's count of what the
  rank holds when the call starts: its parameter, optimizer and input
  blocks), ``output_size_in_bytes`` (the tensors ``fn`` returns; a cache
  written in place counts again, as a donated buffer does in XLA's) and
  ``temp_size_in_bytes``: the peak of the bytes of the storages the call
  made that were alive at once, outputs included, each freed when its
  storage's finalizer runs (the method of torch's private
  ``torch.distributed._tools.mem_tracker``, kept here in small).  It does
  not see the caching allocator's rounding or a library's workspace.

No counterpart: ``generated_code_size_in_bytes``, XLA's
``flops_cost_analysis`` and ``bytes_accessed_cost_analysis``, and the
module parser (``parse_module``, ``Computation``, the call graph's
multipliers).
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.mesh import recording

TOP = 12


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CallCounter(TorchDispatchMode):
    """Counts what the ops dispatched under it do: ``dot_flops``,
    ``hbm_bytes``, the bytes of the storages they made that are alive
    (``live``) and the most alive at once (``peak``); with ``keep_ops``,
    one line per op in ``ops`` (its name, output shapes, FLOPs, bytes)."""

    def __init__(self, keep_ops: bool = False):
        super().__init__()
        self.dot_flops = 0.0
        self.hbm_bytes = 0.0
        self.live = 0
        self.peak = 0
        self.ops: list[dict] | None = [] if keep_ops else None
        self._made: dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._made.pop(key)

    def _made_here(self, st) -> None:
        key = st._cdata
        if key in self._made:
            return
        self._made[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flops = 0
        if func.overloadpacket in flop_registry:
            flops = flop_registry[func.overloadpacket](*args, **kwargs, out_val=out)
            self.dot_flops += flops
        returns = func._schema.returns
        values = out if len(returns) > 1 else (out,)
        written, inputs = 0, None
        for ret, value in zip(returns, values):
            alias = ret.alias_info
            if alias is not None and not alias.is_write:
                continue  # a view of an input
            for t in tree_flatten(value)[0]:
                if not isinstance(t, torch.Tensor):
                    continue
                if alias is None:
                    # a fresh output, unless it shares an input's storage
                    # unannotated (``_unsafe_view``): then a view
                    if inputs is None:
                        inputs = {x.untyped_storage()._cdata
                                  for x in tree_flatten((args, kwargs))[0]
                                  if isinstance(x, torch.Tensor)}
                    st = t.untyped_storage()
                    if st._cdata in inputs:
                        continue
                    self._made_here(st)
                written += _nbytes(t)
        self.hbm_bytes += 2 * written
        if self.ops is not None:
            self.ops.append({"op": str(func), "out": [
                [list(t.shape), str(t.dtype).removeprefix("torch.")]
                for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)],
                "flops": flops, "bytes": written})
        return out


def collectives_of(log: list[dict]) -> list[dict]:
    """The recorder's entries as the reference's collective records: kind,
    result bytes on this rank, group size, ``mult`` (each call once), and
    the group's axes and member span."""
    return [{"kind": e["kind"], "bytes": e["bytes"], "group": e["group"], "mult": 1,
             "axes": list(e["axes"]), "ranks": list(e["ranks"])} for e in log]


def analyze(fn, args: tuple, arguments: dict[str, int], keep_ops: bool = False):
    """Runs ``fn(*args)`` once, counting it (module docstring); returns
    (its result, the analysis).  ``arguments``: the bytes of each block
    the rank holds when the call starts, by name."""
    counter = CallCounter(keep_ops)
    with recording() as log, counter:
        out = fn(*args)
    colls = collectives_of(log)
    by_kind: dict[str, dict] = {}
    detail: dict[tuple, dict] = {}
    for c in colls:
        e = by_kind.setdefault(c["kind"], {"bytes": 0.0, "count": 0.0})
        e["bytes"] += c["bytes"]
        e["count"] += c["mult"]
        key = (c["kind"], c["group"], tuple(c["axes"]), tuple(c["ranks"]))
        d = detail.setdefault(key, {"kind": c["kind"], "group": c["group"], "axes": c["axes"],
                                    "ranks": c["ranks"], "bytes": 0.0, "count": 0})
        d["bytes"] += c["bytes"]
        d["count"] += 1
    outputs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    result = {
        "dot_flops": counter.dot_flops,
        "hbm_bytes": counter.hbm_bytes,
        "top_collectives": sorted(colls, key=lambda c: -c["bytes"])[:TOP],
        "collective_bytes": float(sum(c["bytes"] for c in colls)),
        "collectives_by_kind": by_kind,
        "collectives": colls,
        "collectives_detail": [detail[k] for k in sorted(detail)],
        "memory": {
            "argument_size_in_bytes": int(sum(arguments.values())),
            "output_size_in_bytes": int(sum(map(_nbytes, outputs))),
            "temp_size_in_bytes": int(counter.peak),
        },
    }
    if keep_ops:
        result["ops"] = counter.ops
    return out, result
