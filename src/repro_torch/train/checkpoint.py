"""Asynchronous, atomic checkpoints in the JAX package's on-disk layout.

Port of the JAX package's ``train/checkpoint.py``.  Layout:
``<dir>/step_<n>/{manifest.json, <leaf>.npy ...}``, one ``.npy`` a leaf,
named by the leaf's path in the tree (``0__layers__attn__wq__w`` for
``tree[0]["layers"]["attn"]["wq"]["w"]``), written into
``<dir>/.tmp_step_<n>`` and renamed, and older steps than the last
``keep_last`` removed.  A tree is nested dicts (keys sorted, as JAX
orders them), lists and tuples of tensors or arrays, so a step directory
written by either package restores into the other.

``save`` copies every leaf to the host before it returns and writes on
a background thread; ``wait()`` joins it and raises what the writer
raised.  The reference saves each process's addressable shards and
``restore`` can place leaves on a mesh: that waits for the mesh slice.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch


def _leaf_name(path) -> str:
    return "__".join(str(p) for p in path) or "leaf"


def _flatten(tree, path=()) -> list:
    """(path, leaf) pairs in JAX's order; ``None`` holds no leaf."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree) for kv in _flatten(t, path + (i,))]
    if tree is None:
        return []
    return [(path, tree)]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(t, leaves) for t in template)
    if template is None:
        return None
    return next(leaves)


def _treedef(tree) -> str:
    """The structure as JAX prints a ``PyTreeDef`` (the manifest's
    ``treedef``, which ``restore`` does not read)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_treedef(t) for t in tree)
        if isinstance(tree, list):
            return f"[{inner}]"
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "None" if tree is None else "*"


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


class Checkpointer:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = str(directory)
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(self.dir, exist_ok=True)

    # ------------------------------------------------------------ save
    def save(self, step: int, tree, blocking: bool = False) -> None:
        self.wait()
        # on the host now; training goes on while the thread writes
        named = [(_leaf_name(p), _host(x)) for p, x in _flatten(tree)]
        treedef = f"PyTreeDef({_treedef(tree)})"

        def write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "leaves": []}
            for name, arr in named:
                np.save(os.path.join(tmp, name + ".npy"), arr)
                manifest["leaves"].append(
                    {"name": name, "shape": list(arr.shape), "dtype": str(arr.dtype)}
                )
            manifest["treedef"] = treedef
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            write()
            return

        def run():
            try:
                write()
            except Exception as e:  # noqa: BLE001 -- re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Joins the writer thread; raises what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # --------------------------------------------------------- restore
    def steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def restore(self, template, step: int | None = None):
        """Rebuild ``template``'s structure from ``step`` (the latest by
        default): tensor leaves come back as tensors on the template leaf's
        device, in the dtype saved; other leaves as numpy arrays.  Returns
        (tree, step)."""
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        step = step if step is not None else steps[-1]
        d = os.path.join(self.dir, f"step_{step}")
        leaves = []
        for path, tmpl in _flatten(template):
            name = _leaf_name(path)
            arr = np.load(os.path.join(d, name + ".npy"))
            want = tuple(tmpl.shape) if hasattr(tmpl, "shape") else np.shape(tmpl)
            if arr.shape != want:
                raise ValueError(f"checkpoint leaf {name} has shape {arr.shape}, "
                                 f"the template {want}")
            if isinstance(tmpl, torch.Tensor):
                arr = torch.from_numpy(arr).to(tmpl.device)
            leaves.append(arr)
        return _unflatten(template, iter(leaves)), step
