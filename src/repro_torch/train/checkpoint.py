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
raised.  On a mesh (``launch/mesh.py``) a tree of this rank's blocks is
saved with ``shardings=``: each leaf is gathered whole and rank 0 alone
writes the same layout while the other ranks wait, so the directory
does not depend on the mesh.  ``restore(shardings=)`` gives each rank
its block of every leaf, as ``fault_tolerance.elastic_reshard`` does, on
any mesh (grow or shrink between runs).
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.launch.mesh import all_reduce
from repro_torch.launch.sharding import gather, shard_of


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


def _shardings(tree) -> list:
    """The leaves of a tree of ``NamedSharding``s, a ``None`` among them a
    leaf (a whole leaf, as ``jax.tree.leaves(..., is_leaf=...)`` keeps it)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _shardings(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _shardings(t)]
    return [tree]


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
    def save(self, step: int, tree, blocking: bool = False, shardings=None) -> None:
        """Writes ``tree`` as ``step_<step>``.  With ``shardings`` (``tree``'s
        structure of ``NamedSharding``s, None at a whole leaf) ``tree`` holds
        this rank's blocks and every rank of the mesh calls it: each leaf
        is gathered whole, rank 0 writes it before it returns, and the
        others return when it has."""
        self.wait()
        treedef = f"PyTreeDef({_treedef(tree)})"
        if shardings is not None:
            flat, specs = _flatten(tree), _shardings(shardings)
            mesh = next(sh.mesh for sh in specs if sh is not None)
            lead = all(c == 0 for c in mesh.coords.values())
            named = []
            for (p, x), sh in zip(flat, specs, strict=True):
                whole = x if sh is None else gather(x, sh.spec, sh.mesh)
                if lead:
                    named.append((_leaf_name(p), _host(whole)))
                del whole
            failed = None
            if lead:
                try:
                    self._write(step, named, treedef)
                except Exception as e:  # noqa: BLE001 -- raised after the others are released
                    failed = e
            # the others wait until rank 0 has written
            all_reduce(torch.zeros(1, device=mesh.device), mesh.group)
            if failed is not None:
                raise failed
            return
        # on the host now; training goes on while the thread writes
        named = [(_leaf_name(p), _host(x)) for p, x in _flatten(tree)]
        if blocking:
            self._write(step, named, treedef)
            return

        def run():
            try:
                self._write(step, named, treedef)
            except Exception as e:  # noqa: BLE001 -- re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _write(self, step: int, named: list, treedef: str) -> None:
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

    def restore(self, template, step: int | None = None, shardings=None):
        """Rebuild ``template``'s structure from ``step`` (the latest by
        default): tensor leaves come back as tensors on the template leaf's
        device, in the dtype saved; other leaves as numpy arrays.  With
        ``shardings`` (``template``'s structure of ``NamedSharding``s, None
        at a whole leaf) a leaf comes back as this rank's block on its
        mesh's device, which must have the template leaf's shape.  Returns
        (tree, step)."""
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        step = step if step is not None else steps[-1]
        d = os.path.join(self.dir, f"step_{step}")
        flat = _flatten(template)
        specs = _shardings(shardings) if shardings is not None else [None] * len(flat)
        leaves = []
        for (path, tmpl), sh in zip(flat, specs, strict=True):
            name = _leaf_name(path)
            arr = np.load(os.path.join(d, name + ".npy"))
            want = tuple(tmpl.shape) if hasattr(tmpl, "shape") else np.shape(tmpl)
            if sh is not None:
                arr = shard_of(arr, sh.spec, sh.mesh).to(sh.mesh.device)
            if tuple(arr.shape) != want:
                raise ValueError(f"checkpoint leaf {name} has shape {tuple(arr.shape)}"
                                 + (f" on this rank of {sh.mesh}" if sh is not None else "")
                                 + f", the template {want}")
            if isinstance(tmpl, torch.Tensor) and sh is None:
                arr = torch.from_numpy(arr).to(tmpl.device)
            leaves.append(arr)
        return _unflatten(template, iter(leaves)), step
