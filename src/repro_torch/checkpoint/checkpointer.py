"""Checkpoints with async writes and device-placed restore, in the
reference's on-disk layout.

Layout (atomic: written to ``<dir>/tmp-<step>`` then renamed):

  <dir>/step-<n>/
    manifest.json   — tree structure, shapes, dtypes, step, user metadata
    <flat-key>.npy  — one array per leaf

A leaf's flat key is its path in the tree, the parts joined by ``::`` —
a dict's key, a named tuple's field name, a sequence's index — which is
how the reference names the leaves of its pytrees.  So a tree of the same
structure (the trainer saves ``(params, OptState(step, mu, nu))`` in the
reference's stacked layout) is written under the same file names by both
packages, and each restores the other's checkpoint.  ``manifest.json``'s
``treedef`` is a description only; neither package reads it back.

Async mode snapshots leaves to host memory on the caller's thread (a
device→host copy), then a writer thread persists them, so a save overlaps
the next training steps.  Deliberate difference from the reference,
whose writer is a daemon thread that lives as long as the process: the
port's writer is started by a save, exits when no save is pending, and
:meth:`CheckpointManager.wait` joins it, so no thread outlives ``wait()``
or a training run.  ``restore(device=...)`` places the leaves on a device
as tensors: the port's counterpart of the reference's elastic
``shardings=``.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointManager"]

_SEP = "::"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix=()) -> List[Tuple[str, Any]]:
    """(flat key, leaf) pairs in the reference's order: dict keys sorted,
    named tuples by field, sequences by index."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(_SEP.join(prefix), tree)]
    out = []
    for key, sub in items:
        out.extend(_flatten(sub, prefix + (key,)))
    return out


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in :func:`_flatten`'s
    order, by the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _describe(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={_describe(v)}" for f, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (list, tuple)):
        return "(" + ", ".join(_describe(v) for v in tree) + ")"
    return "*"


def _host_copy(leaf) -> np.ndarray:
    """A host snapshot that later in-place updates of ``leaf`` cannot
    reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_writes: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_writes = async_writes
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: collections.deque = collections.deque()
        self._errors: List[Exception] = []
        self._thread: Optional[threading.Thread] = None
        self._running = False  # a writer is draining ``_pending``

    # -- public API ----------------------------------------------------------
    def save(self, step: int, tree, metadata: Optional[Dict] = None) -> None:
        """Snapshot now; persist (possibly) later."""
        flat = [(k, _host_copy(v)) for k, v in _flatten(tree)]
        job = (step, flat, _describe(tree), metadata or {})
        if not self.async_writes:
            self._write(job)
            return
        with self._lock:
            self._pending.append(job)
            if not self._running:
                self._running = True
                self._thread = threading.Thread(
                    target=self._writer, name="checkpoint-writer")
                self._thread.start()

    def wait(self) -> None:
        """Block until pending async writes are durable; the writer thread
        has exited when this returns."""
        while True:
            with self._lock:
                thread = self._thread
            if thread is None:
                break
            thread.join()
            with self._lock:  # a save may have started another writer
                if self._thread is thread:
                    self._thread = None
        if self._errors:
            raise self._errors[0]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step-"):
                out.append(int(name.split("-", 1)[1]))
        return sorted(out)

    def restore(self, step: Optional[int] = None, template=None, device=None):
        """Load a checkpoint into ``template``'s structure (any tree of the
        saved structure; its leaves are not read).  Leaves come back as
        numpy arrays, or as tensors on ``device`` when it is given.
        Returns ``(tree, metadata)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = os.path.join(self.directory, f"step-{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if template is None:
            raise ValueError("pass template= (a tree of the saved structure)")
        leaves = []
        for key, _ in _flatten(template):
            arr = np.load(os.path.join(path, _fname(key)))
            if device is not None:
                arr = torch.from_numpy(arr).to(device)
            leaves.append(arr)
        return _unflatten(template, iter(leaves)), manifest["metadata"]

    # -- internals ---------------------------------------------------------------
    def _write(self, job) -> None:
        step, flat, treedef_str, metadata = job
        tmp = os.path.join(self.directory, f"tmp-{step}")
        final = os.path.join(self.directory, f"step-{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "treedef": treedef_str,
            "metadata": metadata,
            "leaves": {},
        }
        for key, arr in flat:
            manifest["leaves"][key] = {
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
            }
            np.save(os.path.join(tmp, _fname(key)), arr)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step-{s}"),
                          ignore_errors=True)

    def _writer(self) -> None:
        """Write the pending jobs in order; exit when none is left."""
        while True:
            with self._lock:
                if not self._pending:
                    self._running = False
                    return
                job = self._pending.popleft()
            try:
                self._write(job)
            except Exception as e:  # noqa: BLE001 — surfaced by wait()
                self._errors.append(e)


def _fname(key: str) -> str:
    safe = key.replace(_SEP, "__").replace("/", "_")
    return f"{safe}.npy"
