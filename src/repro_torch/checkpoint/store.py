"""Atomic, versioned, async-capable checkpointing.

Port of ``repro.checkpoint.store`` with the same on-disk layout, so a
checkpoint written by either package restores in the other::

    <dir>/step_000000123/
        shard_00000.npz       # the leaves, flattened: leaf_0, leaf_1, ...
        meta.json             # step, n_leaves, treedef token, extra state
        COMMIT                # written last — a step without it is garbage

* **Atomic** — writers stage into ``step_….tmp`` and ``os.rename`` it into
  place after the COMMIT marker is inside; readers ignore uncommitted or
  partial steps, so a crash mid-save can never corrupt restore.
* **Versioned** — the ``keep`` most recent committed steps are retained.
* **Async** — :meth:`CheckpointStore.save_async` snapshots to host memory
  before it returns (the device→host copies done), then writes in a
  background thread; :meth:`CheckpointStore.wait` joins before the next
  save and re-raises a failed write.

The port has no pytrees.  A tree here is nested dicts (sorted keys),
lists and tuples over leaves — torch tensors or numpy arrays — flattened
in ``jax.tree_util``'s order, and :func:`treedef_token` renders the string
``str(jax.tree_util.tree_structure(tree))`` gives for it.

The snapshot copies card tensors into page-locked host buffers, allocated
at the first save and reused by every later one of the same leaf shapes;
the writer thread runs ``np.savez`` from numpy views of them.  Leaves on
the CPU are copied into plain host buffers the same way.  A save waits for
the previous write first, so a buffer is never overwritten while the
writer still reads it.  ``CheckpointStore.stats`` (:class:`CheckpointStats`)
records each save's stall, snapshot and write on the host clock.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree) -> Tuple[List[Any], str]:
    """Leaves in ``jax.tree_util`` order and the tree's token."""
    leaves: List[Any] = []

    def rec(node) -> str:
        if isinstance(node, dict):
            keys = sorted(node)
            return "{" + ", ".join(f"{k!r}: {rec(node[k])}"
                                   for k in keys) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(rec(c) for c in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(rec(c) for c in node)
            return "(" + inner + ("," if len(node) == 1 else "") + ")"
        leaves.append(node)
        return "*"

    token = f"PyTreeDef({rec(tree)})"
    return leaves, token


def _unflatten(tree_like, leaves: List[Any]):
    """``tree_like``'s structure with ``leaves`` in flattening order."""
    it = iter(leaves)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [rec(c) for c in node]
        if isinstance(node, tuple):
            return tuple(rec(c) for c in node)
        return next(it)

    return rec(tree_like)


def treedef_token(tree) -> str:
    """The tree's structure as ``str(jax.tree_util.tree_structure(tree))``
    renders it (the ``treedef`` of ``meta.json``)."""
    return _flatten(tree)[1]


def _shape_dtype(leaf) -> Tuple[Tuple[int, ...], str]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")
    arr = np.asarray(leaf)
    return tuple(arr.shape), arr.dtype.name


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:09d}")


@dataclasses.dataclass
class CheckpointStats:
    """Host-clock seconds of each save, in the order of the saves.

    ``stall_s``: the wait for the previous background write at the start
    of a save.  ``snapshot_s``: the copy of every leaf to the host buffers,
    ending in a synchronize of the leaves' cards.  ``write_s``: ``(step,
    seconds)`` of each write, in the writer thread for ``save_async`` and
    in the caller's for ``save``.
    """

    stall_s: List[float] = dataclasses.field(default_factory=list)
    snapshot_s: List[float] = dataclasses.field(default_factory=list)
    write_s: List[Tuple[int, float]] = dataclasses.field(
        default_factory=list)


class CheckpointStore:
    """Committed checkpoints under ``base``; ``keep`` most recent kept."""

    def __init__(self, base: str, keep: int = 3):
        self.base = base
        self.keep = keep
        os.makedirs(base, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        # host buffers of the snapshot, one per leaf, reused across saves
        self._buffers: List[torch.Tensor] = []
        self.stats = CheckpointStats()

    # -- snapshot ----------------------------------------------------------
    def _buffer(self, i: int, leaf: torch.Tensor) -> torch.Tensor:
        pin = leaf.device.type == "cuda"
        if i < len(self._buffers):
            buf = self._buffers[i]
            if buf.shape == leaf.shape and buf.dtype == leaf.dtype \
                    and buf.is_pinned() == pin:
                return buf
        buf = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=pin)
        if i < len(self._buffers):
            self._buffers[i] = buf
        else:
            self._buffers.append(buf)
        return buf

    def _snapshot(self, tree) -> Tuple[List[np.ndarray], str]:
        """Host copies of the leaves, complete when this returns."""
        t0 = time.perf_counter()
        leaves, token = _flatten(tree)
        out: List[np.ndarray] = []
        devices = set()
        for i, leaf in enumerate(leaves):
            if isinstance(leaf, torch.Tensor):
                buf = self._buffer(i, leaf)
                buf.copy_(leaf.detach(), non_blocking=leaf.is_cuda)
                if leaf.is_cuda:
                    devices.add(leaf.device)
                out.append(buf.numpy())
            else:
                out.append(np.array(leaf))
        for dev in devices:
            torch.cuda.synchronize(dev)
        self.stats.snapshot_s.append(time.perf_counter() - t0)
        return out, token

    # -- write -------------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[Dict] = None) -> str:
        """Snapshot and write in the caller's thread (after the pending
        background write, whose failure raises here)."""
        self._timed_wait()
        leaves, token = self._snapshot(tree)
        return self._write(step, leaves, token, dict(extra or {}))

    def save_async(self, step: int, tree,
                   extra: Optional[Dict] = None) -> None:
        """Snapshot now (host copy), write in the background.

        A failed background write surfaces here (or at ``wait()``) on the
        *next* call — never silently: a swallowed I/O error would leave no
        committed step while the trainer believes it is checkpointed.
        """
        self._timed_wait()
        leaves, token = self._snapshot(tree)
        extra = dict(extra or {})

        def work():
            try:
                self._write(step, leaves, token, extra)
            except BaseException as e:      # surfaced by the next wait()
                self._exc = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the pending background write; re-raise its failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def _timed_wait(self) -> None:
        t0 = time.perf_counter()
        try:
            self.wait()
        finally:
            self.stats.stall_s.append(time.perf_counter() - t0)

    def _write(self, step: int, leaves, token: str, extra: Dict) -> str:
        t0 = time.perf_counter()
        final = _step_dir(self.base, step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "shard_00000.npz"),
                 **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})
        meta = {"step": step, "n_leaves": len(leaves), "treedef": token,
                "extra": extra}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        self.stats.write_s.append((step, time.perf_counter() - t0))
        return final

    def _gc(self) -> None:
        steps = self.committed_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(_step_dir(self.base, s), ignore_errors=True)

    # -- read --------------------------------------------------------------
    def committed_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.base):
            full = os.path.join(self.base, name)
            if name.startswith("step_") and not name.endswith(".tmp") \
                    and os.path.exists(os.path.join(full, "COMMIT")):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: Optional[int] = None
                ) -> Tuple[Any, Dict]:
        """Restore into the structure of ``tree_like`` as numpy arrays.

        Raises ``FileNotFoundError`` when no step is committed, and
        ``ValueError`` when the tree's token, its leaf count, or a leaf's
        shape or dtype differs from ``tree_like``'s.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.base}")
        d = _step_dir(self.base, step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        like, token = _flatten(tree_like)
        if token != meta["treedef"]:
            raise ValueError(
                f"checkpoint tree structure mismatch: step {step} holds "
                f"{meta['treedef']}, expected {token}")
        if meta["n_leaves"] != len(like):
            raise ValueError(
                f"checkpoint step {step} holds {meta['n_leaves']} leaves, "
                f"expected {len(like)}")
        with np.load(os.path.join(d, "shard_00000.npz")) as data:
            leaves = [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
        for i, (got, want) in enumerate(zip(leaves, like)):
            if _shape_dtype(got) != _shape_dtype(want):
                raise ValueError(
                    f"checkpoint step {step} leaf {i}: shape and dtype "
                    f"{_shape_dtype(got)}, expected {_shape_dtype(want)}")
        return _unflatten(tree_like, leaves), meta["extra"]
