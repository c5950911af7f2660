"""Checkpointing with best-accuracy pointer and full resume.

Upgrade over the reference (SURVEY.md section 5.4): the reference saved only
``{'epoch', 'state_dict'}`` at best val accuracy (``fusion_train.py:325-332``)
with no optimizer state and no mid-run resume.  Here the full
``TrainState`` (params + batch_stats + opt_state + step) is checkpointed, a
``best`` pointer is kept, and ``restore`` resumes training exactly.

A checkpoint is a directory holding ``arrays.npz`` (one entry per leaf) and
``index.json`` (each leaf's ``jax.tree_util`` key path, dtype and shape).
It is written to a temporary directory and renamed into place, so a crash
never leaves a plausible-but-corrupt checkpoint.

Saves are asynchronous by default: ``save`` takes ONE batched device->host
snapshot of the state (so the caller may immediately donate/overwrite the
device buffers — the next train step does) and a background thread writes
the host tree while the following epoch runs.  ``wait()`` drains the
in-flight write; ``fit()`` calls it before returning and ``restore`` calls
it before reading, so no reader can observe a half-written checkpoint from
this process.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
from typing import Optional

import jax
import numpy as np

from edrl.train.trainer import TrainState


def _leaf_entries(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(path), leaf) for path, leaf in leaves]


def _write(path: str, host_tree) -> None:
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    arrays, index = {}, []
    for i, (key, leaf) in enumerate(_leaf_entries(host_tree)):
        a = np.asarray(leaf)
        index.append({"key": key, "dtype": a.dtype.name, "shape": list(a.shape)})
        # Store the raw bytes: npz cannot describe bfloat16 and friends.
        arrays[f"a{i}"] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump(index, f)
    old = path + ".old"
    shutil.rmtree(old, ignore_errors=True)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def _read(path: str) -> dict:
    """{key path string: host array} of the checkpoint at ``path``."""
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for i, entry in enumerate(index):
            dtype = np.dtype(jax.numpy.dtype(entry["dtype"]))
            out[entry["key"]] = z[f"a{i}"].view(dtype).reshape(entry["shape"])
    return out


class _Writer:
    """At most one checkpoint write in flight, on a background thread."""

    def __init__(self, async_save: bool):
        self._async = async_save
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[concurrent.futures.Future] = None

    def save(self, path: str, host_tree) -> None:
        """Write ``host_tree`` to ``path`` (replacing it) in the background."""
        self.wait_until_finished()
        self._pending = self._pool.submit(_write, path, host_tree)
        if not self._async:
            self.wait_until_finished()

    def wait_until_finished(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()


class CheckpointManager:
    def __init__(self, directory: str, async_save: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._ckptr = _Writer(async_save)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(self, state: TrainState, name: str = "latest") -> str:
        path = self._path(name)
        # One batched D2H snapshot; afterwards the caller may donate the
        # device buffers (make_train_step donates the state) while the disk
        # write proceeds from the host copy.  The writer first drains the
        # previous save, bounding host memory at one extra state copy.
        snapshot = jax.device_get(state)
        self._ckptr.save(path, snapshot)
        return path

    def save_best(self, state: TrainState, epoch: int, accuracy: float) -> str:
        path = self.save(state, "best")
        # Publish the watermark only AFTER the async write commits: resume
        # trusts best.json's accuracy as ``initial_best``, so a preemption
        # must never leave best.json ahead of the ``best`` directory (the
        # phantom watermark would permanently block better-than-actual
        # epochs from being saved).  Best saves are rare (improvement only),
        # so the blocking wait costs little; the remaining crash window
        # (directory committed, json unwritten) errs in the benign
        # direction — resume under-estimates and re-saves.
        self._ckptr.wait_until_finished()
        with open(self._path("best.json"), "w") as f:
            json.dump({"epoch": epoch, "accuracy": accuracy}, f)
        return path

    def save_latest(self, state: TrainState, epoch: int) -> str:
        """Rolling preemption checkpoint: ``latest`` + an advisory epoch tag.

        The rename-into-place write guarantees ``latest`` is always a
        COMPLETE state (the previous one if a crash interrupts the in-flight
        write) — but then ``latest.json`` (written immediately) can be ahead
        of the directory's contents.  Resume therefore derives the completed
        epoch from the restored state's ``step`` counter (exact: one step
        per optimizer update, ``len(train_loader)`` per epoch) and treats
        this tag as human-readable metadata only.
        """
        path = self.save(state, "latest")
        with open(self._path("latest.json"), "w") as f:
            json.dump({"epoch": epoch}, f)
        return path

    def latest_info(self) -> Optional[dict]:
        meta = self._path("latest.json")
        if not os.path.exists(meta) or not os.path.isdir(self._path("latest")):
            return None
        with open(meta) as f:
            return json.load(f)

    def wait(self) -> None:
        """Block until any in-flight async save has been committed."""
        self._ckptr.wait_until_finished()

    def best_info(self) -> Optional[dict]:
        meta = self._path("best.json")
        if not os.path.exists(meta):
            return None
        with open(meta) as f:
            return json.load(f)

    def restore(self, template: TrainState, name: str = "latest") -> TrainState:
        """Restore into the structure of ``template`` (a TrainState from
        ``init_state``).  Each leaf goes to the template leaf's device or
        sharding; a missing leaf or a shape or dtype mismatch raises."""
        self._ckptr.wait_until_finished()
        stored = _read(self._path(name))
        leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
        restored = []
        for path, like in leaves:
            key = jax.tree_util.keystr(path)
            if key not in stored:
                raise KeyError(f"checkpoint {name!r} has no leaf {key}")
            host = stored[key]
            want = (np.dtype(like.dtype), tuple(like.shape))
            if (host.dtype, host.shape) != want:
                raise ValueError(
                    f"checkpoint {name!r} leaf {key}: {host.dtype}{list(host.shape)}"
                    f" does not match the template's {want[0]}{list(want[1])}"
                )
            if isinstance(like, jax.Array):
                restored.append(jax.device_put(host, like.sharding))
            else:
                restored.append(host)
        return jax.tree_util.tree_unflatten(treedef, restored)
