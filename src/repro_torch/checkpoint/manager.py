"""Checkpointing with async write and atomic commit — the PyTorch twin of
``repro/checkpoint/manager.py``, with the same files.

Layout: ``<dir>/step_<N>/`` (N in eight digits) holding ``host0.npz``,
every leaf by its key path (``tree.flatten_with_paths``: ``embed``,
``.master/layers/wq``, ``.step``, ...), and ``manifest.json`` (step,
shapes and dtypes, time).  Writes go to ``step_<N>.tmp`` and are
committed with an atomic rename, so a crashed writer never corrupts the
latest checkpoint: the restart invariant the fault-tolerance layer relies
on.  The files and keys are the reference's, so each package restores a
checkpoint the other wrote.

``save`` copies every leaf to host memory before it returns (later
in-place updates of the tensors do not reach the checkpoint) and writes
in a background thread.  ``restore(like)`` places each leaf on the device
and in the dtype of ``like``'s leaf.  The reference's ``shardings=``
(restore-with-remesh onto another mesh) has no meaning on one card and is
left out.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..tree import flatten_with_paths, tree_map


def _to_host(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    # a copy even for a CPU tensor: the optimizer updates its state in
    # place while the write is queued
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _to_device(arr: np.ndarray, like) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    # bfloat16 leaves come back from the .npz as 2-byte void: same bits
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                        and arr.dtype.itemsize == 2):
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device=like.device, dtype=like.dtype)


class CheckpointManager:
    """save(step, tree) / restore(like, step?) with background (async)
    writes."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = True) -> None:
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._async = async_write
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if async_write:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # -- write path ----------------------------------------------------------

    def save(self, step: int, tree: Any) -> None:
        """Snapshot to host memory now; write + commit in the background."""
        host = {}
        shapes = {}
        for key, leaf in flatten_with_paths(tree):
            arr = _to_host(leaf)
            host[key] = arr
            shapes[key] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
        manifest = {"step": step, "leaves": shapes, "time": time.time()}
        if self._async:
            self._q.put((step, host, manifest))
        else:
            self._write(step, host, manifest)

    def wait(self) -> None:
        """Block until all queued writes are committed."""
        self._q.join()
        if self._error:
            raise self._error

    def _drain(self) -> None:
        while True:
            step, host, manifest = self._q.get()
            try:
                self._write(step, host, manifest)
            except BaseException as e:  # noqa: BLE001
                self._error = e
            finally:
                self._q.task_done()

    def _write(self, step: int, host: Dict[str, np.ndarray],
               manifest: Dict) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "host0.npz"), **host)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- read path ------------------------------------------------------------

    def list_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any,
                step: Optional[int] = None) -> Tuple[int, Any]:
        """Restore into the structure of ``like`` (the latest step unless
        ``step`` is given): each leaf on the device and in the dtype of
        ``like``'s leaf at the same key."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with np.load(os.path.join(path, "host0.npz")) as data:
            arrays = {key: data[key] for key, _ in flatten_with_paths(like)}
        keys = iter(arrays)
        return step, tree_map(lambda leaf: _to_device(arrays[next(keys)],
                                                      leaf), like)
