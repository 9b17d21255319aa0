"""Async checkpointing with atomic manifests, in the reference's layout.

Counterpart of ``repro/checkpoint/checkpointer.py``, with the same
on-disk format, so a checkpoint written by either restores in the other:

* one ``.npy`` per leaf, named by its path in the tree (``params/stages/
  0/0F/attn/w_q`` → ``params__stages__0__0F__attn__w_q.npy``), stored
  unsharded; bfloat16 leaves are stored as float32 (lossless) and tagged
  ``"bfloat16"`` in the manifest;
* ``manifest.json`` with the step, the time, the caller's ``extra`` (the
  data pipeline's state) and each leaf's key, shape and dtype;
* **atomic**: leaves go to ``step_XXXXXXXX.tmp/``, which is renamed only
  after every array and the fsync'd manifest are written;
* **async**: tensors are copied to host memory synchronously — a snapshot
  the next step cannot change — and written by a background thread.

Restore loads into the structure of a template tree, each leaf on the
template leaf's device, in the manifest's dtype.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.models.sharding import tree_map
from repro_torch.runtime.retry import CHECKPOINT_RETRY, retry_call


def _flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs; dict keys and list indices joined by ``/``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _to_host(v) -> tuple[np.ndarray, str]:
    """A host copy of ``v`` as it is now: the write happens later, on
    another thread, and the train step updates the optimizer state in
    place (a CPU tensor's ``.cpu().numpy()`` is a view, so it is copied)."""
    t = torch.as_tensor(v).detach()
    if t.dtype == torch.bfloat16:
        return t.float().cpu().numpy(), "bfloat16"
    a = t.cpu().numpy()
    if t.device.type == "cpu":
        a = a.copy()
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str, like) -> torch.Tensor:
    # ascontiguousarray returns at least 1-d: keep a scalar's shape ()
    t = torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(dev)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # -- save ------------------------------------------------------------
    def save(self, step: int, tree, extra: dict | None = None,
             blocking: bool = False) -> None:
        """Snapshot now, write in background (unless blocking)."""
        self.wait()  # one in-flight write at a time
        host_leaves = [(k, *_to_host(v)) for k, v in _flatten_with_paths(tree)]
        manifest = {
            "step": step,
            "time": time.time(),
            "extra": extra or {},
            "leaves": [
                {"key": k, "shape": list(a.shape), "dtype": dt}
                for k, a, dt in host_leaves
            ],
        }

        def write_once():
            tmp = os.path.join(self.directory, f"step_{step:08d}.tmp")
            final = os.path.join(self.directory, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            for k, a, _dt in host_leaves:
                np.save(os.path.join(tmp, k.replace("/", "__") + ".npy"), a)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)            # atomicity point
            self._gc()

        def write():
            # transient filesystem errors retry under the checkpoint budget;
            # the .tmp/ staging makes re-running the whole write idempotent
            retry_call(
                write_once, retry_on=(OSError,), policy=CHECKPOINT_RETRY,
                label=f"checkpoint step {step}", seed=step,
            )

        def write_background():
            # the thread captures failures for wait() to re-raise: an
            # exception dying with the thread would turn a failed
            # checkpoint into a silently missing one
            try:
                write()
            except Exception as e:
                self._error = e

        if blocking:
            write()
        else:
            self._error = None
            self._thread = threading.Thread(target=write_background, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            raise self._error

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(
            int(name.split("_")[1]) for name in os.listdir(self.directory)
            if name.startswith("step_") and not name.endswith(".tmp")
        )

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None) -> tuple[Any, dict]:
        """Restore into the structure of ``template`` -> (tree, manifest).

        Only the template's leaves are read: a checkpoint of a larger
        state (the reference's, with its compression error feedback)
        restores into a template that holds part of it.
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = {d["key"]: d["dtype"] for d in manifest["leaves"]}

        def load(key, like):
            a = np.load(os.path.join(path, key.replace("/", "__") + ".npy"))
            return _from_host(a, dtypes.get(key, str(a.dtype)), like)

        paths = iter(k for k, _ in _flatten_with_paths(template))
        restored = tree_map(lambda like: load(next(paths), like), template)
        return restored, manifest
