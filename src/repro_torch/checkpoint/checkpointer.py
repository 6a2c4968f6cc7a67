"""Fault-tolerant checkpointing in the JAX package's on-disk format.

Each checkpoint is a directory ``step_<10 digits>`` holding
``arrays.npz`` (every leaf of the state, keyed by its ``/``-joined path:
dict keys and tuple indices) and ``manifest.json`` (step, time, the
caller's JSON-able ``extra`` such as the data cursor, and the leaf count).
So a checkpoint the reference wrote reads here (``read`` + ``nested``),
and one written here reads there.

  * atomic: written to ``<dir>.tmp``, the manifest fsynced, then renamed;
  * keep-N garbage collection of the oldest;
  * async: an optional background thread serialises, after the copy to
    host memory, which is the correctness boundary;
  * ``restore_latest`` scans newest to oldest and skips a corrupt or
    partial checkpoint.

States are nests of dicts and tuples (or lists) whose leaves are tensors;
restore moves each leaf to its template leaf's device and dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        t = torch.as_tensor(tree)
        return {prefix: t.detach().cpu().numpy()}
    flat = {}
    for key, sub in items:
        flat.update(_flatten(sub, f"{prefix}/{key}" if prefix else str(key)))
    return flat


def _unflatten(template, flat: Dict[str, np.ndarray], prefix: str = ""):
    def path(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(template, dict):
        return {k: _unflatten(v, flat, path(k)) for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, flat, path(i))
                              for i, v in enumerate(template))
    if prefix not in flat:
        raise KeyError(f"checkpoint missing leaf {prefix!r}")
    arr = flat[prefix]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"shape mismatch for {prefix}: ckpt {arr.shape} vs "
                         f"template {tuple(template.shape)}")
    return torch.from_numpy(arr).to(device=template.device,
                                    dtype=template.dtype)


def nested(flat: Dict[str, np.ndarray]) -> dict:
    """``{"a/b/c": x}`` -> ``{"a": {"b": {"c": x}}}``: a flat checkpoint as
    nested dicts (tuple indices become string keys), e.g. to read a
    reference checkpoint's ``params`` tree."""
    out: dict = {}
    for key, arr in flat.items():
        *head, last = key.split("/")
        node = out
        for part in head:
            node = node.setdefault(part, {})
        node[last] = arr
    return out


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def all_steps(self):
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(steps)

    def save(self, step: int, state, extra: Optional[Dict[str, Any]] = None,
             block: bool = True):
        """Persist ``state`` (a nest of tensors) and a small JSON-able
        ``extra`` dict.  The copy to host memory happens here; with
        ``async_write`` and ``block=False`` a thread writes the files."""
        flat = _flatten(state)
        self.wait()  # never two concurrent writers (same-step race)
        if self.async_write and not block:
            # non-daemon, as in the reference: if the train loop dies the
            # interpreter still joins this thread, so an in-flight
            # checkpoint finishes its atomic rename
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, extra), daemon=False)
            self._thread.start()
        else:
            self._write(step, flat, extra)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: Dict[str, np.ndarray], extra):
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": step, "time": time.time(),
                    "extra": extra or {}, "n_arrays": len(flat)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def read(self, step: int):
        """(flat arrays, extra) of one checkpoint; raises on a corrupt or
        partial one."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        if len(flat) != manifest["n_arrays"]:
            raise OSError("truncated checkpoint")
        return flat, manifest.get("extra", {})

    def restore_latest(self, template):
        """The newest checkpoint that reads and fits ``template``'s
        structure and shapes, as (state, step, extra), or (None, -1, {})."""
        for step in reversed(self.all_steps()):
            try:
                flat, extra = self.read(step)
                return _unflatten(template, flat), step, extra
            except (OSError, KeyError, ValueError, EOFError,
                    zipfile.BadZipFile):
                continue
        return None, -1, {}
