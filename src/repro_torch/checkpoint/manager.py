"""Fault-tolerant checkpointing: atomic, async, reshard-on-restore (the
port of the reference's ``repro.checkpoint.manager``, with its on-disk
layout, so either package restores the other's checkpoints).

Layout (one directory per step)::

    <dir>/step_000000123/
        manifest.json          # step, time, extra, {key: shape, dtype}
        arrays.npz             # whole leaves, keys "params/..." "opt/..."
    <dir>/step_000000123.<pid>.<tid>.tmp   # staging, renamed on commit
    <dir>/LATEST               # "step_000000123", written last

* **atomicity**: a crash mid-save never corrupts the latest checkpoint
  (staging + ``os.replace`` commit + the LATEST pointer written last);
* **async, never silent**: ``save(..., blocking=False)`` writes on a
  background thread; an exception there is re-raised by the next
  ``wait()`` or ``save()``, and the failed attempt's staging is removed;
* **stale staging swept**: ``*.tmp`` directories whose pid is not a
  live process are removed at construction and after every commit;
* **retention**: the newest ``keep`` steps, never the one just written;
* **reshard-on-restore**: arrays are whole (global logical form), so a
  run on another mesh takes its own shards of them.

Arrays are stored as numpy.  numpy has no bfloat16, so a bf16 tensor is
stored as its 16-bit patterns (``|V2``, as the reference's ``ml_dtypes``
arrays land in an npz) and the manifest's dtype says how to read them.
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

__all__ = ["CheckpointManager"]

_BF16 = "bfloat16"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict[str, Any]):
    tree: dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _to_host(x) -> tuple[np.ndarray, str]:
    """A leaf as (numpy array to store, manifest dtype)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), _BF16
        x = t.numpy()
    a = np.asarray(x)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype=np.dtype(dtype), copy=True))


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._sweep_stale_tmp()

    # ------------------------------------------------------------- #
    def save(self, step: int, state: dict[str, Any], *,
             extra: dict | None = None, blocking: bool = True) -> None:
        """Write ``state`` (nested dicts of tensors or arrays, whole
        leaves) as step ``step``; the leaves are copied to the host
        before this returns."""
        host = {k: _to_host(v) for k, v in _flatten(state).items()}
        self.wait()  # never two writers in flight; raises a pending error
        if blocking:
            self._guarded_write(step, host, extra or {})
            self._raise_pending()
        else:
            self._thread = threading.Thread(
                target=self._guarded_write, args=(step, host, extra or {}),
                daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join any in-flight writer; re-raises an exception it hit."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"checkpoint save failed in {self.directory}") from err

    def _guarded_write(self, step, host, extra):
        """``_write``, its staging removed and its exception kept for the
        next ``wait()``/``save()`` on failure."""
        tmp = self._tmp_path(step)
        try:
            self._write(step, host, extra, tmp)
        except BaseException as e:  # noqa: BLE001 - kept, re-raised later
            shutil.rmtree(tmp, ignore_errors=True)
            self._error = e

    def _tmp_path(self, step: int) -> str:
        final = os.path.join(self.directory, f"step_{step:09d}")
        return f"{final}.{os.getpid()}.{threading.get_ident()}.tmp"

    def _write(self, step, host, extra, tmp: str):
        name = f"step_{step:09d}"
        final = os.path.join(self.directory, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "time": time.time(),
            "extra": extra,
            "arrays": {k: {"shape": list(a.shape), "dtype": dtype}
                       for k, (a, dtype) in host.items()},
        }
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: a for k, (a, _) in host.items()})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                      # atomic commit
        with open(os.path.join(self.directory, "LATEST.tmp"), "w") as f:
            f.write(name)
        os.replace(os.path.join(self.directory, "LATEST.tmp"),
                   os.path.join(self.directory, "LATEST"))
        self._gc(protect=step)

    def _gc(self, protect: int | None = None):
        """Retention by step number, never the step just committed: a
        directory reused across runs can hold stale *higher* steps."""
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            if s == protect:
                continue
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)
        self._sweep_stale_tmp()

    def _sweep_stale_tmp(self):
        """Remove ``step_*.tmp`` staging whose embedded pid is not a live
        process (or cannot be read); this process's own is kept, since a
        writer of it may be in flight."""
        for n in os.listdir(self.directory):
            if not (n.startswith("step_") and n.endswith(".tmp")):
                continue
            parts = n[:-len(".tmp")].split(".")
            try:
                pid = int(parts[-2]) if len(parts) >= 3 else None
            except ValueError:
                pid = None
            if pid == os.getpid():
                continue
            alive = False
            if pid is not None:
                try:
                    os.kill(pid, 0)
                    alive = True            # a live process: keep
                except ProcessLookupError:
                    alive = False           # dead: stale
                except PermissionError:
                    alive = True            # live but foreign: keep
                except OSError:
                    alive = False
            if not alive:
                shutil.rmtree(os.path.join(self.directory, n),
                              ignore_errors=True)

    # ------------------------------------------------------------- #
    def all_steps(self) -> list[int]:
        return sorted(int(n.split("_")[1]) for n in os.listdir(self.directory)
                      if n.startswith("step_") and not n.endswith(".tmp"))

    def latest_step(self) -> int | None:
        """The step LATEST names, if its directory is complete; else the
        newest complete step (a dangling pointer falls back)."""
        path = os.path.join(self.directory, "LATEST")
        if os.path.exists(path):
            with open(path) as f:
                step = int(f.read().strip().split("_")[1])
            if self._complete(step):
                return step
        for step in reversed(self.all_steps()):
            if self._complete(step):
                return step
        return None

    def _complete(self, step: int) -> bool:
        return os.path.exists(os.path.join(
            self.directory, f"step_{step:09d}", "manifest.json"))

    def manifest(self, step: int) -> dict:
        """The manifest of ``step``: its keys' shapes and dtypes."""
        with open(os.path.join(self.directory, f"step_{step:09d}",
                               "manifest.json")) as f:
            return json.load(f)

    def restore(self, step: int | None = None, *, leaf=None):
        """(step, tree of whole CPU tensors in the manifest's dtypes,
        manifest) of ``step`` (default: the latest).  A run takes its own
        shards of the whole leaves (``Zero3.shard``): reshard-on-restore
        onto any mesh.  ``leaf(key, tensor)``, where given, maps each
        leaf (``key`` its flattened path) as soon as it is read, so only
        one whole leaf is on the host at a time."""
        leaf = leaf or (lambda _, x: x)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        manifest = self.manifest(step)
        d = os.path.join(self.directory, f"step_{step:09d}")
        with np.load(os.path.join(d, "arrays.npz")) as data:
            flat = {k: leaf(k, _from_host(data[k],
                                          manifest["arrays"][k]["dtype"]))
                    for k in data.files}
        return step, _unflatten(flat), manifest
