"""Fault-tolerant checkpointing of training state — the port's
``repro.checkpoint.manager``, in the reference's directory format, so a
checkpoint moves between the two packages.

* **Format** — ``step_N/`` holds ``leaf_i.npy`` per leaf, in the
  reference's flattening order (JAX's: dict keys sorted, lists and
  tuples in order, ``None`` no leaf), and ``manifest.json`` with the
  step, the tree structure as JAX prints it, the leaf count, the
  caller's ``extra`` (the data cursor) and each leaf's shape and dtype.
  A bfloat16 leaf is stored as the reference stores one: its two bytes
  per element under the ``.npy`` descr ``'<V2'`` and manifest dtype
  ``"bfloat16"`` (NumPy has no bfloat16; the port writes the tensor's
  bits viewed as int16 and reads ``'<V2'`` back into ``torch.bfloat16``).
* **Atomic commit** — writes go to ``step_N.tmp/`` and are renamed to
  ``step_N/`` only after the manifest is fsync'd; a crash mid-save never
  corrupts the latest checkpoint.  ``keep`` bounds the committed steps.
* **Async** — :meth:`CheckpointManager.save` copies the leaves to host
  memory synchronously (training may then overwrite them in place) and
  a background writer thread does the file I/O; :meth:`wait` joins it
  before the next save or exit, and re-raises what the writer raised.
* **Restore** — leaves are loaded on the host and placed on each target
  leaf's device in its dtype.  Placement against a mesh's shardings
  (``shardings=``) waits for ROADMAP "A10, model half".
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.core.tree import leaves, unflatten_like

__all__ = ["CheckpointManager", "restore_latest", "treedef_str"]

_BF16_DESCR = "<V2"


def treedef_str(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for a tree of dicts,
    lists and tuples."""
    def node(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(node(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(node(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({node(tree)})"


def _to_host(x) -> tuple[np.ndarray, str]:
    """A leaf as a host array and its manifest dtype name."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).cpu().numpy(), "bfloat16"
        x = x.cpu().numpy()
    x = np.asarray(x)
    return x, str(x.dtype)


def _save_leaf(path: str, x: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, x)
        return
    # the bytes np.save writes for an ml_dtypes bfloat16 array
    x = np.ascontiguousarray(x)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": x.shape})
        f.write(x.tobytes())


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    h = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(h.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(h))


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, *, extra: dict | None = None,
             async_: bool = True) -> None:
        self.wait()
        # snapshot to host (synchronous, so training can mutate buffers)
        host = [_to_host(x) for x in leaves(tree)]
        manifest = {
            "step": int(step),
            "treedef": treedef_str(tree),
            "n_leaves": len(host),
            "extra": extra or {},
            "leaves": [{"shape": list(x.shape), "dtype": dt}
                       for x, dt in host],
        }

        def write():
            tmp = os.path.join(self.directory, f"step_{step}.tmp")
            final = os.path.join(self.directory, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for i, (x, dt) in enumerate(host):
                _save_leaf(os.path.join(tmp, f"leaf_{i}.npy"), x, dt)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()

        if async_:
            def run():
                try:
                    write()
                except BaseException as e:   # noqa: BLE001 — for wait()
                    self._error = e
            self._thread = threading.Thread(target=run, daemon=True,
                                            name="ckpt-writer")
            self._thread.start()
        else:
            write()

    def wait(self, timeout: float | None = None) -> None:
        """Join the writer (``TimeoutError`` if it is still running after
        ``timeout`` seconds) and re-raise what it raised."""
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(f"checkpoint writer still running after "
                                   f"{timeout} s")
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def restore(self, step: int, target_tree, *, shardings=None):
        """Load step ``step``'s leaves and place each on its target
        leaf's device in its dtype; returns ``(tree, extra)``."""
        if shardings is not None:
            raise NotImplementedError(
                "restore(shardings=): placing leaves against a mesh's "
                "shardings waits for ROADMAP \"A10, model half\"")
        path = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        targets = leaves(target_tree)
        if manifest["n_leaves"] != len(targets):
            raise ValueError(f"tree structure changed: the checkpoint has "
                             f"{manifest['n_leaves']} leaves, the target "
                             f"{len(targets)}")
        placed = []
        for i, (meta, target) in enumerate(zip(manifest["leaves"], targets)):
            h = _load_leaf(os.path.join(path, f"leaf_{i}.npy"),
                           meta["dtype"])
            placed.append(h.to(device=target.device, dtype=target.dtype))
        return unflatten_like(target_tree, placed), manifest["extra"]


def restore_latest(manager: CheckpointManager, target_tree, *,
                   shardings=None):
    steps = manager.steps()
    if not steps:
        return None, None, -1
    tree, extra = manager.restore(steps[-1], target_tree,
                                  shardings=shardings)
    return tree, extra, steps[-1]
