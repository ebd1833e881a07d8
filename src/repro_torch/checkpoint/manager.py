"""Checkpointing and fault tolerance (port of
``repro.checkpoint.manager``), in the reference's on-disk format, so each
package reads the other's checkpoints:

- one ``.npy`` per leaf, named from its ``/``-joined tree path, and a
  ``manifest.json`` with the step and, per leaf, its path, file, dtype,
  ``raw_view`` and shape; bf16 and float8 leaves are stored as the
  unsigned integer view of their width, their dtype in the manifest;
- atomic commits: a save writes ``.tmp_step_<step>``, fsyncs the
  manifest, then renames the directory, so a crash mid-save never leaves
  a partial checkpoint that :meth:`CheckpointManager.latest_step` takes;
- async saves on a background thread, and the oldest checkpoints beyond
  ``keep`` removed after each commit;
- restore into the structure of a ``like`` tree, each leaf cast to the
  like leaf's dtype and placed on its device, or on the device the
  ``shardings`` tree gives for it (the elastic path: the same bytes on a
  new placement).

A tree is nested dicts (keys joined by ``/``; a key holding ``/`` gives
the same path as the nesting it spells), lists and tuples (their indices)
of tensors, numpy arrays or Python numbers. A tensor on the card is copied
to the host once per leaf, when :meth:`CheckpointManager.save` is called,
so training may go on changing it while an async save writes.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

_SAFE = re.compile(r"[^\w\-/.]")

#: dtypes numpy stores natively; any other is written as a raw view
_NATIVE = ("float64", "float32", "float16", "int64", "int32", "int16",
           "int8", "uint64", "uint32", "uint16", "uint8", "bool")


def _fname(path_str: str) -> str:
    return _SAFE.sub("_", path_str).replace("/", "__") + ".npy"


def _leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` in the reference's flatten order: dict keys
    sorted, sequences by index."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaves(v, f"{prefix}/{i}" if prefix else str(i))
        return out
    return [(prefix, tree)]


def _rebuild(like, values, prefix: str = ""):
    """``like``'s structure with each leaf replaced by ``values[path]``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, values, f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(
            _rebuild(v, values, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(like))
    return values[prefix]


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """``(array to store, logical dtype name)`` of one leaf: a tensor's
    one copy to the host, its bits kept (bf16 and float8 as their
    unsigned view)."""
    if not torch.is_tensor(leaf):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach()
    name = _dtype_name(t.dtype)
    if name not in _NATIVE:
        t = t.view({1: torch.uint8, 2: torch.uint16,
                    4: torch.uint32}[t.element_size()])
    # a copy, so that an async save writes the value of the call's time
    return t.to("cpu", copy=True).contiguous().numpy(), name


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        """Write ``tree`` as checkpoint ``step``: now, or with ``blocking``
        off on a background thread; either way after the previous async
        save is done (two writes of one step would share its temporary
        directory). The leaves are copied to the host before this
        returns."""
        host = [(p, *_to_host(v)) for p, v in _leaves(tree)]
        self.wait()
        if blocking:
            self._write(step, host)
        else:
            self._thread = threading.Thread(
                target=self._write_caught, args=(step, host), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Wait for an async save; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_caught(self, step: int, host) -> None:
        try:
            self._write(step, host)
        except BaseException as e:  # handed to wait()
            self._error = e

    def _write(self, step: int, host) -> None:
        tmp = self.dir / f".tmp_step_{step:09d}"
        final = self.dir / f"step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": []}
        for path_str, arr, dtype in host:
            fn = _fname(path_str)
            raw_view = dtype not in _NATIVE
            np.save(tmp / fn, arr)
            manifest["leaves"].append(
                {"path": path_str, "file": fn, "dtype": dtype,
                 "raw_view": bool(raw_view), "shape": list(arr.shape)})
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                      # atomic commit
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, shardings: Any = None) -> Any:
        """Checkpoint ``step`` in the structure of ``like``: each leaf a
        tensor of the like leaf's dtype on its device, or on the device
        ``shardings`` (a tree of the same structure) gives; a like leaf
        that is a Python number comes back as one."""
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_path = {e["path"]: e for e in manifest["leaves"]}
        targets = (dict(_leaves(shardings)) if shardings is not None
                   else {})
        values = {}
        for path, leaf in _leaves(like):
            if path not in by_path:
                raise KeyError(f"checkpoint missing leaf {path}")
            entry = by_path[path]
            t = torch.from_numpy(np.load(d / entry["file"]))
            if entry.get("raw_view"):
                t = t.view(getattr(torch, entry["dtype"]))
            if not torch.is_tensor(leaf):
                values[path] = type(leaf)(t.item())
                continue
            dev = targets.get(path)
            dev = leaf.device if dev is None else torch.device(dev)
            values[path] = t.to(device=dev, dtype=leaf.dtype)
        return _rebuild(like, values)


def train_state(flat, opt_state) -> dict:
    """The reference's train-state tree ``{"params", "opt"}`` of a model's
    weights (``models.params.FlatParams``) and its AdamW state: the
    weights leaf by leaf in their reference shapes (a stacked leaf's
    layers stacked), ``m``, ``v`` (and the master) as views of the flat
    buffers, the step an int32 scalar; keyed by the weights' paths, so it
    saves to the same files as the reference's tree."""
    opt = {"step": torch.tensor(int(opt_state["step"]), dtype=torch.int32)}
    for name in ("m", "v", "master"):
        if name in opt_state:
            opt[name] = flat.tree(opt_state[name])
    return {"params": flat.weights(), "opt": opt}


def load_train_state(flat, opt_state, tree) -> None:
    """Write a restored :func:`train_state` tree into the weights and the
    AdamW state, in place."""
    flat.assign_weights(tree["params"])
    opt = tree["opt"]
    with torch.no_grad():
        for name in ("m", "v", "master"):
            if name in opt_state:
                for path, view in flat.tree(opt_state[name]).items():
                    view.copy_(opt[name][path])
    opt_state["step"] = int(opt["step"])
