"""Checkpoints with atomic commits, an async writer and elastic restore
(mirrors ``repro.checkpoint.checkpoint``, on-disk layout included).

Layout: ``<dir>/step_<n>.tmp/`` is written (one ``.npy`` per leaf plus a
manifest), fsync'd, then atomically renamed to ``step_<n>/``: a crashed
writer never corrupts the latest checkpoint.  ``save_async`` runs the
writer on a background thread so the train loop overlaps I/O with
compute.

The layout is the JAX package's, so a checkpoint crosses between the
packages both ways: a leaf's key is its path in JAX's spelling
(``"[0]/['layers']/[0]/['mix']/['wq']"``, ``"[1]/.step"``; see
``repro_torch._tree``), its file that key with ``/`` -> ``__``, and the
manifest keeps ``step``, ``keys``, ``extra`` and ``dtypes``.  numpy has
no bfloat16: a bfloat16 leaf goes to disk as its ``uint16`` bit pattern,
tagged ``"bfloat16"`` in the manifest (``tensor.view(torch.int16)``, and
back the same way).

Elastic restore: leaves are saved whole, and ``restore`` places them on
whatever device the new job names.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._tree import leaves_with_paths, map_with_paths
from repro_torch.device import resolve_device


def _key(path) -> str:
    return "/".join(path)


def _to_savable(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """An owning host array of ``leaf`` and its manifest dtype tag."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_savable(arr: np.ndarray, tag: str) -> torch.Tensor:
    if tag == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    return {_key(path): _to_savable(leaf)
            for path, leaf in leaves_with_paths(tree)}


def _write(flat, directory: str, step: int, extra: Optional[Dict]):
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "keys": sorted(flat), "extra": extra or {},
                "dtypes": {}}
    for key, (arr, tag) in flat.items():
        manifest["dtypes"][key.replace("/", "__")] = tag
        np.save(os.path.join(tmp, key.replace("/", "__") + ".npy"), arr)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic commit
    _gc(directory, keep=3)


def save(tree, directory: str, step: int, extra: Optional[Dict] = None):
    _write(_flatten(tree), directory, step, extra)


_writer: Optional[threading.Thread] = None


def save_async(tree, directory: str, step: int,
               extra: Optional[Dict] = None) -> threading.Thread:
    """Overlap checkpoint I/O with the next train steps.  The host copies
    are taken, and own their memory, before this returns: the train step
    updates the parameters and moments in place, so the writer thread
    must never read a device tensor or a view of one."""
    global _writer
    if _writer is not None and _writer.is_alive():
        _writer.join()             # backpressure: one in flight
    flat = _flatten(tree)
    _writer = threading.Thread(target=_write,
                               args=(flat, directory, step, extra))
    _writer.start()
    return _writer


def wait_pending():
    if _writer is not None and _writer.is_alive():
        _writer.join()


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(directory, name,
                                            "manifest.json")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(tree_like, directory: str, step: Optional[int] = None,
            device=None):
    """Restore into the structure of ``tree_like`` (its leaves are not
    read), each leaf an owning tensor on ``device`` at the dtype the
    manifest names.  Returns (tree, manifest)."""
    dev = resolve_device(device)
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    base = os.path.join(directory, f"step_{step}")
    with open(os.path.join(base, "manifest.json")) as f:
        manifest = json.load(f)

    def load(path, _like):
        key = _key(path).replace("/", "__")
        arr = np.load(os.path.join(base, key + ".npy"))
        tag = manifest.get("dtypes", {}).get(key, str(arr.dtype))
        return _from_savable(arr, tag).to(dev)
    return map_with_paths(load, tree_like), manifest


def _gc(directory: str, keep: int):
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(directory)
        if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)
