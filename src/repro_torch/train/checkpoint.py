"""Fault-tolerant checkpointing: atomic, keep-N, in the reference's file
format (port of ``repro.train.checkpoint``).

``step_%010d/`` holds ``leaves.npz`` (``leaf_<i>``, one array per leaf in
JAX's leaf order, bfloat16 stored as its ``uint16`` bits) and
``manifest.json`` (``step``, ``num_leaves``, ``treedef``, ``dtypes``,
``shapes``). A save writes ``.tmp_step_%010d/`` and renames it into place,
so a crash mid-write never corrupts the latest checkpoint; the oldest are
removed beyond ``keep``. Laid out as the reference's tree (for a model:
``convert.lm_params_to_reference``), a checkpoint written by either package
restores in the other. ``treedef`` is the port's own description of the
structure; the reference's restore never reads it.

An :class:`AsyncCheckpointer` copies the tree to the host at once and writes
it on a worker thread while training goes on.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.train.pytree import tree_flatten, tree_map, tree_unflatten

__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint", "save_checkpoint"]


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """``(array to store, dtype name)`` of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _describe(treedef) -> str:
    if treedef is None:
        return "None"
    if treedef == "*":
        return "*"
    return "(" + ", ".join(_describe(d) for _, d in treedef[1]) + ")"


def save_checkpoint(directory: str, step: int, tree, keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:010d}"
    tmp = os.path.join(directory, f".tmp_{name}")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves, treedef = tree_flatten(tree)
    arrays, dtypes, shapes = {}, [], []
    for i, leaf in enumerate(leaves):
        arr, dtype = _host_array(leaf)
        arrays[f"leaf_{i}"] = arr
        dtypes.append(dtype)
        shapes.append(list(arr.shape))
    np.savez(os.path.join(tmp, "leaves.npz"), **arrays)
    manifest = {
        "step": step,
        "num_leaves": len(leaves),
        "treedef": _describe(treedef),
        "dtypes": dtypes,
        "shapes": shapes,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    if not ckpts:
        return None
    return int(ckpts[-1].split("_")[1])


def restore_checkpoint(directory: str, tree_like, step: int | None = None):
    """Restore into the structure of ``tree_like`` (its leaves are not
    read: meta tensors will do); returns ``(tree, step)`` with every leaf a
    CPU tensor of the stored dtype. Placing it on a device is the
    caller's."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_like, treedef = tree_flatten(tree_like)
    if manifest["num_leaves"] != len(leaves_like):
        raise ValueError(f"{path} holds {manifest['num_leaves']} leaves, the tree "
                         f"{len(leaves_like)}")
    leaves = []
    with np.load(os.path.join(path, "leaves.npz")) as data:
        for i in range(len(leaves_like)):
            arr = data[f"leaf_{i}"]
            if manifest["dtypes"][i] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            leaves.append(t)
    return tree_unflatten(treedef, leaves), step


class AsyncCheckpointer:
    """Serialises saves on a worker thread; ``wait()`` before exit."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._pending: threading.Thread | None = None

    def save(self, step: int, tree) -> None:
        self.wait()
        # on the host NOW, so training may go on with the device buffers
        host_tree = tree_map(
            lambda x: x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x,
            tree)
        self._pending = threading.Thread(
            target=save_checkpoint,
            args=(self.directory, step, host_tree, self.keep),
            daemon=True,
        )
        self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
