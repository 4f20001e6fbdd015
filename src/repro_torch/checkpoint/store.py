"""Atomic checkpointing of trees of tensors: the PyTorch port of the JAX
package's ``checkpoint/store.py``.

Layout: ``<dir>/step_<n>.tmp/`` is written (one ``leaf_%05d.npy`` per
leaf and a ``manifest.json``), fsync'd, then atomically renamed to
``step_<n>/`` -- a crash mid-write never corrupts the latest complete
checkpoint.  Leaves come in the reference's flatten order
(``repro_torch.tree``), so the ``.npy`` files of one state written by the
two packages are equal one for one.  The reference's manifest pickles a
JAX treedef; the port's is JSON (the structure, the leaf count, the step
and each leaf's torch dtype).  A bf16 leaf (numpy has none) is saved as
its exact f32 values and restored to bf16.  A sharded leaf
(``distributed.sharding.Sharded``) is written as its full array, so the
files do not depend on the mesh; ``restore_checkpoint(shardings=)``
places each restored leaf by its ``NamedSharding`` on the current mesh
(or on a device), which reshards across device counts as the reference's
restore does.

``AsyncCheckpointer`` copies the tree to the host, then writes it on a
background thread, so training steps overlap the write.  ``commit_dir``
and ``fsync_dir`` are shared with the storage layout.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..distributed.sharding import is_sharded, place_tree, to_full
from ..tree import (structure_from_json, structure_to_json, tree_flatten,
                    tree_map, tree_unflatten)


def fsync_dir(path: str) -> None:
    """fsync a directory so renames/creations inside it are durable."""
    dfd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def commit_dir(tmp: str, final: str) -> str:
    """Atomically publish ``tmp`` as ``final``: fsync the staged directory,
    replace any previous ``final``, rename, fsync the parent.  A crash at
    any point leaves either the old complete directory or the new one --
    never a torn mix."""
    fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    fsync_dir(os.path.dirname(os.path.abspath(final)))
    return final


class _Host:
    """A leaf copied to the host: a numpy array that owns its data, and
    the dtype's name."""

    def __init__(self, arr: np.ndarray, dtype: str):
        self.arr, self.dtype = arr, dtype


def _host(leaf) -> _Host:
    if isinstance(leaf, _Host):
        return leaf
    if is_sharded(leaf):            # put together where its blocks lie
        leaf = to_full(leaf, leaf.blocks[0].device)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return _Host(t.numpy().copy(), name)
    arr = np.array(leaf)
    return _Host(arr, str(arr.dtype))


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Blocking atomic save; returns the final directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves, structure = tree_flatten(tree, is_leaf=is_sharded)
    dtypes = []
    for i, leaf in enumerate(leaves):
        h = _host(leaf)
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), h.arr)
        dtypes.append(h.dtype)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"tree": structure_to_json(structure),
                   "n_leaves": len(leaves), "dtypes": dtypes,
                   "step": step}, f)
    return commit_dir(tmp, final)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       device="cuda", shardings: Any = None
                       ) -> tuple[Any, int]:
    """Load (tree, step): each leaf a tensor of its saved dtype on
    ``device`` (the card unless the caller asks for the CPU); an
    ``AdamWState`` comes back as the port's class.  With ``shardings`` (a
    tree of the checkpoint's structure holding a ``NamedSharding`` or a
    device at each leaf, e.g. ``sharding.shardings_of(state)``) each leaf
    is placed by it instead: a ``Sharded`` leaf on the current mesh."""
    from ..core.config import resolve_device
    from ..optim.adamw import AdamWState
    device = resolve_device(device) if shardings is None else None
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for i, name in enumerate(manifest["dtypes"]):
        arr = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
        t = torch.from_numpy(arr)
        if hasattr(torch, name) and t.dtype != getattr(torch, name):
            t = t.to(getattr(torch, name))
        leaves.append(t if device is None else t.to(device))
    structure = structure_from_json(manifest["tree"],
                                    {"AdamWState": AdamWState})
    tree = tree_unflatten(structure, leaves)
    if shardings is not None:
        tree = place_tree(tree, shardings)
    return tree, step


class AsyncCheckpointer:
    """Background checkpoint writer: one write in flight at a time, the
    ``keep`` newest checkpoints kept."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        # snapshot before the next step
        host = tree_map(_host, tree, is_leaf=is_sharded)

        def work():
            save_checkpoint(self.ckpt_dir, step, host)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        if not os.path.isdir(self.ckpt_dir):
            return
        steps = sorted(
            int(m.group(1)) for d in os.listdir(self.ckpt_dir)
            if (m := re.fullmatch(r"step_(\d+)", d)))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:010d}"),
                          ignore_errors=True)
