"""Async, atomic checkpointing (the port of
``repro.checkpoint.checkpoint``, in its layout, so either package reads
the other's checkpoints).

Layout:  <dir>/step_<N>/
           manifest.json        leaf count, shapes, dtypes
           leaf_<i>.npy         one array per tree leaf
         <dir>/step_<N>.tmp...  staging dir, atomically renamed on publish

Leaves are numbered in ``jax.tree.flatten`` order (dict keys sorted,
sequences in order: ``models.params.tree_leaves``).  bfloat16 leaves are
stored as their uint16 view, the manifest recording the true dtype.

Contract:
  * writes go to a tmp dir; ``manifest.json`` is written LAST and the dir
    is atomically renamed, so a crash mid-write never leaves a checkpoint
    that ``latest_step`` would pick up;
  * ``save_async`` copies the tree to host memory synchronously (later
    in-place updates of the tensors do not reach the checkpoint) and
    writes it on a background thread;
  * ``keep`` bounds disk usage (the oldest are pruned after a publish);
  * ``restore`` places each leaf on the device of the matching leaf of
    ``like``, or with ``shardings`` (a tree of
    ``launch.sharding.NamedSharding``) distributes it over that mesh as a
    DTensor: a restore onto any mesh (elastic);
  * a DTensor leaf is saved whole (``full_tensor``: every rank of its
    mesh takes part in the snapshot).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.params import tree_flatten, tree_unflatten

#: numpy has no bfloat16: those leaves travel as their 16-bit payload
_BF16 = "bfloat16"


def _is_leaf(x) -> bool:
    return torch.is_tensor(x) or isinstance(x, np.ndarray) \
        or np.isscalar(x)


def _to_host(leaf):
    """-> (a host copy to store, the leaf's true dtype name)."""
    if torch.is_tensor(leaf):
        if hasattr(leaf, "full_tensor"):          # a DTensor: gather it
            leaf = leaf.full_tensor()
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().view(np.uint16)
            return bits.copy(), _BF16
        arr = t.numpy().copy()
        return arr, arr.dtype.name
    arr = np.asarray(leaf)
    return arr.copy(), arr.dtype.name


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ----- write ---------------------------------------------------------
    def save(self, step: int, tree: Any):
        self._write(step, self._snapshot(tree))

    def save_async(self, step: int, tree: Any):
        self.wait()
        host = self._snapshot(tree)

        def _run():
            try:
                self._write(step, host)
            except BaseException as e:    # noqa: BLE001 — raised in wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    @staticmethod
    def _snapshot(tree):
        """-> (host arrays, dtype names, treedef) in flatten order."""
        leaves, treedef = tree_flatten(tree, _is_leaf)
        host = [_to_host(leaf) for leaf in leaves]
        return [a for a, _ in host], [d for _, d in host], treedef

    def _write(self, step: int, snapshot):
        arrays, dtypes, treedef = snapshot
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + f".tmp{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        for i, arr in enumerate(arrays):
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr,
                    allow_pickle=False)
        manifest = {
            "step": step,
            "n_leaves": len(arrays),
            "treedef": repr(treedef),
            "shapes": [list(a.shape) for a in arrays],
            "dtypes": dtypes,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._prune()

    def _prune(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # ----- read ----------------------------------------------------------
    def all_steps(self) -> list:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.count(".tmp"):
                path = os.path.join(self.directory, name, "manifest.json")
                if os.path.exists(path):     # only complete checkpoints
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, shardings: Any = None) -> Any:
        """Load step ``step`` into the structure of ``like`` (a tree of
        tensors): each leaf a tensor of the stored dtype on the device of
        ``like``'s leaf.  With ``shardings`` (the same tree of
        ``NamedSharding``) each leaf is instead distributed over the
        sharding's mesh (``distribute_tensor`` with its placements, from
        the mesh's device).  A leaf count or shape that differs raises
        ValueError."""
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves_like, treedef = tree_flatten(like, _is_leaf)
        if manifest["n_leaves"] != len(leaves_like):
            raise ValueError(f"checkpoint step {step} holds "
                             f"{manifest['n_leaves']} leaves, the tree "
                             f"{len(leaves_like)}")
        loaded = []
        for i, ref in enumerate(leaves_like):
            arr = np.load(os.path.join(d, f"leaf_{i}.npy"))
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i}: checkpoint {arr.shape} vs "
                                 f"expected {tuple(ref.shape)}")
            if manifest["dtypes"][i] == _BF16:
                t = torch.from_numpy(arr.view(np.int16)).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(
                    arr.astype(np.dtype(manifest["dtypes"][i]), copy=False))
            device = ref.device if torch.is_tensor(ref) else "cpu"
            loaded.append(t.to(device))
        tree = tree_unflatten(treedef, loaded)
        if shardings is not None:
            from torch.distributed.tensor import distribute_tensor
            from repro_torch.launch.sharding import is_sharding
            flat, _ = tree_flatten(shardings, is_sharding)
            if len(flat) != len(loaded):
                raise ValueError(f"{len(flat)} shardings for "
                                 f"{len(loaded)} leaves")
            tree = tree_unflatten(treedef, [
                distribute_tensor(t.to(sh.mesh.device_type), sh.mesh,
                                  sh.placements)
                for t, sh in zip(loaded, flat)])
        return tree

    def restore_latest(self, like: Any, shardings: Any = None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like, shardings)
