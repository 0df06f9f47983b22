"""Fault-tolerant, mesh-elastic checkpointing (counterpart of
``repro.ckpt.checkpoint``), in the reference's on-disk layout, so each
package restores the other's checkpoints.

Layout:  <dir>/step_<N>/
            manifest.json        — step, leaf count, each leaf's dtype and
                                   shape, and ``extra`` (the data
                                   pipeline's state)
            arr_<i>.npy          — one file per leaf, in ``jax.tree``'s
                                   order (``pytree.flatten``: dict keys
                                   sorted, NamedTuples by field); a
                                   bfloat16 leaf is stored as its uint16
                                   bits under the dtype name "bfloat16"

Guarantees:
  * atomic: written to step_<N>.tmp, the manifest fsynced, then renamed —
    a crash mid-save never corrupts the latest checkpoint.
  * elastic: leaves are stored whole with no mesh metadata;
    ``restore_checkpoint(..., mesh, spec_tree)`` places them under any
    mesh.
  * retention: keep the newest ``keep`` checkpoints, best-effort cleanup.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

from ..kernels.runtime import resolve_device
from ..parallel.sharding import tree_shardings
from ..pytree import flatten, leaves, unflatten

_BF16 = "bfloat16"


def _to_numpy(leaf) -> tuple:
    """(array to write, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if str(arr.dtype) != dtype_name:            # raw-viewed bfloat16
        if dtype_name != _BF16 or arr.dtype.itemsize != 2:
            raise ValueError(f"unsupported checkpoint dtype {dtype_name}")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(directory: str, step: int, tree,
                    extra: Optional[dict] = None, keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = leaves(tree)
    manifest = {
        "step": step,
        "treedef": None,
        "n_leaves": len(flat),
        "leaves": [],
        "extra": extra or {},
    }
    for i, leaf in enumerate(flat):
        arr, dtype_name = _to_numpy(leaf)
        np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
        manifest["leaves"].append({"dtype": dtype_name,
                                   "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _cleanup(directory, keep)
    return final


def _cleanup(directory: str, keep: int):
    steps = sorted(_all_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        try:
            shutil.rmtree(os.path.join(directory, f"step_{s:08d}"))
        except OSError:
            pass


def _all_steps(directory: str):
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            path = os.path.join(directory, name, "manifest.json")
            if os.path.exists(path):
                out.append(int(name[5:]))
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = _all_steps(directory)
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, like_tree, mesh=None,
                       spec_tree=None, device=None):
    """Restore into the structure of ``like_tree``. With ``mesh`` and
    ``spec_tree`` each leaf goes where its sharding puts it (elastic
    re-shard: the mesh's root); otherwise to ``device`` (None: the card).
    Each leaf keeps the checkpoint's dtype. Returns (tree, extra).

    Raises AssertionError, as the reference does, when the leaf count or
    a leaf's shape differs from ``like_tree``'s."""
    flat_like, treedef = flatten(like_tree)
    if mesh is not None and spec_tree is not None:
        targets = [s.device for s in leaves(tree_shardings(mesh, spec_tree))]
        if len(targets) != len(flat_like):
            raise ValueError(f"spec_tree has {len(targets)} leaves, the "
                             f"tree {len(flat_like)}")
    else:
        targets = [resolve_device(device)] * len(flat_like)
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if len(flat_like) != manifest["n_leaves"]:
        raise AssertionError(
            f"checkpoint has {manifest['n_leaves']} leaves, model expects "
            f"{len(flat_like)} — architecture/optimizer mismatch")
    out = []
    for i, (like, dev) in enumerate(zip(flat_like, targets)):
        arr = np.load(os.path.join(path, f"arr_{i}.npy"))
        if list(arr.shape) != list(like.shape):
            raise AssertionError(f"leaf {i}: checkpoint shape {arr.shape} "
                                 f"!= model {tuple(like.shape)}")
        out.append(_from_numpy(arr, manifest["leaves"][i]["dtype"]).to(dev))
    return unflatten(treedef, out), manifest.get("extra", {})
