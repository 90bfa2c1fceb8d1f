"""Atomic checkpoints of a training state, in the JAX package's on-disk
layout (``src/repro/train/checkpoint.py``), so either package reads the
other's files:

    ckpt_dir/step_00000123.tmp/   ← written first
        manifest.json            tree structure, shapes, dtypes, extra state
        arrays/<leafpath>.npy    one file per leaf
    ckpt_dir/step_00000123/      ← atomic rename on completion

* **Atomicity**: a crash mid-write leaves only a ``.tmp`` directory,
  which restore ignores and the next save garbage-collects.
* **Retention**: keeps the newest ``keep`` checkpoints.
* **Leaf keys** are tree paths joined by "/" (:func:`repro_torch.tree.path_key`):
  ``params/layers/3/attn/wq`` here, ``params/stacks/0/b0/attn/wq`` (a
  stacked leaf) in the reference's files.  :func:`read_checkpoint` gives
  any checkpoint back as a nested tree of numpy arrays, which
  :func:`repro_torch.models.convert.train_state_from_jax` turns into the
  port's state.

* **Elastic restore**: leaves are stored whole, so a checkpoint restores
  onto any mesh — ``restore_checkpoint(..., shardings=)`` places each
  leaf with ``distribute_tensor`` (the reference's ``device_put``).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths, map_tree, path_key

__all__ = ["save_checkpoint", "restore_checkpoint", "read_checkpoint",
           "latest_step"]


def _to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def save_checkpoint(ckpt_dir, step: int, tree, extra: Optional[Dict] = None,
                    keep: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    (tmp / "arrays").mkdir(parents=True)

    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for path, leaf in leaves_with_paths(tree):
        key = path_key(path)
        arr = _to_numpy(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(tmp / "arrays" / fname, arr)
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": str(arr.dtype)}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit

    # retention + stale tmp GC
    steps = sorted(p for p in ckpt_dir.iterdir() if p.name.startswith("step_"))
    for p in steps:
        if p.suffix == ".tmp" and p != tmp:
            shutil.rmtree(p, ignore_errors=True)
    done = [p for p in steps if p.suffix != ".tmp"]
    for p in done[:-keep]:
        shutil.rmtree(p, ignore_errors=True)
    return final


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in ckpt_dir.iterdir()
        if p.name.startswith("step_") and p.suffix != ".tmp"
        and (p / "manifest.json").exists()
    ]
    return max(steps) if steps else None


def _open(ckpt_dir, step: Optional[int]):
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    return d, step, json.loads((d / "manifest.json").read_text())


def restore_checkpoint(ckpt_dir, tree_like, step: Optional[int] = None,
                       device=None, shardings=None) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_like`` (any leaves: tensors,
    shape-only tensors or None), each leaf in its stored dtype on
    ``device`` (default: its counterpart's device, else the CPU).
    ``shardings``, a tree of the same structure of
    :class:`~repro_torch.distributed.sharding.NamedSharding`, re-shards
    each leaf onto its mesh instead: a DTensor of its placements on the
    mesh's device type (the elastic-scaling path)."""
    d, step, manifest = _open(ckpt_dir, step)
    if shardings is None:
        shardings = map_tree(lambda _: None, tree_like)

    def load(path, like, sh):
        meta = manifest["leaves"][path_key(path)]
        a = torch.from_numpy(np.load(d / "arrays" / meta["file"]))
        if sh is not None:
            from torch.distributed.tensor import distribute_tensor

            return distribute_tensor(a.to(sh.mesh.device_type), sh.mesh,
                                     sh.placements)
        dev = device if device is not None else (
            like.device if isinstance(like, torch.Tensor)
            and like.device.type != "meta" else "cpu")
        return a.to(dev)

    return (map_tree(load, tree_like, shardings, with_path=True), step,
            manifest["extra"])


def read_checkpoint(ckpt_dir, step: Optional[int] = None
                    ) -> Tuple[Any, int, Dict]:
    """Any checkpoint in this layout (the JAX package's too) as a nested
    tree of numpy arrays built from its leaf keys: a key's numeric parts
    are list indices, the others dict keys."""
    d, step, manifest = _open(ckpt_dir, step)
    root: Dict[str, Any] = {}
    for key, meta in manifest["leaves"].items():
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.load(d / "arrays" / meta["file"])

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root), step, manifest["extra"]
