"""Checkpointing: atomic, async, retention-managed; the port of
``repro.checkpoint.checkpoint``.

- Atomic: written to ``<dir>/.tmp.<step>``, then ``os.replace``d into
  ``ckpt_{step:010d}``, so a crash mid-save never corrupts the latest
  checkpoint. ``keep`` (3) newest checkpoints are kept.
- Async: ``save_async`` copies every leaf to the host at once (training
  updates its params in place), then writes on a thread.
- Restore on one device: ``restore(..., device=)`` puts every leaf on
  that device (cuda unless "cpu"): the one-card counterpart of the JAX
  package's restore into new shardings. A checkpoint written from the
  card restores on the CPU bit for bit, and the other way round.

A tree is nested dicts (keys in sorted order) and lists whose leaves are
tensors or numpy arrays. A checkpoint holds ``arrays.npz`` (``leaf_<i>``),
``tree.json`` (each leaf's key path and dtype name) and ``meta.json``
(``{"step": ..., **metadata}``). It differs from the JAX package's
format in two ways: the tree is a JSON list of key paths, not a pickled
``PyTreeDef`` (which only JAX can load, and unpickling runs code), and a
bfloat16 leaf is stored as its ``uint16`` bits (numpy has no bfloat16
without ``ml_dtypes``). So neither package reads the other's
checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch import device as device_lib


def _flatten(tree, path=()):
    """[(key path, leaf)] in sorted-key order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k],
                                                            path + (k,))]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, path + (i,))]
    return [(path, tree)]


def _unflatten(paths, leaves):
    """Rebuild the dicts (str keys) and lists (int keys) of ``paths``."""
    root: dict = {}
    for path, leaf in zip(paths, leaves):
        node = root
        keys = ["root"] + list(path)
        for k, nxt in zip(keys[:-1], keys[1:]):
            if isinstance(node, list):
                if k == len(node):
                    node.append([] if isinstance(nxt, int) else {})
                node = node[k]
            else:
                node = node.setdefault(k, [] if isinstance(nxt, int) else {})
        if isinstance(node, list):
            node.append(leaf)
        else:
            node[keys[-1]] = leaf
    return root["root"]


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a copy), bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return np.asarray(leaf).dtype.name


def _snapshot(tree):
    flat = _flatten(tree)
    return ([list(p) for p, _ in flat], [_dtype_name(x) for _, x in flat],
            [_host(x) for _, x in flat])


def _write(ckpt_dir, step, paths, dtypes, arrays, metadata, keep) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp.{step}")
    final = os.path.join(ckpt_dir, f"ckpt_{step:010d}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": a for i, a in enumerate(arrays)})
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump({"paths": paths, "dtypes": dtypes}, f)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, **(metadata or {})}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _apply_retention(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, tree, metadata: dict | None = None,
         keep: int = 3) -> str:
    return _write(ckpt_dir, step, *_snapshot(tree), metadata, keep)


def save_async(ckpt_dir: str, step: int, tree, metadata=None,
               keep: int = 3) -> threading.Thread:
    """Copy every leaf to the host now, write on a thread; join the
    returned thread before the next save or at exit."""
    snap = _snapshot(tree)
    t = threading.Thread(target=_write, args=(ckpt_dir, step, *snap,
                                              metadata, keep), daemon=True)
    t.start()
    return t


def _apply_retention(ckpt_dir: str, keep: int):
    for s in all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"ckpt_{s:010d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("ckpt_"):
            try:
                out.append(int(name.split("_")[1]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int | None = None, device=None):
    """Returns (step, tree, metadata), every leaf a tensor on ``device``
    (cuda unless "cpu") with the dtype it was saved with."""
    dev = device_lib.resolve(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"ckpt_{step:010d}")
    with open(os.path.join(path, "tree.json")) as f:
        spec = json.load(f)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, name in enumerate(spec["dtypes"]):
            a = data[f"leaf_{i}"]
            t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                 if name == "bfloat16" else torch.from_numpy(a))
            if str(t.dtype).removeprefix("torch.") != name:
                raise ValueError(f"{path}: leaf {i} holds {t.dtype}, "
                                 f"tree.json says {name}")
            leaves.append(t.to(dev))
    return step, _unflatten([tuple(p) for p in spec["paths"]], leaves), meta
