"""Checkpoints of flat-dict params (port of ``repro.checkpoint``).

The reference's layout, so that either package restores the other's:
``<dir>/step_<n:08d>/arrays.npz`` (one array per leaf, nested dict and
NamedTuple keys joined by ``::``) and ``manifest.json`` (step, each array's
shape and dtype, ``extra``). Restore checks every array's shape against the
manifest and rebuilds the template's structure; the template's leaves are
read for nothing else (meta tensors do).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import default_device


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}::"))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}::"))
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        out[prefix.rstrip(":")] = np.asarray(tree)
    return out


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[Dict] = None) -> str:
    """Write ``tree`` (a dict of tensors or arrays, possibly nested) as
    step ``step`` under ``ckpt_dir``; returns the step's directory."""
    path = _step_dir(ckpt_dir, step)
    os.makedirs(path, exist_ok=True)
    flat = _flatten(tree)
    np.savez(os.path.join(path, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in flat.items()},
        "extra": extra or {},
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest step saved under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)$", d))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, template: Any,
                       device=None) -> Any:
    """Step ``step`` of ``ckpt_dir`` in the structure of ``template``, as
    tensors on ``device`` (the card when None)."""
    dev = default_device(device)
    path = _step_dir(ckpt_dir, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}::") for k, v in tree.items()}
        if hasattr(tree, "_fields"):
            return type(tree)(**{k: rebuild(getattr(tree, k),
                                            f"{prefix}{k}::")
                                 for k in tree._fields})
        key = prefix.rstrip(":")
        arr = data[key]
        want = manifest["arrays"][key]
        if list(arr.shape) != want["shape"]:
            raise ValueError(f"{key}: shape {list(arr.shape)} against the "
                             f"manifest's {want['shape']}")
        return torch.from_numpy(np.array(arr)).to(dev)

    return rebuild(template)
