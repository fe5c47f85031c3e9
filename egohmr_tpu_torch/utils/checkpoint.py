"""Checkpoints (port of egohmr_tpu/utils/checkpoint.py).

Resumable training state: `save_checkpoint` writes one `.pt` file per
checkpoint (`<dir>/step_<N>.pt`, `<dir>/best_model_vis.pt`) holding a dict
of tensors and plain values, in place of the JAX package's orbax
directories; `latest_checkpoint` finds the newest `step_<N>.pt`. The
training CLI stores the model's `state_dict` in the reference key layout
(which `egohmr_tpu.interop.torch_convert.convert_egohmr` reads), the
trained buffers outside it, the AdamW state and the step.

Flat .npz param trees: the JAX package writes its param trees with
`save_npz`; the port reads them with `load_npz_tree` and turns them into a
`state_dict` with `interop.state_dict_from_jax`. Orbax directories need the
JAX stack and are not read here.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

SUFFIX = ".pt"


def save_checkpoint(path: str, state: Dict[str, Any]) -> str:
    """Write `state` (nested dicts/lists of tensors, numbers and strings) to
    `path` (".pt" appended when missing), through a temporary file and a
    rename, so a run killed while saving leaves the previous checkpoint
    whole. Returns the path written."""
    if not path.endswith(SUFFIX):
        path += SUFFIX
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """Read a checkpoint written by `save_checkpoint`; tensors land on
    `map_location`."""
    return torch.load(path, map_location=map_location, weights_only=True)


def latest_checkpoint(ckpt_dir: str, prefix: str = "step_") -> Optional[str]:
    """The `<prefix><N>.pt` file under `ckpt_dir` with the largest N, or
    None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith(prefix) and name.endswith(SUFFIX):
            n = name[len(prefix):-len(SUFFIX)]
            if n.isdigit():
                steps.append((int(n), name))
    if not steps:
        return None
    return os.path.join(ckpt_dir, max(steps)[1])


def save_npz(path: str, tree: Any) -> None:
    """Write a nested dict/list tree of arrays as one flat .npz with dotted
    keys."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            if node and all(isinstance(k, str) and k.isdigit() for k in node):
                # on reload this level would come back as a list
                raise ValueError(
                    f"save_npz: dict at {prefix!r} is keyed entirely by "
                    "digit strings, which cannot be told from a flattened "
                    "list; rename the keys or use a list")
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
        else:
            flat[prefix[:-1]] = np.asarray(node)

    walk(tree, "")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)


def load_npz_tree(path: str) -> Any:
    """Rebuild the nested tree from a flat .npz written by `save_npz`,
    without a template: dotted segments become dict keys, and a level whose
    keys are exactly the integers 0..n-1 becomes a list. Leaves are NumPy
    arrays."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}

    root: Dict[str, Any] = {}
    for key, val in flat.items():
        node = root
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def convert(node):
        if not isinstance(node, dict):
            return np.array(node)
        out = {k: convert(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            idx = sorted(int(k) for k in out)
            if idx == list(range(len(idx))):
                return [out[str(i)] for i in idx]
        return out

    return convert(root)
