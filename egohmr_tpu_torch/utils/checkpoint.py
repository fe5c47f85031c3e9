"""Flat .npz param trees (port of egohmr_tpu/utils/checkpoint.py:`save_npz`
and `load_npz_tree`, NumPy only).

The JAX package writes its param trees with `save_npz`; the port reads them
with `load_npz_tree` and turns them into a `state_dict` with
`interop.state_dict_from_jax`. Orbax directories need the JAX stack and are
not read here.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np


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
