"""Batch padding (port of egohmr_tpu/data/batching.py), on torch tensors and
NumPy arrays."""
from __future__ import annotations

import numpy as np
import torch


def pad_batch(b, target: int):
    """Pad a short batch to `target` rows by repeating the last item.

    Works on nested dict/list/tensor/array trees (leading axis = batch);
    the caller drops the padded rows from its results."""
    if isinstance(b, dict):
        return {k: pad_batch(v, target) for k, v in b.items()}
    if isinstance(b, list):
        return b + [b[-1]] * (target - len(b))
    pad_n = target - b.shape[0]
    if isinstance(b, np.ndarray):
        return np.concatenate([b, np.repeat(b[-1:], pad_n, axis=0)])
    return torch.cat([b, b[-1:].expand(pad_n, *b.shape[1:])])
