"""Body-representation normalisation statistics (port of
egohmr_tpu/data/stats.py).

Over the train split, all GT poses are converted to the 144-d rot6d vector
('diffusion' layout); the mean is per dimension, and the std collapses to two
scalars: one for the 6 global-orient dimensions, one for the 138 body-pose
dimensions.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from ..geometry import aa_to_rotmat, rotmat_to_rot6d


def compute_body_rep_stats(
    global_orient: np.ndarray,  # [N, 3] axis-angle
    body_pose: np.ndarray,      # [N, 69]
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (Xmean [144], Xstd [144])."""
    n = global_orient.shape[0]
    aa = np.concatenate([global_orient.reshape(n, 1, 3),
                         body_pose.reshape(n, 23, 3)], axis=1)
    rotmat = aa_to_rotmat(torch.tensor(aa.reshape(-1, 3).astype(np.float32)))
    rot6d = rotmat_to_rot6d(rotmat, "diffusion").reshape(n, 144).numpy()
    mean = rot6d.mean(axis=0)
    std = rot6d.std(axis=0)
    std[0:6] = std[0:6].mean()
    std[6:] = std[6:].mean()
    return mean.astype(np.float32), std.astype(np.float32)


def save_stats(path: str, mean: np.ndarray, std: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, Xmean=mean, Xstd=std)


def load_stats(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with np.load(path) as z:
        return z["Xmean"].astype(np.float32), z["Xstd"].astype(np.float32)
