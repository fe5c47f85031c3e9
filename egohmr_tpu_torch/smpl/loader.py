"""SMPL model loading (port of egohmr_tpu/smpl/loader.py: `load_smpl_pkl`,
`create`, `make_synthetic_model`).

`load_smpl_pkl` reads the official SMPL .pkl body files (SMPL_NEUTRAL / MALE /
FEMALE.pkl) without the chumpy dependency, mapping chumpy arrays to plain
NumPy while unpickling. `make_synthetic_model` draws the same
`numpy.random.RandomState` sequence as the JAX original, so both packages
build equal tables from the same seed and the pipeline runs without the
(licence-gated) SMPL files.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from . import constants as C
from .model import SMPLModel


class _ChumpyTolerantUnpickler(pickle.Unpickler):
    """Unpickler that turns chumpy arrays into NumPy arrays."""

    def find_class(self, module, name):
        if module.startswith("chumpy"):
            class _FakeCh(np.ndarray):
                pass

            return _FakeCh
        if module in ("scipy.sparse.csc", "scipy.sparse._csc"):
            import scipy.sparse

            return getattr(scipy.sparse, name)
        return super().find_class(module, name)


def _to_np(x) -> np.ndarray:
    if hasattr(x, "toarray"):  # scipy sparse
        return np.asarray(x.toarray())
    return np.asarray(x)


def load_smpl_pkl(path: str, num_betas: int = C.NUM_BETAS, device=None) -> SMPLModel:
    """Load an official SMPL pickle into an `SMPLModel` (arrays copied)."""
    with open(path, "rb") as f:
        data = _ChumpyTolerantUnpickler(f, encoding="latin1").load()

    posedirs = _to_np(data["posedirs"]).astype(np.float32)
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T  # [207, V*3]

    def t(a, dtype=torch.float32):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return SMPLModel(
        v_template=t(_to_np(data["v_template"])),
        shapedirs=t(_to_np(data["shapedirs"])[:, :, :num_betas]),
        posedirs=t(posedirs),
        j_regressor=t(_to_np(data["J_regressor"])),
        lbs_weights=t(_to_np(data["weights"])),
        parents=t(C.PARENTS, torch.int64),
        faces=t(_to_np(data["f"]).astype(np.int64), torch.int64),
        extra_joint_ids=t(C.EXTRA_JOINT_VERTEX_IDS, torch.int64),
    )


_GENDER_FILES = {
    "neutral": "SMPL_NEUTRAL.pkl",
    "male": "SMPL_MALE.pkl",
    "female": "SMPL_FEMALE.pkl",
}


def create(model_path: str, gender: str = "neutral", device=None) -> SMPLModel:
    """smplx.create-style entry point: `model_path` is a directory holding
    the gendered files (directly or under `smpl/`), or one file."""
    if os.path.isdir(model_path):
        candidates = [
            os.path.join(model_path, _GENDER_FILES[gender]),
            os.path.join(model_path, "smpl", _GENDER_FILES[gender]),
            os.path.join(model_path, _GENDER_FILES[gender].lower()),
        ]
        for c in candidates:
            if os.path.exists(c):
                return load_smpl_pkl(c, device=device)
        raise FileNotFoundError(
            f"no SMPL body file for gender={gender} under {model_path}")
    return load_smpl_pkl(model_path, device=device)


def make_synthetic_model(seed: int = 0, num_vertices: int = 512,
                         num_faces: int = 1020, device=None) -> SMPLModel:
    """SMPL-like model with the real 24-joint tree, convex skinning weights
    dominated by the nearest joint and small random blendshapes."""
    rng = np.random.RandomState(seed)
    V = num_vertices

    joint_pos = np.zeros((24, 3), np.float32)
    for k in range(1, 24):
        offset = rng.randn(3).astype(np.float32) * 0.12
        joint_pos[k] = joint_pos[C.PARENTS[k]] + offset

    owner = rng.randint(0, 24, size=V)
    v_template = joint_pos[owner] + rng.randn(V, 3).astype(np.float32) * 0.06

    d2 = ((v_template[:, None, :] - joint_pos[None]) ** 2).sum(-1)
    logits = -d2 / 0.02
    logits -= logits.max(axis=1, keepdims=True)
    w = np.exp(logits)
    lbs_weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)

    j_reg = np.zeros((24, V), np.float32)
    for k in range(24):
        idx = np.where(owner == k)[0]
        if len(idx) == 0:
            idx = np.array([k % V])
        j_reg[k, idx] = 1.0 / len(idx)

    shapedirs = rng.randn(V, 3, C.NUM_BETAS).astype(np.float32) * 0.01
    posedirs = rng.randn(207, V * 3).astype(np.float32) * 1e-3
    faces = rng.randint(0, V, size=(num_faces, 3))
    extra_ids = C.EXTRA_JOINT_VERTEX_IDS % V

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return SMPLModel(
        v_template=t(v_template),
        shapedirs=t(shapedirs),
        posedirs=t(posedirs),
        j_regressor=t(j_reg),
        lbs_weights=t(lbs_weights),
        parents=t(C.PARENTS, torch.int64),
        faces=t(faces, torch.int64),
        extra_joint_ids=t(extra_ids, torch.int64),
    )
