"""SMPL model loading (port of egohmr_tpu/smpl/loader.py: `load_smpl_pkl`,
`create`, `make_synthetic_model`, `make_synthetic_watertight_model`).

`load_smpl_pkl` reads the official SMPL .pkl body files (SMPL_NEUTRAL / MALE /
FEMALE.pkl) without the chumpy dependency, mapping chumpy arrays to plain
NumPy while unpickling. `make_synthetic_model` draws the same
`numpy.random.RandomState` sequence as the JAX original, so both packages
build equal tables from the same seed and the pipeline runs without the
(licence-gated) SMPL files; so does `make_synthetic_watertight_model`, the
closed body that the learned collision nets are distilled on.
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


def _unit_sphere(rings: int, segs: int):
    """UV sphere with outward-wound faces. Returns (verts [N, 3] float32,
    faces [F, 3] int32); N = (rings - 1) * segs + 2."""
    thetas = np.pi * np.arange(1, rings) / rings
    phis = 2 * np.pi * np.arange(segs) / segs
    ring_v = np.stack([
        (np.sin(thetas)[:, None] * np.cos(phis)[None]).ravel(),
        (np.sin(thetas)[:, None] * np.sin(phis)[None]).ravel(),
        np.repeat(np.cos(thetas), segs),
    ], axis=-1)
    verts = np.concatenate(
        [[[0.0, 0.0, 1.0]], ring_v, [[0.0, 0.0, -1.0]]]).astype(np.float32)
    north, south = 0, len(verts) - 1

    def rid(r, s):
        return 1 + r * segs + (s % segs)

    faces = []
    for s in range(segs):  # pole caps
        faces.append([north, rid(0, s), rid(0, s + 1)])
        faces.append([south, rid(rings - 2, s + 1), rid(rings - 2, s)])
    for r in range(rings - 2):  # quad strips
        for s in range(segs):
            a, b = rid(r, s), rid(r, s + 1)
            c, d = rid(r + 1, s), rid(r + 1, s + 1)
            faces.append([a, c, b])
            faces.append([b, c, d])
    faces = np.asarray(faces, np.int32)
    # outward winding (convex and centred: normal . centroid > 0)
    tri = verts[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = (n * tri.mean(axis=1)).sum(-1) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return verts, faces


def make_synthetic_watertight_model(seed: int = 0, rings: int = 10, segs: int = 16,
                                    device=None) -> SMPLModel:
    """SMPL-like body whose mesh is watertight with outward normals: one
    closed ellipsoid per skeleton part, elongated along its bone, rigidly
    skinned to its joint. Unlike `make_synthetic_model`'s random faces it
    has a true inside, so winding-number and normal-signed labels mean
    something on it: the shipped signed occupancy and volsdf artifacts were
    distilled on it. V = 24 * ((rings - 1) * segs + 2); 3504 by default."""
    rng = np.random.RandomState(seed)
    sph_v, sph_f = _unit_sphere(rings, segs)
    nv = len(sph_v)
    V = 24 * nv

    joint_pos = np.zeros((24, 3), np.float32)
    for k in range(1, 24):
        offset = rng.randn(3).astype(np.float32) * 0.12
        joint_pos[k] = joint_pos[C.PARENTS[k]] + offset

    verts, faces, owner = [], [], []
    for k in range(24):
        if k == 0:
            center, axis, half_len = joint_pos[0], np.array([0., 0., 1.], np.float32), 0.09
        else:
            p = joint_pos[C.PARENTS[k]]
            bone = joint_pos[k] - p
            blen = max(float(np.linalg.norm(bone)), 1e-3)
            center = 0.5 * (joint_pos[k] + p)
            axis, half_len = bone / blen, 0.45 * blen
        r_perp = np.clip(0.45 * half_len, 0.02, 0.06)
        # orthonormal frame with `axis` as the long direction
        tmp = np.array([1.0, 0.0, 0.0], np.float32)
        if abs(axis @ tmp) > 0.9:
            tmp = np.array([0.0, 1.0, 0.0], np.float32)
        u = np.cross(axis, tmp)
        u /= np.linalg.norm(u)
        w = np.cross(axis, u)
        frame = np.stack([u * r_perp, w * r_perp, axis * (half_len + r_perp)], axis=0)
        verts.append(sph_v @ frame + center)
        faces.append(sph_f + k * nv)
        owner.append(np.full((nv,), k, np.int64))
    v_template = np.concatenate(verts).astype(np.float32)
    faces = np.concatenate(faces)
    owner = np.concatenate(owner)

    # rigid parts: one-hot skinning to the owning joint
    lbs_weights = np.zeros((V, 24), np.float32)
    lbs_weights[np.arange(V), owner] = 1.0

    # each sphere's vertex mean is its centre, the bone's midpoint for k > 0,
    # so joint_k = 2 * centre_k - joint_parent: the recursion unrolled into
    # linear rows over the template vertices
    mean_row = np.zeros((24, V), np.float32)
    for k in range(24):
        mean_row[k, owner == k] = 1.0 / nv
    j_reg = np.zeros((24, V), np.float32)
    j_reg[0] = mean_row[0]
    for k in range(1, 24):
        j_reg[k] = 2.0 * mean_row[k] - j_reg[C.PARENTS[k]]

    # small smooth deformations keep the mesh closed (connectivity is fixed)
    shapedirs = rng.randn(V, 3, C.NUM_BETAS).astype(np.float32) * 0.005
    posedirs = rng.randn(207, V * 3).astype(np.float32) * 5e-4
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
