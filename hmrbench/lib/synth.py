"""The benchmark's inputs, body tables and weights, made from the seed.

Frozen copies, so that what a cell feeds does not move when the program
does:

* `batches` draws EgoBody-shaped batches with the distributions of
  egohmr_tpu_torch/data/synthetic.py:synthetic_batch, on the card from a
  `torch.Generator` in a few large calls, and hands them over as NumPy
  (what a server receives);
* `synthetic_smpl` is egohmr_tpu_torch/smpl/loader.py:make_synthetic_model
  and `closed_body` is chip_smoke.py:closed_body_model: SMPL-shaped tables
  at V=6890 with a closed surface, so that the signed distance has an
  inside and an outside;
* `weights` follows egohmr_tpu_torch/models/egohmr.py:init_random_; stage
  1's flow steps (flow/glow.py's ActNorm and LU linear map) are drawn near
  the identity; every leaf comes from two flat draws on the card.

The tables are plain tensors in a dict; the drivers turn them into the
program's types.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
    dtype=np.int64)
# smplx's 'smplh' vertex ids of the 21 extra joints (the 45-joint output)
EXTRA_JOINT_VERTEX_IDS = np.array(
    [332, 6260, 2800, 4071, 583, 3216, 3226, 3387, 6617, 6624, 6787,
     2746, 2319, 2445, 2556, 2673, 6191, 5782, 5905, 6016, 6133], dtype=np.int64)
NUM_BETAS = 10


# ------------------------------------------------------------------ inputs
def batches(n: int, batch_size: int, *, scene_points: int, img_size: int, seed: int,
            device: torch.device) -> List[Dict]:
    """`n` distinct batches of `batch_size` images. Every seed gives the
    same sizes; the seed moves the values only."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    N, P = n * batch_size, scene_points

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    transl = torch.tensor([0.0, 0.0, 2.5], device=device) + randn(N, 3) * 0.2
    kp2d = torch.cat([rand(N, 25, 2) - 0.5, (rand(N, 25, 1) > 0.2).float()], dim=-1)
    full = {
        "img": randn(N, img_size, img_size, 3) * 0.5,
        "orig_keypoints_2d": kp2d,
        "keypoints_2d": kp2d.clone(),
        "keypoints_3d": randn(N, 24, 3) * 0.3,
        "keypoints_3d_full": randn(N, 24, 3) * 0.3 + transl[:, None],
        "smpl_params": {
            "global_orient": randn(N, 3) * 0.3,
            "body_pose": randn(N, 69) * 0.2,
            "betas": randn(N, 10) * 0.5,
            "transl": transl,
        },
        "gender": (rand(N) < 0.5).to(torch.int32),
        "fx": torch.ones(N, device=device),
        "fy": torch.ones(N, device=device),
        "cam_cx": torch.full((N,), 960.0, device=device),
        "cam_cy": torch.full((N,), 540.0, device=device),
        "box_center": rand(N, 2) * 1000 + 400,
        "box_size": rand(N) * 100 + 200,
        "scene_pcd_verts_full": randn(N, P, 3) + transl[:, None],
    }

    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        part = tree[i * batch_size:(i + 1) * batch_size]
        return part.cpu().numpy().copy()

    return [take(full, i) for i in range(n)]


def to_device(tree, device: torch.device):
    """A batch of NumPy arrays as tensors on `device` (the reference's copy)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.from_numpy(np.asarray(tree)).to(device)


# ----------------------------------------------------------- SMPL tables
def synthetic_smpl(seed: int = 0, num_vertices: int = 512,
                   num_faces: int = 1020) -> Dict[str, np.ndarray]:
    """SMPL-like tables with the real 24-joint tree, convex skinning
    weights dominated by the nearest joint and small random blendshapes."""
    rng = np.random.RandomState(seed)
    V = num_vertices
    joint_pos = np.zeros((24, 3), np.float32)
    for k in range(1, 24):
        joint_pos[k] = joint_pos[PARENTS[k]] + rng.randn(3).astype(np.float32) * 0.12
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
    shapedirs = rng.randn(V, 3, NUM_BETAS).astype(np.float32) * 0.01
    posedirs = rng.randn(207, V * 3).astype(np.float32) * 1e-3
    faces = rng.randint(0, V, size=(num_faces, 3))
    return {"v_template": v_template, "shapedirs": shapedirs, "posedirs": posedirs,
            "j_regressor": j_reg, "lbs_weights": lbs_weights,
            "parents": PARENTS.copy(), "faces": faces.astype(np.int64),
            "extra_joint_ids": EXTRA_JOINT_VERTEX_IDS % V}


def closed_body(rings: int = 82, slices: int = 84) -> Dict[str, np.ndarray]:
    """The synthetic tables with a closed surface: an ellipsoid of 2 + rings
    x slices vertices (6890, with SMPL's 13,776 faces, at the defaults)
    around the synthetic skeleton, skinned to its nearest joints, with
    blend shapes that keep the surface smooth."""
    V = 2 + rings * slices
    base = synthetic_smpl(num_vertices=V, num_faces=8)
    phi = np.pi * np.arange(1, rings + 1) / (rings + 1)
    th = 2 * np.pi * np.arange(slices) / slices
    ring = np.stack([np.outer(np.sin(phi), np.cos(th)), np.outer(np.sin(phi), np.sin(th)),
                     np.outer(np.cos(phi), np.ones(slices))], -1).reshape(-1, 3)
    unit = np.concatenate([[[0.0, 0.0, 1.0]], ring, [[0.0, 0.0, -1.0]]]).astype(np.float32)
    joints = base["j_regressor"] @ base["v_template"]
    v = unit * np.array([0.3, 0.5, 0.2], np.float32) + joints.mean(0)

    def r(i, j):
        return 1 + i * slices + j % slices

    faces = [(0, r(0, j), r(0, j + 1)) for j in range(slices)]
    for i in range(rings - 1):
        for j in range(slices):
            a, b, c, d = r(i, j), r(i, j + 1), r(i + 1, j), r(i + 1, j + 1)
            faces += [(a, c, b), (b, c, d)]
    faces += [(V - 1, r(rings - 1, j + 1), r(rings - 1, j)) for j in range(slices)]
    d2 = ((v[:, None] - joints[None]) ** 2).sum(-1)
    w = np.exp(-(d2 - d2.min(1, keepdims=True)) / 0.02)
    j_reg = np.zeros((24, V), np.float32)
    for k in range(24):
        own = np.where(d2.argmin(1) == k)[0]
        own = own if len(own) else np.array([k % V])
        j_reg[k, own] = 1.0 / len(own)
    rng = np.random.RandomState(0)
    shapedirs = 1e-2 * unit[:, :, None] * (unit @ rng.randn(3, 10))[:, None, :]
    posedirs = 1e-3 * (unit @ rng.randn(3, 207)).T[:, :, None] * unit[None]
    return dict(base,
                shapedirs=shapedirs.astype(np.float32),
                posedirs=posedirs.reshape(207, V * 3).astype(np.float32),
                v_template=v.astype(np.float32),
                faces=np.asarray(faces, np.int64),
                lbs_weights=(w / w.sum(1, keepdims=True)).astype(np.float32),
                j_regressor=j_reg)


def body_tables(spec: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The configuration's body tables (`spec`: its "smpl" group) as
    tensors on `device`, in SMPLModel's field order."""
    if spec.get("closed_body"):
        t = closed_body(**spec["closed_body"])
    else:
        t = synthetic_smpl(num_vertices=spec["num_vertices"])
    if t["v_template"].shape[0] != spec["num_vertices"]:
        raise ValueError(f"body tables hold {t['v_template'].shape[0]} vertices, "
                         f"the configuration {spec['num_vertices']}")
    order = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights",
             "parents", "faces", "extra_joint_ids")
    return {k: torch.as_tensor(np.asarray(t[k])).to(device) for k in order}


# ----------------------------------------------------------------- weights
def _rules(model: torch.nn.Module) -> List[Tuple[str, str, float, float]]:
    """(state-dict key, kind, scale, offset) for every tensor of `model`'s
    state dict: value = offset + scale * u, u uniform in [-1, 1) ("u"), in
    [0, 1) ("u01"), standard normal ("n"), or a constant ("c", the
    offset). The module kinds are those of init_random_, told apart by the
    module's class name."""
    rules = []
    for prefix, m in model.named_modules():
        kind = type(m).__name__
        p = prefix + "." if prefix else ""
        own = dict(m.named_parameters(recurse=False))
        own.update(m.named_buffers(recurse=False))
        if kind == "Linear":
            bound = 1.0 / math.sqrt(m.in_features)
            rules.append((p + "weight", "u", bound, 0.0))
            if m.bias is not None:
                rules.append((p + "bias", "u", bound, 0.0))
        elif kind == "Conv2d" and m.bias is not None:
            bound = 1.0 / math.sqrt(m.in_channels)
            rules += [(p + "weight", "u", bound, 0.0), (p + "bias", "u", bound, 0.0)]
        elif kind == "Conv2d":
            n = m.kernel_size[0] * m.kernel_size[1] * m.out_channels
            rules.append((p + "weight", "n", math.sqrt(2.0 / n), 0.0))
        elif kind == "ModulatedGraphConv":
            for name in ("W", "M"):
                fan_in, fan_out = own[name].shape[-2], own[name].shape[-1]
                rules.append((p + name, "u", 1.414 * math.sqrt(6.0 / (fan_in + fan_out)), 0.0))
            rules.append((p + "adj2", "c", 0.0, 1e-6))
            rules.append((p + "bias", "u", 1.0 / math.sqrt(own["bias"].shape[0]), 0.0))
        elif kind.startswith("BatchNorm"):
            rules += [(p + "weight", "n", 0.1, 1.0), (p + "bias", "n", 0.1, 0.0),
                      (p + "running_mean", "n", 0.1, 0.0),
                      (p + "running_var", "u01", 0.1, 1.0)]
        elif kind == "FCHeadBeta":
            rules.append((p + "init_betas", "c", 0.0, 0.0))
        elif kind == "ActNorm":
            # near the identity, as the data-dependent init leaves it
            rules += [(p + "log_scale", "n", 0.1, 0.0), (p + "shift", "n", 0.1, 0.0)]
        elif kind == "LULinear":
            # near the identity: small triangles, diagonal softplus(d) + eps near 1
            rules += [(p + "lower_entries", "u", 0.02, 0.0),
                      (p + "upper_entries", "u", 0.02, 0.0),
                      (p + "unconstrained_upper_diag", "n", 0.1,
                       math.log(math.exp(1.0 - m.eps) - 1.0)),
                      (p + "bias", "n", 0.1, 0.0)]
    return rules


@torch.no_grad()
def weights(model: torch.nn.Module, seed: int, device: torch.device, *,
            extra_rules=()) -> Dict[str, torch.Tensor]:
    """A state dict for `model` (whose structure it reads), drawn from
    `seed` on `device` with a `torch.Generator` in two flat draws, in f32.
    `extra_rules` (key, kind, scale, offset) take the place of the module
    kinds' rules for their keys. Keys that no rule covers keep the
    model's own values (constant tables such as SMPL-derived buffers)."""
    sd = model.state_dict()
    extra = {r[0]: r for r in extra_rules}
    rules = [extra.pop(r[0], r) for r in _rules(model) if r[0] in sd]
    rules += list(extra.values())
    g = torch.Generator(device=device).manual_seed(int(seed))
    n_u = sum(sd[k].numel() for k, kind, _, _ in rules if kind in ("u", "u01"))
    n_n = sum(sd[k].numel() for k, kind, _, _ in rules if kind == "n")
    flat_u = torch.rand(n_u, generator=g, device=device)
    flat_n = torch.randn(n_n, generator=g, device=device)
    out = {k: v.detach().to(device).clone() for k, v in sd.items()}
    iu = i_n = 0
    for key, kind, scale, off in rules:
        t = out[key]
        n = t.numel()
        if kind == "u":
            vals = (flat_u[iu:iu + n] * 2 - 1) * scale + off
            iu += n
        elif kind == "u01":
            vals = flat_u[iu:iu + n] * scale + off
            iu += n
        elif kind == "n":
            vals = flat_n[i_n:i_n + n] * scale + off
            i_n += n
        else:
            vals = torch.full((n,), off, device=device)
        out[key] = vals.view(t.shape).to(t.dtype)
    return out

