"""SMPL linear blend skinning in PyTorch (port of egohmr_tpu/smpl/model.py).

All float32. On the card, matmuls must run without TF32
(`torch.backends.cuda.matmul.allow_tf32 = False`, the PyTorch default) to
keep the JAX package's `precision="highest"` numerics.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..geometry import aa_to_rotmat
from . import constants as C


class SMPLModel(NamedTuple):
    """Static SMPL tables as tensors (all on one device)."""

    v_template: torch.Tensor      # [V, 3]
    shapedirs: torch.Tensor       # [V, 3, n_betas]
    posedirs: torch.Tensor        # [207, V*3]
    j_regressor: torch.Tensor     # [24, V]
    lbs_weights: torch.Tensor     # [V, 24]
    parents: torch.Tensor         # [24] int64
    faces: torch.Tensor           # [F, 3] int64
    extra_joint_ids: torch.Tensor  # [21] int64

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    def to(self, device) -> "SMPLModel":
        return SMPLModel(*(t.to(device) for t in self))


@functools.lru_cache(maxsize=None)
def _bottom_row(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The [0, 0, 0, 1] row of a homogeneous transform, on the device once
    (a copy from pageable host memory per call would stall the stream)."""
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


class SMPLOutput(NamedTuple):
    vertices: torch.Tensor     # [B, V, 3]
    joints: torch.Tensor       # [B, 45, 3]
    full_pose: torch.Tensor    # [B, 24, 3, 3]
    joints_smpl: torch.Tensor  # [B, 24, 3]


def _rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                     parents_dev: torch.Tensor):
    """Forward kinematics down the 24-joint chain.

    rot_mats [B, 24, 3, 3], joints [B, 24, 3] rest pose, parents_dev the
    parent table on the joints' device. Returns (posed_joints [B, 24, 3],
    rel_transforms [B, 24, 4, 4]). Built from concatenations only, with no
    in-place write, so autograd differentiates it w.r.t. both inputs."""
    parents = C.PARENTS.tolist()
    rel_joints = torch.cat([joints[:, :1],
                            joints[:, 1:] - joints[:, parents_dev[1:]]], dim=1)
    top = torch.cat([rot_mats, rel_joints[..., None]], dim=-1)       # [B,24,3,4]
    bottom = _bottom_row(top.device, top.dtype).expand(*top.shape[:2], 1, 4)
    transforms_mat = torch.cat([top, bottom], dim=-2)                 # [B,24,4,4]

    chain = [transforms_mat[:, 0]]
    for k in range(1, len(parents)):
        chain.append(torch.matmul(chain[parents[k]], transforms_mat[:, k]))
    chain = torch.stack(chain, dim=1)

    posed_joints = chain[:, :, :3, 3]
    # subtract the skeleton-induced translation of the rest joints: only
    # the translation column of the top three rows changes
    correction = torch.einsum("bkij,bkj->bki", chain[:, :, :3, :3], joints)
    rel_top = torch.cat([chain[:, :, :3, :3],
                         (posed_joints - correction)[..., None]], dim=-1)
    return posed_joints, torch.cat([rel_top, chain[:, :, 3:]], dim=-2)


def lbs_transforms(model: SMPLModel, betas: torch.Tensor, rot_mats: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pose-dependent core shared by full and selective skinning.

    rot_mats [B, 24, 3, 3]. Returns (v_shaped [B, V, 3], pose_feature
    [B, 207], posed_joints [B, 24, 3], rel_transforms [B, 24, 4, 4])."""
    B = betas.shape[0]
    v_shaped = model.v_template[None] + torch.einsum(
        "bl,vcl->bvc", betas, model.shapedirs)
    joints_rest = torch.einsum("jv,bvc->bjc", model.j_regressor, v_shaped)
    ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)          # [B, 207]
    posed_joints, rel_transforms = _rigid_transform(rot_mats, joints_rest,
                                                    model.parents)
    return v_shaped, pose_feature, posed_joints, rel_transforms


def lbs(
    model: SMPLModel,
    betas: torch.Tensor,
    global_orient: torch.Tensor,
    body_pose: torch.Tensor,
    transl: Optional[torch.Tensor] = None,
    pose2rot: bool = True,
) -> SMPLOutput:
    """SMPL forward pass (smplx semantics, 45-joint output).

    betas [B, 10]; global_orient [B, 1, 3, 3] or [B, 3] (axis-angle when
    pose2rot); body_pose [B, 23, 3, 3] or [B, 69]; transl [B, 3] or None."""
    B = betas.shape[0]
    if pose2rot:
        aa = torch.cat([global_orient.reshape(B, 1, 3),
                        body_pose.reshape(B, 23, 3)], dim=1)
        rot_mats = aa_to_rotmat(aa.reshape(-1, 3)).reshape(B, 24, 3, 3)
    else:
        rot_mats = torch.cat([global_orient.reshape(B, 1, 3, 3),
                              body_pose.reshape(B, 23, 3, 3)], dim=1)

    v_shaped, pose_feature, posed_joints, rel_transforms = lbs_transforms(
        model, betas, rot_mats)

    v_posed = v_shaped + torch.matmul(
        pose_feature, model.posedirs).reshape(B, -1, 3)
    T = torch.einsum("vk,bkij->bvij", model.lbs_weights, rel_transforms)
    v_hom = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = torch.einsum("bvij,bvj->bvi", T, v_hom)[..., :3]

    extra = verts[:, model.extra_joint_ids]                           # [B, 21, 3]
    joints45 = torch.cat([posed_joints, extra], dim=1)
    if transl is not None:
        t = transl[:, None, :]
        verts = verts + t
        joints45 = joints45 + t
        posed_joints = posed_joints + t
    return SMPLOutput(vertices=verts, joints=joints45, full_pose=rot_mats,
                      joints_smpl=posed_joints)


def lbs_apply_select(model: SMPLModel, betas: torch.Tensor,
                     pose_feature: torch.Tensor, rel_transforms: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """Pose only the template vertices `idx` [B, K] (duplicates allowed).

    Exactly the math of `lbs(...).vertices[b, idx[b]]`, but every gather is
    from a constant table (v_template, shapedirs, posedirs, lbs_weights), so
    the backward is gathers and matmuls over K: no [B, K] -> [B, V, 3]
    scatter-add (whose atomics would sum in an order that changes from run
    to run, since many points share a nearest vertex) and no V-sized
    skinning backward. This is the form for loss terms that touch a few
    vertices per point (collision guidance).

    The JAX package chunks the gather of the pose blendshapes over K to
    bound a [B, K, 3, 207] f32 buffer; the chunking is dropped here: the
    buffer is 163 MB at B=64, K=1024, autograd keeps it until the backward
    either way, and the card has room for it."""
    idx = idx.detach()
    n_feat = model.posedirs.shape[0]
    # the pose blendshapes regrouped per vertex: rows to gather, [V, 3, 207]
    posedirs_v = model.posedirs.t().reshape(model.num_vertices, 3, n_feat)

    vt_sel = model.v_template[idx]                          # [B, K, 3]
    sd_sel = model.shapedirs[idx]                           # [B, K, 3, L]
    v_shaped_sel = vt_sel + torch.einsum("bl,bkcl->bkc", betas, sd_sel)
    v_posed_sel = v_shaped_sel + torch.einsum(
        "bf,bkcf->bkc", pose_feature, posedirs_v[idx])     # [B, K, 3, 207]

    w_sel = model.lbs_weights[idx]                          # [B, K, 24]
    t_sel = torch.einsum("bkw,bwij->bkij", w_sel, rel_transforms)
    v_hom = torch.cat([v_posed_sel, torch.ones_like(v_posed_sel[..., :1])], dim=-1)
    return torch.einsum("bkij,bkj->bki", t_sel, v_hom)[..., :3]


def vertex_normals(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted per-vertex normals. vertices [B, V, 3]; faces [F, 3].

    Each face's (area-weighted) normal is added onto its three vertices
    with `index_add_`. Forward only in practice: the normals enter the
    collision terms through a sign."""
    faces = faces.long()
    v0, v1, v2 = (vertices[:, faces[:, i]] for i in range(3))
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)       # [B, F, 3]
    n = torch.zeros_like(vertices)
    for i in range(3):
        n = n.index_add(1, faces[:, i], fn)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp(min=1e-12)
