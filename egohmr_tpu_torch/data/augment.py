"""Image / keypoint / scene augmentation pipeline (host-side numpy): a copy
of egohmr_tpu/data/augment.py, which has no framework code.

OpenCV-free reimplementation of reference dataloaders/augmentation.py:14-521.
The image crop is an affine warp (scipy.ndimage, bilinear) driven by the same
3-point-correspondence transform as the reference's cv2.getAffineTransform /
warpAffine (augmentation.py:57-150). Geometry transforms (keypoints, scene
points, SMPL params) are pure numpy; the per-item SMPL forward that fixes up
the translation after augmentation (augmentation.py:446-460) is exposed as a
separate BATCHED device-side step (`recompute_transl`) instead of one torch
forward per worker item — the single biggest host-pipeline cost in the
reference (SURVEY.md §3.5).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
from scipy import ndimage

from ..smpl import constants as C


@dataclass(frozen=True)
class AugmentConfig:
    """reference configs/__init__.py:24-32."""

    scale_factor: float = 0.3
    rot_factor: float = 30.0
    trans_factor: float = 0.02
    color_scale: float = 0.2
    rot_aug_rate: float = 0.6
    trans_aug_rate: float = 0.5
    do_flip: bool = True
    flip_aug_rate: float = 0.5


@dataclass(frozen=True)
class AugmentParams:
    scale: float = 1.0
    rot: float = 0.0
    do_flip: bool = False
    color_scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    tx: float = 0.0
    ty: float = 0.0


def draw_augment_params(cfg: AugmentConfig, rng: np.random.RandomState) -> AugmentParams:
    """reference do_augmentation (augmentation.py:14-38)."""
    tx = np.clip(rng.randn(), -1.0, 1.0) * cfg.trans_factor
    ty = np.clip(rng.randn(), -1.0, 1.0) * cfg.trans_factor
    scale = np.clip(rng.randn(), -1.0, 1.0) * cfg.scale_factor + 1.0
    rot = (np.clip(rng.randn(), -2.0, 2.0) * cfg.rot_factor
           if rng.rand() <= cfg.rot_aug_rate else 0.0)
    do_flip = cfg.do_flip and rng.rand() <= cfg.flip_aug_rate
    lo, hi = 1.0 - cfg.color_scale, 1.0 + cfg.color_scale
    color = tuple(rng.uniform(lo, hi) for _ in range(3))
    return AugmentParams(scale, rot, bool(do_flip), color, tx, ty)


def _rotate_2d(pt: np.ndarray, rot_rad: float) -> np.ndarray:
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array([pt[0] * cs - pt[1] * sn, pt[0] * sn + pt[1] * cs],
                    np.float32)


def crop_transform(
    c_x: float, c_y: float, src_w: float, src_h: float,
    dst_w: float, dst_h: float, scale: float, rot: float,
) -> np.ndarray:
    """2x3 affine src->dst, identical math to the reference's
    gen_trans_from_patch_cv (augmentation.py:57-104) without cv2:
    solves the same 3-point correspondence analytically."""
    sw, sh = src_w * scale, src_h * scale
    rot_rad = np.pi * rot / 180.0
    src_center = np.array([c_x, c_y], np.float32)
    src_down = _rotate_2d(np.array([0, sh * 0.5], np.float32), rot_rad)
    src_right = _rotate_2d(np.array([sw * 0.5, 0], np.float32), rot_rad)
    dst_center = np.array([dst_w * 0.5, dst_h * 0.5], np.float32)
    dst_down = np.array([0, dst_h * 0.5], np.float32)
    dst_right = np.array([dst_w * 0.5, 0], np.float32)

    src = np.stack([src_center, src_center + src_down, src_center + src_right])
    dst = np.stack([dst_center, dst_center + dst_down, dst_center + dst_right])

    # affine A (2x3) with A @ [src_i, 1] = dst_i for the three points
    ones = np.ones((3, 1), np.float64)
    S = np.concatenate([src.astype(np.float64), ones], axis=1)  # [3, 3]
    A = np.linalg.solve(S, dst.astype(np.float64)).T  # [2, 3]
    return A.astype(np.float32)


def warp_affine(img: np.ndarray, trans: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Bilinear affine warp matching cv2.warpAffine(img, trans, (w, h)).

    img: [H, W, C] float or uint8; trans: [2, 3] src->dst.
    """
    full = np.eye(3, dtype=np.float64)
    full[:2] = trans
    inv = np.linalg.inv(full)  # dst -> src
    # scipy affine_transform uses (row, col) = (y, x) order
    matrix = inv[[1, 0]][:, [1, 0]][:, :2]
    offset = inv[[1, 0], 2]
    out = np.empty((out_h, out_w, img.shape[2]), np.float32)
    for c in range(img.shape[2]):
        out[..., c] = ndimage.affine_transform(
            img[..., c].astype(np.float32), matrix, offset=offset,
            output_shape=(out_h, out_w), order=1, mode="constant", cval=0.0,
        )
    return out


def trans_points_2d(pts: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """Apply [2,3] affine to [N, 2] points."""
    return pts @ trans[:, :2].T + trans[:, 2]


def fliplr_keypoints(joints: np.ndarray, width: float,
                     perm: np.ndarray) -> np.ndarray:
    """reference augmentation.py:221-235."""
    out = joints.copy()
    out[:, 0] = width - out[:, 0] - 1
    return out[perm]


def rotate_points_3d(points: np.ndarray, rot_deg: float) -> np.ndarray:
    """In-plane (about z) rotation used on 3D keypoints / scene verts
    (reference augmentation.py:250-258)."""
    if rot_deg == 0:
        return points.astype(np.float32)
    r = -rot_deg * np.pi / 180.0
    sn, cs = np.sin(r), np.cos(r)
    rot = np.array([[cs, -sn, 0], [sn, cs, 0], [0, 0, 1]], points.dtype)
    return (points @ rot.T).astype(np.float32)


def rot_aa(aa: np.ndarray, rot_deg: float) -> np.ndarray:
    """Rotate a global-orient axis-angle by an in-plane rotation
    (reference augmentation.py:292-310) — scipy instead of cv2.Rodrigues."""
    if rot_deg == 0:
        return aa.astype(np.float32)
    from scipy.spatial.transform import Rotation as R

    rz = R.from_euler("z", -rot_deg, degrees=True)
    return (rz * R.from_rotvec(aa)).as_rotvec().astype(np.float32)


def fliplr_smpl_params(smpl_params: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """reference augmentation.py:168-218."""
    out = {k: v.copy() for k, v in smpl_params.items()}
    perm = np.array(
        [6, 7, 8, 3, 4, 5, 9, 10, 11, 15, 16, 17, 12, 13, 14, 18, 19, 20,
         24, 25, 26, 21, 22, 23, 27, 28, 29, 33, 34, 35, 30, 31, 32, 36, 37,
         38, 42, 43, 44, 39, 40, 41, 45, 46, 47, 51, 52, 53, 48, 49, 50, 57,
         58, 59, 54, 55, 56, 63, 64, 65, 60, 61, 62, 69, 70, 71, 66, 67, 68],
        np.int64) - 3
    out["body_pose"] = out["body_pose"][perm]
    out["global_orient"][1::3] *= -1
    out["global_orient"][2::3] *= -1
    out["body_pose"][1::3] *= -1
    out["body_pose"][2::3] *= -1
    return out


def get_example(
    img: Optional[np.ndarray],      # [H, W, 3] RGB uint8/float, or None
    center_x: float, center_y: float,
    width: float, height: float,
    keypoints_2d: np.ndarray,       # [25, 3] openpose + conf
    keypoints_3d: np.ndarray,       # [24, 3] camera coords
    smpl_params: Dict[str, np.ndarray],
    patch_size: int,
    mean: np.ndarray, std: np.ndarray,  # RGB norm (255-scaled)
    aug: AugmentParams,
    fx: float, cam_cx: float, cam_cy: float,
    scene_pcd_verts: np.ndarray,    # [P, 3]
    full_img_w: float = 1920.0, full_img_h: float = 1080.0,
    img_shape: Optional[Tuple[int, int]] = None,  # (H, W) when img is None
) -> Dict[str, np.ndarray]:
    """Augment one example (reference get_example, augmentation.py:330-521).

    Returns the item dict; `transl_needs_recompute` flags that the caller
    must run `recompute_transl` (batched, on device) whenever augmentation
    was applied — replacing the reference's per-item torch SMPL forward.

    With `img=None` (pass `img_shape`) the pixel work is SKIPPED and the
    item instead carries the warp spec (`_warp_trans`, `_do_flip`,
    `_color_scale`): the batch loader hands those to the threaded C++
    decode+warp (`native.load_batch`), which is how the decode cost scales
    across cores instead of serializing in this Python loop.
    """
    if img is None:
        assert img_shape is not None, "img=None needs img_shape=(H, W)"
        img_h, img_w = img_shape
    else:
        img = np.asarray(img)
        img_h, img_w = img.shape[:2]
    center_x = float(center_x) + width * aug.tx
    center_y = float(center_y) + height * aug.ty

    cx_flip = img_w - center_x - 1 if aug.do_flip else center_x

    trans = crop_transform(cx_flip, center_y, width, height,
                           patch_size, patch_size, aug.scale, aug.rot)
    patch = None
    if img is not None:
        work = img[:, ::-1] if aug.do_flip else img
        if work.dtype == np.uint8:
            # native fused warp + jitter + normalize (C++, one pass)
            from .. import native

            patch = native.warp_affine_norm(
                work, trans, patch_size, color_scale=aug.color_scale,
                mean=mean, std=std, chw=True)
        if patch is None:
            patch = warp_affine(work, trans, patch_size, patch_size)
            # color jitter + normalize, channel-first like the reference
            # (:377-383)
            patch = patch.transpose(2, 0, 1)
            for c in range(3):
                patch[c] = np.clip(patch[c] * aug.color_scale[c], 0, 255)
                patch[c] = (patch[c] - mean[c]) / std[c]

    # 2d keypoints in the crop (:389-401)
    kp2d = keypoints_2d.copy()
    if aug.do_flip:
        kp2d = fliplr_keypoints(kp2d, img_w, C.FLIP_PERM_OPENPOSE_2D)
    vis = (kp2d[:, 2] > 0).copy()
    kp2d[:, :2] = trans_points_2d(kp2d[:, :2], trans)
    inside = ((kp2d[:, 0] >= 0) & (kp2d[:, 0] <= patch_size)
              & (kp2d[:, 1] >= 0) & (kp2d[:, 1] <= patch_size))
    vis = vis & inside
    kp2d[:, :2] = kp2d[:, :2] / patch_size - 0.5

    # SMPL params (:386-387)
    sp = {k: np.asarray(v).copy() for k, v in smpl_params.items()}
    if aug.do_flip:
        sp = fliplr_smpl_params(sp)
    sp["global_orient"] = rot_aa(sp["global_orient"], aug.rot)

    # crop-camera translation math (:417-438)
    cam_t_full = sp["transl"].astype(np.float64)
    s = 2 * fx / (aug.scale * width) / cam_t_full[2]
    delta_x = 2 * (center_x - cam_cx) / (aug.scale * width * s)
    delta_y = 2 * (center_y - cam_cy) / (aug.scale * width * s)
    cam_t_crop = np.array([
        cam_t_full[0] - delta_x, cam_t_full[1] - delta_y,
        aug.scale * width / 224 * cam_t_full[2]])

    kp3d_crop = keypoints_3d - cam_t_full + cam_t_crop
    scene_crop = scene_pcd_verts - cam_t_full + cam_t_crop

    if aug.do_flip:
        kp3d_crop = kp3d_crop[C.FLIP_PERM_SMPL_3D]
        kp3d_crop[:, 0] *= -1
        scene_crop = scene_crop.copy()
        scene_crop[:, 0] *= -1
    kp3d_crop = rotate_points_3d(kp3d_crop, aug.rot)
    scene_crop = rotate_points_3d(scene_crop, aug.rot)

    if aug.do_flip:
        cam_t_full[0] *= -1
        cam_t_crop[0] *= -1
    kp3d_full = kp3d_crop - cam_t_crop + cam_t_full
    scene_full = scene_crop - cam_t_crop + cam_t_full

    cam_cx_out = full_img_w - cam_cx if aug.do_flip else cam_cx

    # full-image 2d keypoints around the rotation center (:499-517)
    kp2d_full = keypoints_2d.copy()
    if aug.do_flip:
        kp2d_full = fliplr_keypoints(kp2d_full, img_w, C.FLIP_PERM_OPENPOSE_2D)
    rot_c = _rotation_about(cx_flip, center_y, aug.rot)
    kp2d_full[:, :2] = trans_points_2d(kp2d_full[:, :2], rot_c)
    kp2d_full[:, 0] = kp2d_full[:, 0] / img_w - 0.5
    kp2d_full[:, 1] = kp2d_full[:, 1] / img_h - 0.5

    augmented = (aug.do_flip or aug.rot != 0 or aug.scale != 1.0
                 or aug.tx != 0 or aug.ty != 0)
    out_img = (
        {"img": patch.astype(np.float32)}                    # [3, S, S] CHW
        if patch is not None else
        {"_warp_trans": trans.astype(np.float32),            # [2, 3]
         "_do_flip": np.bool_(aug.do_flip),
         "_color_scale": np.asarray(aug.color_scale, np.float32)})
    return {
        **out_img,
        "keypoints_2d": kp2d.astype(np.float32),
        "keypoints_2d_vis_mask": vis,
        "orig_keypoints_2d": kp2d_full.astype(np.float32),
        "keypoints_3d": kp3d_crop.astype(np.float32),
        "keypoints_3d_full": kp3d_full.astype(np.float32),
        "scene_pcd_verts_full": scene_full.astype(np.float32),
        "smpl_params": {k: v.astype(np.float32) for k, v in sp.items()},
        "box_center": np.array([cx_flip, center_y], np.float32),
        "box_size": np.float32(width * aug.scale),
        "cam_cx": np.float32(cam_cx_out),
        "transl_needs_recompute": augmented,
    }


def _rotation_about(cx: float, cy: float, rot_deg: float) -> np.ndarray:
    """cv2.getRotationMatrix2D((cx, cy), rot, 1.0) equivalent."""
    a = np.deg2rad(rot_deg)
    cs, sn = np.cos(a), np.sin(a)
    return np.array([[cs, sn, (1 - cs) * cx - sn * cy],
                     [-sn, cs, sn * cx + (1 - cs) * cy]], np.float32)


def recompute_transl(smpl_lbs_fn, smpl_params_batch: Dict, kp3d_full: np.ndarray):
    """Batched replacement for the reference's per-item torch SMPL forward
    that fixes up transl after 3-D augmentation (augmentation.py:446-460):
    transl = augmented_pelvis - local_pelvis(pose, betas).

    smpl_lbs_fn(betas, global_orient_aa, body_pose_aa) -> joints [B, 45, 3]
    (no transl). Returns the new transl [B, 3].
    """
    joints = smpl_lbs_fn(
        smpl_params_batch["betas"],
        smpl_params_batch["global_orient"],
        smpl_params_batch["body_pose"],
    )
    local_pelvis = np.asarray(joints[:, 0])
    return kp3d_full[:, 0] - local_pelvis
