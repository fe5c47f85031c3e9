"""Camera projection (port of egohmr_tpu/geometry/projection.py)."""
from __future__ import annotations

from typing import Optional

import torch


def perspective_projection(
    points: torch.Tensor,
    translation: torch.Tensor,
    focal_length: torch.Tensor,
    camera_center: Optional[torch.Tensor] = None,
    rotation: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """points [B, N, 3], translation [B, 3], focal_length [B, 2],
    camera_center [B, 2], rotation [B, 3, 3] -> pixels [B, N, 2]."""
    if rotation is not None:
        points = torch.einsum("bij,bkj->bki", rotation, points)
    points = points + translation[:, None, :]
    projected = points[..., :2] / points[..., 2:3]
    out = projected * focal_length[:, None, :]
    if camera_center is not None:
        out = out + camera_center[:, None, :]
    return out


def convert_pare_to_full_img_cam(
    pare_cam: torch.Tensor,
    bbox_height: torch.Tensor,
    bbox_center: torch.Tensor,
    img_w: torch.Tensor,
    img_h: torch.Tensor,
    focal_length: torch.Tensor,
    crop_res: int = 224,
) -> torch.Tensor:
    """Weak-perspective crop camera (s, tx, ty) [B, 3] -> the body's
    translation in full-image camera coordinates [B, 3] (PARE)."""
    s, tx, ty = pare_cam[:, 0], pare_cam[:, 1], pare_cam[:, 2]
    r = bbox_height / crop_res
    tz = 2.0 * focal_length / (r * crop_res * s)
    cx = 2.0 * (bbox_center[:, 0] - (img_w / 2.0)) / (s * bbox_height)
    cy = 2.0 * (bbox_center[:, 1] - (img_h / 2.0)) / (s * bbox_height)
    return torch.stack([tx + cx, ty + cy, tz], dim=-1)


def points_coord_trans(points: torch.Tensor, trans_mtx: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 homogeneous transform [..., 4, 4] to points [..., N, 3]."""
    rot = trans_mtx[..., :3, :3].transpose(-1, -2)
    return torch.matmul(points, rot) + trans_mtx[..., :3, 3][..., None, :]
