"""Rotation conversions and camera projection."""
from .projection import (
    convert_pare_to_full_img_cam,
    perspective_projection,
    points_coord_trans,
)
from .rotations import (
    aa_to_rotmat,
    quat_to_aa,
    quat_to_rotmat,
    rot6d_to_rotmat,
    rotmat_to_aa,
    rotmat_to_quat,
    rotmat_to_rot6d,
)

__all__ = [
    "aa_to_rotmat",
    "quat_to_rotmat",
    "quat_to_aa",
    "rot6d_to_rotmat",
    "rotmat_to_rot6d",
    "rotmat_to_quat",
    "rotmat_to_aa",
    "perspective_projection",
    "convert_pare_to_full_img_cam",
    "points_coord_trans",
]
