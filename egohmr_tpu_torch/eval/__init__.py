"""Inference pipeline, metrics and the evaluation CLI (`test_egohmr`)."""
from .metrics import (
    apd,
    diversity_std,
    joint_visibility_mask,
    mpjpe,
    pa_mpjpe,
    similarity_transform,
    similarity_transform_vis_mask,
    v2v,
)
from .pipeline import EvalResult, evaluate_batch, sample_bodies, tile_condition

__all__ = [
    "apd",
    "diversity_std",
    "joint_visibility_mask",
    "mpjpe",
    "pa_mpjpe",
    "similarity_transform",
    "similarity_transform_vis_mask",
    "v2v",
    "EvalResult",
    "evaluate_batch",
    "sample_bodies",
    "tile_condition",
]
