"""Inference pipeline, metrics and the evaluation CLIs (`test_egohmr`,
stage 2; `test_prohmr`, stage 1)."""
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
