"""The EgoBody dataset and its augmentation, synthetic batches, padding and
the body-representation statistics."""
from .augment import (
    AugmentConfig,
    AugmentParams,
    crop_transform,
    draw_augment_params,
    get_example,
    recompute_transl,
    warp_affine,
)
from .batching import pad_batch
from .egobody import (
    EgoBodyDataset,
    MoCapDataset,
    collate,
    finalize_batch,
    to_device_batch,
)
from .stats import compute_body_rep_stats, load_stats, save_stats
from .synthetic import synthetic_batch, to_torch

__all__ = [
    "AugmentConfig",
    "AugmentParams",
    "crop_transform",
    "draw_augment_params",
    "get_example",
    "recompute_transl",
    "warp_affine",
    "EgoBodyDataset",
    "MoCapDataset",
    "collate",
    "finalize_batch",
    "to_device_batch",
    "compute_body_rep_stats",
    "load_stats",
    "save_stats",
    "pad_batch",
    "synthetic_batch",
    "to_torch",
]
