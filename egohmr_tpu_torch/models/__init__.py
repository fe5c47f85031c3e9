"""Stage-2 model: config, module tree and the inference functions."""
from .egohmr import (
    BodyRepStats,
    Condition,
    EgoHMR,
    EgoHMRConfig,
    compute_condition,
    init_random_,
    make_denoise_fn,
    make_guidance_fn,
    model_outputs,
)

__all__ = ["BodyRepStats", "Condition", "EgoHMR", "EgoHMRConfig",
           "compute_condition", "init_random_", "make_denoise_fn",
           "make_guidance_fn", "model_outputs"]
