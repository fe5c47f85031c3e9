"""Stage-2 model: config, module tree, the inference functions and the
training loss."""
from .egohmr import (
    BodyRepStats,
    Condition,
    EgoHMR,
    EgoHMRConfig,
    LossWeights,
    compute_condition,
    compute_loss,
    denoise_x0,
    init_random_,
    make_denoise_fn,
    make_guidance_fn,
    model_outputs,
)

__all__ = ["BodyRepStats", "Condition", "EgoHMR", "EgoHMRConfig", "LossWeights",
           "compute_condition", "compute_loss", "denoise_x0", "init_random_",
           "make_denoise_fn", "make_guidance_fn", "model_outputs"]
