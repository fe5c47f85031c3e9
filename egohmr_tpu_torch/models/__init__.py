"""The models: stage 2 (`egohmr`: config, module tree, the inference
functions and the training loss), stage 1 (`prohmr`, whose functions are
used through the submodule) and stage 1's discriminator."""
from .discriminator import Discriminator, discriminator_forward, init_discriminator_
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
from .prohmr import ProHMR, ProHMRConfig, ProHMRLossWeights, ProHMROutput

__all__ = ["BodyRepStats", "Condition", "Discriminator", "EgoHMR", "EgoHMRConfig",
           "LossWeights", "ProHMR", "ProHMRConfig", "ProHMRLossWeights", "ProHMROutput",
           "compute_condition", "compute_loss", "denoise_x0", "discriminator_forward",
           "init_discriminator_", "init_random_", "make_denoise_fn", "make_guidance_fn",
           "model_outputs"]
