"""The conditional Glow flow of stage 1."""
from .glow import (
    Glow,
    GlowConfig,
    coupling_split,
    glow_forward,
    glow_inverse,
    glow_log_prob,
    glow_sample_and_log_prob,
    init_glow_,
    initialize_actnorms,
)

__all__ = ["Glow", "GlowConfig", "coupling_split", "glow_forward", "glow_inverse",
           "glow_log_prob", "glow_sample_and_log_prob", "init_glow_", "initialize_actnorms"]
