"""Diffusion schedule tables and the DDPM / DDIM samplers, with collision
guidance."""
from .sampler import GuidanceConfig, StatefulGuidanceFn, sample_loop
from .schedule import DiffusionSchedule, make_schedule

__all__ = ["DiffusionSchedule", "GuidanceConfig", "StatefulGuidanceFn",
           "make_schedule", "sample_loop"]
