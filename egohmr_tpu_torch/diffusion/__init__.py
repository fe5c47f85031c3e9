"""Diffusion schedule tables and the DDPM / DDIM samplers, with collision
guidance."""
from .sampler import GuidanceConfig, StatefulGuidanceFn, draw_step_noise, sample_loop
from .schedule import DiffusionSchedule, make_schedule

__all__ = ["DiffusionSchedule", "GuidanceConfig", "StatefulGuidanceFn",
           "draw_step_noise", "make_schedule", "sample_loop"]
