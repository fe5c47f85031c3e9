"""Diffusion noise schedules and timestep respacing (port of
egohmr_tpu/diffusion/schedule.py).

The tables are built once on the host in float64 NumPy, exactly as in the
JAX package, then frozen into float32 tensors. Respacing ("ddim5") is baked
in: `timestep_map` maps each kept step to its original timestep.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Sequence, Set, Union

import numpy as np
import torch


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int,
                            scale_betas: float = 1.0) -> np.ndarray:
    if schedule_name == "linear":
        scale = scale_betas * 1000 / num_diffusion_timesteps
        return np.linspace(scale * 0.0001, scale * 0.02,
                           num_diffusion_timesteps, dtype=np.float64)
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2)
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(num_diffusion_timesteps: int, alpha_bar,
                        max_beta: float = 0.999) -> np.ndarray:
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas)


def space_timesteps(num_timesteps: int,
                    section_counts: Union[str, Sequence[int]]) -> Set[int]:
    """Strided subset of the original timesteps ('ddimN': DDIM striding)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired_count} steps "
                             "with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into "
                             f"{section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        start_idx += size
    return set(all_steps)


@dataclass(frozen=True)
class DiffusionSchedule:
    """Per-timestep coefficient tables, each [T] float32; `timestep_map`
    [T] int64 maps compressed index -> original timestep."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    timestep_map: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(**{f.name: getattr(self, f.name).to(device)
                                    for f in fields(self)})


def _build_tables(betas: np.ndarray, timestep_map: np.ndarray) -> DiffusionSchedule:
    betas = np.asarray(betas, dtype=np.float64)
    assert betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    posterior_log_variance_clipped = np.log(
        np.append(posterior_variance[1], posterior_variance[1:]))

    def f32(a):
        return torch.tensor(np.asarray(a, dtype=np.float32))

    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        alphas_cumprod_next=f32(alphas_cumprod_next),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(posterior_log_variance_clipped),
        posterior_mean_coef1=f32(
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)),
        timestep_map=torch.tensor(np.asarray(timestep_map, dtype=np.int64)),
    )


def make_schedule(num_timesteps: int = 50, schedule_name: str = "cosine",
                  timestep_respacing: str = "",
                  scale_betas: float = 1.0) -> DiffusionSchedule:
    """Build a (possibly respaced) schedule on the CPU; `.to(device)` moves it."""
    betas = get_named_beta_schedule(schedule_name, num_timesteps, scale_betas)
    if not timestep_respacing:
        return _build_tables(betas, np.arange(num_timesteps))
    use_timesteps = space_timesteps(num_timesteps, timestep_respacing)
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    last = 1.0
    new_betas, tmap = [], []
    for i, ac in enumerate(alphas_cumprod):
        if i in use_timesteps:
            new_betas.append(1 - ac / last)
            last = ac
            tmap.append(i)
    return _build_tables(np.array(new_betas), np.array(tmap))


def q_sample(schedule: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Sample q(x_t | x_0). x_start, noise [B, D]; t int64 [B]."""
    c1 = schedule.sqrt_alphas_cumprod[t][:, None]
    c2 = schedule.sqrt_one_minus_alphas_cumprod[t][:, None]
    return c1 * x_start + c2 * noise


def q_posterior_mean(schedule: DiffusionSchedule, x_start: torch.Tensor,
                     x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Posterior mean of q(x_{t-1} | x_t, x_0)."""
    c1 = schedule.posterior_mean_coef1[t][:, None]
    c2 = schedule.posterior_mean_coef2[t][:, None]
    return c1 * x_start + c2 * x_t


def predict_eps_from_xstart(schedule: DiffusionSchedule, x_t: torch.Tensor,
                            t: torch.Tensor, pred_xstart: torch.Tensor) -> torch.Tensor:
    c1 = schedule.sqrt_recip_alphas_cumprod[t][:, None]
    c2 = schedule.sqrt_recipm1_alphas_cumprod[t][:, None]
    return (c1 * x_t - pred_xstart) / c2


def predict_xstart_from_eps(schedule: DiffusionSchedule, x_t: torch.Tensor,
                            t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    c1 = schedule.sqrt_recip_alphas_cumprod[t][:, None]
    c2 = schedule.sqrt_recipm1_alphas_cumprod[t][:, None]
    return c1 * x_t - c2 * eps
