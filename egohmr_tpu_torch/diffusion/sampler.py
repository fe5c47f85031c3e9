"""DDPM and DDIM sampling loops with optional collision guidance (port of
egohmr_tpu/diffusion/sampler.py).

The JAX `lax.scan` becomes a Python loop over the steps, and its `lax.cond`
on the step index a Python `if`: PyTorch dispatches each step's kernels
asynchronously. The denoiser only predicts x0 from (x_t, t); all
conditioning is computed once outside the loop. Guidance is a closure that
returns the collision-score gradient w.r.t. x_t; it runs on the low-noise
steps only (`t_idx <= 10` for DDPM, `t_idx <= 3` for DDIM).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..parallel.mesh import Shard, draw_rows
from .schedule import (
    DiffusionSchedule,
    predict_eps_from_xstart,
    predict_xstart_from_eps,
    q_posterior_mean,
    q_sample,
)

# denoise_fn(x_t [B, D], t_original int64 [B]) -> pred_x_start [B, D]
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# guidance_fn(x_t [B, D], t int64 [B]) -> gradient [B, D]
GuidanceFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class StatefulGuidanceFn(NamedTuple):
    """Guidance with state cached across steps.

    Adjacent low-noise guided steps move the body by millimetres, so the
    gradient-free selection pass (full LBS, normals, per-step top-K and the
    nearest-vertex argmin) can be reused between refreshes; only the
    differentiable selective re-pose runs on every guided step.
    `init_state(x)` builds an empty state; `fn(x, t, state, refresh)`
    returns (grad, new_state), recomputing the selection when `refresh` is
    True. The sampler refreshes on the 1st, (1 + refresh_every)-th, ...
    guided step."""

    init_state: Callable[[torch.Tensor], Any]
    fn: Callable[[torch.Tensor, torch.Tensor, Any, bool], Tuple[torch.Tensor, Any]]
    refresh_every: int = 2


def _call_guidance(guidance_fn, x, t, gaux):
    """Dispatch plain or stateful guidance; returns (grad, new_gaux)."""
    if isinstance(guidance_fn, StatefulGuidanceFn):
        gstate, gcount = gaux
        refresh = gcount % guidance_fn.refresh_every == 0
        grad, new_state = guidance_fn.fn(x, t, gstate, refresh)
        return grad, (new_state, gcount + 1)
    return guidance_fn(x, t), gaux


@dataclass(frozen=True)
class GuidanceConfig:
    """Collision-guidance hyperparameters (the reference's defaults)."""

    cond_grad_weight: float = 2.0
    ddpm_threshold: int = 10   # apply guidance when t_idx <= threshold
    ddpm_fixed_below: int = 5  # below this, use the fixed 0.01 coefficient
    ddpm_fixed_coeff: float = 0.01
    ddim_threshold: int = 3
    ddim_scale: float = 1.0


def _step_noise(x: torch.Tensor, generator: torch.Generator, shard: Shard) -> torch.Tensor:
    """Per-step N(0, 1) noise for the rows `x`, the block `shard` of the
    batch (a seam the tests replace with zeros)."""
    return draw_rows(shard, x.shape[0], lambda n: torch.randn(
        (n, *x.shape[1:]), generator=generator, device=x.device, dtype=x.dtype))


def _noisy_steps(schedule: DiffusionSchedule, sampler: str, eta: float,
                 skip_timesteps: int = 0) -> int:
    """How many of the loop's steps add noise: every step but the last for
    DDPM and for DDIM with eta > 0, none for DDIM with eta = 0."""
    steps = schedule.num_timesteps - skip_timesteps
    if sampler == "ddim" and eta == 0:
        return 0
    return max(steps - 1, 0)


def draw_step_noise(schedule: DiffusionSchedule, generator: torch.Generator,
                    shape: Tuple[int, ...], *, sampler: str = "ddpm", eta: float = 0.0,
                    skip_timesteps: int = 0, shard: Shard = None) -> torch.Tensor:
    """Every noise tensor that `sample_loop` would draw from `generator` for
    its steps, drawn now, in the loop's order, on the generator's device:
    [K, *shape] f32 for the K steps that add noise (K = 0 for DDIM with
    eta = 0). `shape` is the rows of `shard`, whose draws keep
    `draw_rows`' semantics. Call it after x_T is drawn from the same
    generator. `sample_loop(step_noise=...)` then takes these in place of
    drawing, so the loop holds no random state: a captured request gets
    its seed through its inputs only."""
    k = _noisy_steps(schedule, sampler, eta, skip_timesteps)
    template = torch.empty(shape, dtype=torch.float32, device=generator.device)
    draws = [_step_noise(template, generator, shard) for _ in range(k)]
    return torch.stack(draws) if draws else template.new_empty((0, *shape))


def _ddpm_step(schedule: DiffusionSchedule, denoise_fn: DenoiseFn,
               guidance_fn: Optional[GuidanceFn], gcfg: GuidanceConfig,
               x: torch.Tensor, t_idx: int, gaux,
               generator: Optional[torch.Generator], shard: Shard = None,
               noise: Optional[torch.Tensor] = None, record: Optional[list] = None):
    t = torch.full((x.shape[0],), t_idx, dtype=torch.int64, device=x.device)
    pred_xstart = denoise_fn(x, schedule.timestep_map[t])
    mean = q_posterior_mean(schedule, pred_xstart, x, t)
    terms = None
    if guidance_fn is not None and t_idx <= gcfg.ddpm_threshold:
        grad, gaux = _call_guidance(guidance_fn, x, t, gaux)
        if t_idx >= gcfg.ddpm_fixed_below:
            coeff = gcfg.cond_grad_weight * schedule.posterior_variance[t][:, None]
        else:
            coeff = gcfg.cond_grad_weight * gcfg.ddpm_fixed_coeff
        terms = (x, mean, grad)
        mean = mean + coeff * grad
    if t_idx == 0:  # the last step adds no noise
        out = mean
    else:
        sigma = torch.exp(0.5 * schedule.posterior_log_variance_clipped[t])[:, None]
        if noise is None:
            noise = _step_noise(x, generator, shard)
        out = mean + sigma * noise
    if terms is not None and record is not None:
        record.append(torch.stack([*terms, out]).float())
    return out, gaux


def _ddim_step(schedule: DiffusionSchedule, denoise_fn: DenoiseFn,
               guidance_fn: Optional[GuidanceFn], gcfg: GuidanceConfig,
               eta: float, x: torch.Tensor, t_idx: int, gaux,
               generator: Optional[torch.Generator], shard: Shard = None,
               noise: Optional[torch.Tensor] = None):
    t = torch.full((x.shape[0],), t_idx, dtype=torch.int64, device=x.device)
    pred_xstart = denoise_fn(x, schedule.timestep_map[t])
    alpha_bar = schedule.alphas_cumprod[t][:, None]
    if guidance_fn is not None and t_idx <= gcfg.ddim_threshold:
        # shift eps by -sqrt(1 - alpha_bar) * grad * scale, re-derive x0
        eps = predict_eps_from_xstart(schedule, x, t, pred_xstart)
        grad, gaux = _call_guidance(guidance_fn, x, t, gaux)
        eps = eps - torch.sqrt(1.0 - alpha_bar) * grad * gcfg.ddim_scale
        pred_xstart = predict_xstart_from_eps(schedule, x, t, eps)
    eps = predict_eps_from_xstart(schedule, x, t, pred_xstart)
    alpha_bar_prev = schedule.alphas_cumprod_prev[t][:, None]
    sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
             * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
    mean_pred = (pred_xstart * torch.sqrt(alpha_bar_prev)
                 + torch.sqrt(torch.clamp(1 - alpha_bar_prev - sigma ** 2,
                                          min=0.0)) * eps)
    # sigma is exactly 0 for eta == 0, and the last step adds no noise
    if eta == 0 or t_idx == 0:
        return mean_pred, gaux
    if noise is None:
        noise = _step_noise(x, generator, shard)
    return mean_pred + sigma * noise, gaux


def sample_loop(
    schedule: DiffusionSchedule,
    denoise_fn: DenoiseFn,
    generator: Optional[torch.Generator],
    shape: Tuple[int, ...],
    *,
    sampler: str = "ddpm",
    eta: float = 0.0,
    guidance_fn: Optional[Union[GuidanceFn, StatefulGuidanceFn]] = None,
    guidance: GuidanceConfig = GuidanceConfig(),
    noise: Optional[torch.Tensor] = None,
    skip_timesteps: int = 0,
    init_data: Optional[torch.Tensor] = None,
    dump_steps: Optional[Sequence[int]] = None,
    shard: Shard = None,
    step_noise: Optional[torch.Tensor] = None,
    guidance_record: Optional[list] = None,
):
    """Run the reverse diffusion; returns (final_sample, final_pred_xstart).

    x_T is `noise` when given, else drawn from `generator` on the
    generator's device; the per-step noise is `step_noise` when given
    (`draw_step_noise`'s [K, rows, D], the k-th noisy step taking
    `step_noise[k]`), else drawn from `generator` step by step, the same
    numbers in the same order.
    `shard` (a rank's record, or (i, n)): the rows are a block of a larger
    batch (`parallel.Shard`); x_T and each step's noise are drawn for
    the whole batch and the block's rows kept, so that the n blocks
    together draw what the unsharded run draws.
    At t=0 the posterior mean (DDPM) and the DDIM mean equal pred_xstart,
    so both returned tensors are the final sample, as in the JAX package.

    `skip_timesteps`/`init_data` warm-start the chain: the loop starts
    `skip_timesteps` steps late from `init_data` (zeros when absent)
    noised to that step with x_T as the noise.

    `dump_steps`: 0-based loop-iteration indices (0 = the noisiest step)
    whose post-step samples to return as well; with it the result is
    (final_sample, final_pred_xstart, dumps [K, B, D]). Out-of-range
    indices raise.

    `guidance_record` (DDPM): a list to which each guided step appends its
    terms, [4, rows, D] f32: the step's input x_t, its posterior mean mu_t,
    the guidance's gradient g_t and the step's output, mu_t + c_t g_t +
    sigma_t z_t with c_t the guidance's coefficient and z_t the step's
    noise. Nothing is recorded without it."""
    if sampler not in ("ddpm", "ddim"):
        raise ValueError(f"unknown sampler: {sampler}")
    if guidance_record is not None and sampler != "ddpm":
        raise ValueError("the guidance record is DDPM's (its steps' posterior mean)")
    if noise is None:
        x = draw_rows(shard, shape[0], lambda n: torch.randn(
            (n, *shape[1:]), generator=generator, device=generator.device))
    else:
        x = noise
    t_start = schedule.num_timesteps - skip_timesteps
    if skip_timesteps and init_data is None:
        init_data = torch.zeros(shape, dtype=x.dtype, device=x.device)
    if init_data is not None:
        t0 = torch.full((shape[0],), t_start - 1, dtype=torch.int64, device=x.device)
        x = q_sample(schedule, init_data, t0, x)
    if dump_steps is not None:
        bad = [i for i in dump_steps if not 0 <= int(i) < t_start]
        if bad:
            raise ValueError(
                f"dump_steps {bad} out of range for a {t_start}-step chain")

    if step_noise is not None:
        want = _noisy_steps(schedule, sampler, eta, skip_timesteps)
        if step_noise.shape[0] != want:
            raise ValueError(f"step_noise holds {step_noise.shape[0]} steps' noise; this "
                             f"{sampler} chain adds noise on {want} steps")

    gaux = ()
    if isinstance(guidance_fn, StatefulGuidanceFn):
        gaux = (guidance_fn.init_state(x), 0)
    traj = []
    for k, t_idx in enumerate(range(t_start - 1, -1, -1)):
        noise_k = None if step_noise is None or k >= step_noise.shape[0] else step_noise[k]
        if sampler == "ddpm":
            x, gaux = _ddpm_step(schedule, denoise_fn, guidance_fn, guidance,
                                 x, t_idx, gaux, generator, shard, noise_k,
                                 record=guidance_record)
        else:
            x, gaux = _ddim_step(schedule, denoise_fn, guidance_fn, guidance,
                                 eta, x, t_idx, gaux, generator, shard, noise_k)
        if dump_steps is not None:
            traj.append(x)
    if dump_steps is not None:
        picked = [traj[int(i)] for i in dump_steps]
        dumps = torch.stack(picked) if picked else x.new_empty((0, *x.shape))
        return x, x, dumps
    return x, x
