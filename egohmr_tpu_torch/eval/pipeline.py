"""Stage-2 inference pipeline, with and without collision guidance (port
of egohmr_tpu/eval/pipeline.py:tile_condition and sample_bodies).

The per-image condition is computed once and tiled S times along the batch
axis, so all S samples of all B images run in one sampling loop.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..diffusion import DiffusionSchedule, GuidanceConfig, sample_loop
from ..models import (
    BodyRepStats,
    Condition,
    EgoHMR,
    EgoHMRConfig,
    compute_condition,
    make_denoise_fn,
    make_guidance_fn,
    model_outputs,
)
from ..nn import cast_params_bf16
from ..smpl import SMPLModel


def tile_condition(cond: Condition, s: int) -> Condition:
    """Repeat each image's condition S times along the batch axis
    (sample-major within an image, as `jnp.repeat` does)."""
    return Condition(*(x.repeat_interleave(s, dim=0) for x in cond))


def _to_f32(cond: Condition) -> Condition:
    return Condition(*(x.float() if x.dtype == torch.bfloat16 else x
                       for x in cond))


@torch.no_grad()
def sample_bodies(
    model: EgoHMR,
    cfg: EgoHMRConfig,
    smpl: SMPLModel,
    stats: BodyRepStats,
    schedule: DiffusionSchedule,
    batch: Dict,
    generator: Optional[torch.Generator],
    num_samples: int,
    *,
    sampler: str = "ddpm",
    with_guidance: bool = False,
    guidance: GuidanceConfig = GuidanceConfig(),
    collision_backend: str = "sdf",
    bf16: bool = False,
    params_precast: bool = False,
    guidance_refresh_every: int = 1,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[Dict[str, torch.Tensor], Condition]:
    """Draw `num_samples` bodies per image; outputs are [B, S, ...].

    `sampler` is "ddpm" or "ddim" over `schedule`'s steps. `with_guidance`
    adds the collision-score gradient on the low-noise steps (`guidance`
    holds its thresholds and weights). `collision_backend` names the
    gradient's source; only the exact mesh SDF ("sdf") is ported.
    `guidance_refresh_every` > 1 reuses the guided step's selection pass
    across that many adjacent guided steps (an approximation; 1 is exact).
    The whole function runs without autograd; the guidance takes its
    gradient in a scope of its own.

    `batch` holds tensors on the model's device. x_T is `noise` when given,
    else drawn from `generator`. With `bf16` the conditioning and the
    denoiser run in bfloat16 (BatchNorm statistics stay f32 and fold into
    the activation dtype); the sampler, SMPL and the reprojection stay f32.
    `params_precast` means `model` already is the bf16 copy."""
    if (with_guidance and guidance_refresh_every != 1
            and collision_backend in ("occupancy", "volsdf")):
        raise ValueError(
            "guidance_refresh_every > 1 is an sdf-backend knob (it caches "
            f"the mesh-SDF selection pass); the {collision_backend} backend "
            "has no per-step selection stage to reuse")
    if collision_backend in ("occupancy", "volsdf"):
        raise NotImplementedError(
            f"collision_backend {collision_backend!r}: the learned collision "
            "backends are not ported yet (ROADMAP slice 7)")
    if collision_backend != "sdf":
        raise ValueError(f"unknown collision_backend: {collision_backend}")
    B = batch["img"].shape[0]
    if bf16:
        if not params_precast:
            model = cast_params_bf16(model)
        batch = dict(batch)
        batch["img"] = batch["img"].to(torch.bfloat16)
    cond = compute_condition(model, cfg, batch)
    cond_s = tile_condition(cond, num_samples)
    if bf16:
        raw = make_denoise_fn(model, cfg, cond_s)

        def denoise(x, t):
            return raw(x.to(torch.bfloat16), t).float()

        cond_s, cond = _to_f32(cond_s), _to_f32(cond)
    else:
        denoise = make_denoise_fn(model, cfg, cond_s)
    guidance_fn = None
    if with_guidance:
        # cond_s is f32 here on the bf16 path too: the guidance, like SMPL
        # and the reprojection, runs in f32
        guidance_fn = make_guidance_fn(
            model, cfg, smpl, cond_s, stats,
            selection_refresh_every=guidance_refresh_every)
    _, x0 = sample_loop(schedule, denoise, generator, (B * num_samples, 144),
                        sampler=sampler, guidance_fn=guidance_fn,
                        guidance=guidance, noise=noise)
    out = model_outputs(cfg, smpl, cond_s, x0, stats)
    out = {k: v.reshape(B, num_samples, *v.shape[1:]) for k, v in out.items()}
    return out, cond
