"""Stage-2 training step (port of egohmr_tpu/train/loop.py).

One step is q_sample -> conditioning -> denoiser -> SMPL -> the nine loss
terms -> backward -> AdamW, eager on one device. As in the JAX package:

* AdamW (decoupled weight decay) updates every trainable tensor but the
  BatchNorm running statistics, which come from the forward pass: each
  train-mode BatchNorm writes them in place (`nn.core.batchnorm`). The
  trainable tensors include the sinusoidal timestep table
  `embed_timestep.pe`, a parameter leaf that the JAX optimizer trains; here
  it is a buffer, since the reference `state_dict` does not hold it
  (`trainable_tensors`).
* Mixed precision casts every parameter and buffer outside the BatchNorms
  to bf16 inside the differentiated function (`nn.core.bf16_tensors`
  through `torch.func.functional_call`), with the image and x_t: the
  conditioning and the denoiser run in bf16 and the gradients land in f32
  on the f32 master weights. BatchNorm statistics, SMPL, the losses and the
  AdamW state stay f32; bf16 keeps f32's exponent range, so there is no
  loss scaling.
* `t`, the noise and the condition-drop mask are drawn from an explicit
  `torch.Generator`, or handed in (the parity tests hand in the JAX draws).
* Data parallelism (a `parallel.DataParallel` record `dp`; JAX's
  `shard_map` over a 1-D mesh): each rank holds a replica and a block of
  the batch, every BatchNorm takes the whole batch's statistics, the
  gradients and the metrics are averaged over the ranks before AdamW, and
  the draws are made for the whole batch from the same generator on every
  rank, each rank keeping its rows (JAX keys them by the global sample
  index): an N-way step draws what the 1-way step draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..diffusion.schedule import DiffusionSchedule, q_sample
from ..geometry import aa_to_rotmat, rotmat_to_rot6d
from ..models import (
    BodyRepStats,
    Condition,
    EgoHMR,
    EgoHMRConfig,
    LossWeights,
    compute_condition,
    compute_loss,
    denoise_x0,
    model_outputs,
)
from ..nn import bf16_tensors
from ..parallel.mesh import DataParallel, draw_rows, mean_grads, mean_metrics
from ..smpl import SMPLModel

# buffers that training updates: a parameter leaf in the JAX package, left
# out of the reference state_dict
TRAINED_BUFFERS = ("embed_timestep.pe",)


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    weight_decay: float = 1e-4
    use_collision_loss: bool = False  # the CLI turns it on at --start_coap_step
    # the collision loss scores the K scene points nearest the posed body's
    # bbox (exact while the bbox's points fit in K); None = the whole cloud
    max_collision_points: Optional[int] = 4096
    # bf16 conditioning and denoiser, forward and backward; f32 masters
    mixed_precision: bool = True


def trainable_tensors(model: nn.Module,
                      buffers: Tuple[str, ...] = TRAINED_BUFFERS) -> Dict[str, torch.Tensor]:
    """What AdamW updates, by name: every parameter and the named `buffers`
    (stage 2's `TRAINED_BUFFERS` by default), which this sets to require
    gradients. Call it once the model is on its device: moving the model
    replaces its buffers."""
    named = dict(model.named_parameters())
    for name in buffers:
        named[name] = model.get_buffer(name).requires_grad_(True)
    return named


def fill_missing_grads(optimizer: torch.optim.Optimizer) -> None:
    """optax decays every leaf and counts every step; torch's AdamW skips a
    tensor without a gradient, so one that got none takes a zero one."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def optimizer_tensors(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    """Every tensor `optimizer` updates, in its groups' order."""
    return [p for group in optimizer.param_groups for p in group["params"]]


def make_optimizer(model: EgoHMR, tcfg: TrainConfig) -> torch.optim.AdamW:
    """AdamW over `trainable_tensors(model)`: decoupled weight decay, betas
    (0.9, 0.999), eps 1e-8, as `optax.adamw`."""
    return torch.optim.AdamW(list(trainable_tensors(model).values()), lr=tcfg.lr,
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=tcfg.weight_decay)


def gt_pose_to_x_start(batch: Dict, stats: BodyRepStats) -> torch.Tensor:
    """Ground-truth axis-angle pose -> rot6d ('diffusion' layout) ->
    normalised 144-d x0."""
    sp = batch["smpl_params"]
    B = sp["betas"].shape[0]
    aa = torch.cat([sp["global_orient"].reshape(B, 3), sp["body_pose"].reshape(B, 69)], dim=1)
    rot6d = rotmat_to_rot6d(aa_to_rotmat(aa.reshape(-1, 3)), "diffusion").reshape(B, 144)
    return (rot6d - stats.mean) / stats.std


class _Stage2Forward(nn.Module):
    """The conditioning and the denoiser as one module call, so that
    `functional_call` can run them on the bf16 casts of the weights."""

    def __init__(self, model: EgoHMR, cfg: EgoHMRConfig, dp: Optional[DataParallel]):
        super().__init__()
        self.model, self.cfg, self.dp = model, cfg, dp

    def forward(self, batch: Dict, x_t: torch.Tensor, t_orig: torch.Tensor,
                drop: Optional[torch.Tensor]) -> Tuple[Condition, torch.Tensor]:
        cond = compute_condition(self.model, self.cfg, batch, train=True, drop=drop,
                                 dp=self.dp)
        return cond, denoise_x0(self.model, self.cfg, cond, x_t, t_orig, dp=self.dp)


def stage2_loss(
    model: EgoHMR,
    cfg: EgoHMRConfig,
    weights: LossWeights,
    schedule: DiffusionSchedule,
    stats: BodyRepStats,
    smpl_neutral: SMPLModel,
    smpl_male: SMPLModel,
    smpl_female: SMPLModel,
    batch: Dict,
    *,
    use_collision: bool,
    max_collision_points: Optional[int] = 4096,
    mixed_precision: bool = False,
    generator: Optional[torch.Generator] = None,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    drop: Optional[torch.Tensor] = None,
    dp: Optional[DataParallel] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One training forward: t ~ U{0..T-1}, q_sample, denoise, loss.
    Returns (loss, {term: value}); the BatchNorm running statistics are
    updated in place. `t` [B] int64, `noise` [B, 144] and `drop` [B] bool
    are drawn from `generator` (on the batch's device), in that order,
    where not given. With a data-parallel record `dp`, `batch` is the
    rank's block: the draws are made for the whole batch and the rank's
    rows kept, and every BatchNorm takes the whole batch's statistics."""
    B, dev = batch["img"].shape[0], batch["img"].device
    x_start = gt_pose_to_x_start(batch, stats)
    if t is None:
        t = draw_rows(dp, B, lambda n: torch.randint(
            0, schedule.num_timesteps, (n,), generator=generator, device=dev))
    if noise is None:
        noise = draw_rows(dp, B, lambda n: torch.randn(
            (n, *x_start.shape[1:]), generator=generator, device=dev))
    if drop is None and cfg.cond_mask_prob > 0.0:
        drop = draw_rows(dp, B, lambda n: torch.rand(
            n, generator=generator, device=dev) < cfg.cond_mask_prob)
    x_t = q_sample(schedule, x_start, t, noise)
    t_orig = schedule.timestep_map[t]

    forward = _Stage2Forward(model, cfg, dp)
    if mixed_precision:
        casts = {"model." + k: v for k, v in bf16_tensors(model).items()}
        cond, x0_pred = torch.func.functional_call(
            forward, casts, (dict(batch, img=batch["img"].to(torch.bfloat16)),
                             x_t.to(torch.bfloat16), t_orig, drop))
        # SMPL, the reprojection and every loss term run in f32
        x0_pred = x0_pred.float()
        cond = Condition(*(x.float() if x.dtype == torch.bfloat16 else x for x in cond))
    else:
        cond, x0_pred = forward(batch, x_t, t_orig, drop)
    outputs = model_outputs(cfg, smpl_neutral, cond, x0_pred, stats)
    return compute_loss(cfg, weights, smpl_neutral, smpl_male, smpl_female, batch, cond,
                        outputs, train=True, use_collision=use_collision,
                        max_collision_points=max_collision_points)


def make_train_step(
    cfg: EgoHMRConfig,
    tcfg: TrainConfig,
    weights: LossWeights,
    schedule: DiffusionSchedule,
    stats: BodyRepStats,
    smpl_neutral: SMPLModel,
    smpl_male: SMPLModel,
    smpl_female: SMPLModel,
    optimizer: torch.optim.Optimizer,
    dp: Optional[DataParallel] = None,
):
    """step(model, batch, generator=None, *, t=None, noise=None, drop=None)
    -> {term: detached loss}: forward, backward and one `optimizer` step,
    in place on the model and the optimizer.

    With a data-parallel record `dp` (JAX's `mesh=`), `batch` is the rank's
    block of the batch and the model a replica equal on every rank: the
    gradients and the terms are averaged over the ranks after the
    backward, so every replica takes the same AdamW step. Handed-in draws
    are the rank's rows."""

    def step(model: EgoHMR, batch: Dict, generator: Optional[torch.Generator] = None,
             **draws) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        loss, terms = stage2_loss(
            model, cfg, weights, schedule, stats, smpl_neutral, smpl_male, smpl_female,
            batch, use_collision=tcfg.use_collision_loss,
            max_collision_points=tcfg.max_collision_points,
            mixed_precision=tcfg.mixed_precision, generator=generator, dp=dp, **draws)
        loss.backward()
        fill_missing_grads(optimizer)
        mean_grads(dp, optimizer_tensors(optimizer))
        optimizer.step()
        return mean_metrics(dp, {k: v.detach() for k, v in terms.items()})

    return step
