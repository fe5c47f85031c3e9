"""Stage-1 GAN training step (port of egohmr_tpu/train/prohmr_loop.py).

One step is the generator's forward (ProHMR in training mode, S =
`cfg.num_train_samples` poses per image), its loss with the adversarial
term scored by the discriminator as it stands, the discriminator's LSGAN
loss on the detached fakes of that forward and on mocap poses, both
backward passes, then both AdamW steps, eager on one device. As in the JAX
package:

* Each AdamW is unmasked (`optax.adamw(lr, weight_decay)`): it updates and
  decays every trainable tensor, the ActNorm, the LU entries, the biases and
  the BatchNorm scales included, and the fc head's `init_betas` and
  `init_cam`, which the reference layout holds as buffers
  (`TRAINED_BUFFERS`, handed to `loop.trainable_tensors`). The BatchNorm
  running statistics are not trainable: the forward pass writes them.
* The draws: the flow's samples 1.. (`z`, [B, S-1, 144] of a standard
  normal) and the noise on the GT pose whose NLL is taken (`nll_noise`,
  [B, 144]) come from an explicit `torch.Generator`, in that order, or are
  handed in (the parity tests hand in the JAX draws).
* Data parallelism (a `parallel.DataParallel` record `dp`), as in
  `train/loop.py`: the backbone's BatchNorms take the whole batch's
  statistics, both models' gradients and both loss dicts are averaged over
  the ranks, and `z` and `nll_noise` are drawn for the whole batch on
  every rank, each keeping its rows. The JAX step instead folds the rank
  into its key, so its N-way draws differ from its 1-way ones; here an
  N-way step draws what the 1-way step draws.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..geometry import aa_to_rotmat
from ..models.discriminator import Discriminator, discriminator_forward
from ..models.prohmr import ProHMR, ProHMRConfig, ProHMRLossWeights, compute_loss, forward
from ..parallel.mesh import DataParallel, draw_rows, mean_grads, mean_metrics
from ..smpl import SMPLModel
from .loop import fill_missing_grads, optimizer_tensors, trainable_tensors

# buffers of the reference layout that training updates: parameter leaves in
# the JAX package
TRAINED_BUFFERS = ("flow.fc_head.init_betas", "flow.fc_head.init_cam")


def make_optimizers(model: ProHMR, disc: Discriminator, lr: float = 1e-4,
                    weight_decay: float = 1e-4) -> Tuple[torch.optim.AdamW, torch.optim.AdamW]:
    """(generator's, discriminator's) AdamW, each over every trainable
    tensor, with decoupled weight decay, betas (0.9, 0.999), eps 1e-8, as
    `optax.adamw`."""
    def adamw(tensors):
        return torch.optim.AdamW(list(tensors), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)

    return (adamw(trainable_tensors(model, TRAINED_BUFFERS).values()),
            adamw(disc.parameters()))


def generator_loss(
    model: ProHMR, disc: Discriminator, cfg: ProHMRConfig, w: ProHMRLossWeights,
    smpl_neutral: SMPLModel, smpl_male: SMPLModel, smpl_female: SMPLModel, batch: Dict, *,
    scene_cano: bool = False, generator: Optional[torch.Generator] = None,
    z: Optional[torch.Tensor] = None, nll_noise: Optional[torch.Tensor] = None,
    dp: Optional[DataParallel] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """(flow loss + w.adversarial x LSGAN generator loss, {term: value},
    the fakes (body-pose rotmats [B*S, 23, 3, 3], betas [B*S, 10])). The
    BatchNorm running statistics are updated in place. `z` and `nll_noise`
    are drawn from `generator`, in that order, where not given; with `dp`,
    `batch` is the rank's block, and the draws are made for the whole batch
    and the rank's rows kept."""
    B, S, dev = batch["img"].shape[0], cfg.num_train_samples, batch["img"].device
    if z is None:
        z = torch.zeros((B, S, cfg.flow_dim), device=dev)
        if S > 1:
            z[:, 1:] = draw_rows(dp, B, lambda n: torch.randn(
                (n, S - 1, cfg.flow_dim), generator=generator, device=dev))
    if nll_noise is None:
        nll_noise = draw_rows(dp, B, lambda n: torch.randn(
            (n, cfg.flow_dim), generator=generator, device=dev))
    out = forward(model, cfg, smpl_neutral, batch, S, z=z, train=True, scene_cano=scene_cano,
                  dp=dp)
    loss, losses = compute_loss(model, cfg, w, smpl_male, smpl_female, batch, out, train=True,
                                nll_noise=nll_noise)
    fake = (out.pred_pose_rotmat[:, :, 1:].reshape(B * S, 23, 3, 3),
            out.pred_betas.reshape(B * S, 10))
    loss_adv = (discriminator_forward(disc, *fake) - 1.0).square().sum() / B
    losses = dict(losses, loss_gen=loss_adv)
    return loss + w.adversarial * loss_adv, losses, fake


def discriminator_loss(disc: Discriminator, w: ProHMRLossWeights, mocap_batch: Dict,
                       fake_pose_rotmat: torch.Tensor, fake_betas: torch.Tensor
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """LSGAN: fakes towards 0, mocap poses (axis-angle [B, 69]) towards 1;
    (w.adversarial x loss, {"loss_disc": loss}). The fakes are detached."""
    body_pose, betas = mocap_batch["body_pose"], mocap_batch["betas"]
    B = body_pose.shape[0]
    real = aa_to_rotmat(body_pose.reshape(-1, 3)).reshape(B, 23, 3, 3)
    fake_out = discriminator_forward(disc, fake_pose_rotmat.detach(), fake_betas.detach())
    real_out = discriminator_forward(disc, real, betas)
    loss = (fake_out.square().sum() / fake_out.shape[0]
            + (real_out - 1.0).square().sum() / real_out.shape[0])
    return w.adversarial * loss, {"loss_disc": loss}


def make_prohmr_train_step(
    cfg: ProHMRConfig, w: ProHMRLossWeights, smpl_neutral: SMPLModel, smpl_male: SMPLModel,
    smpl_female: SMPLModel, optimizer: torch.optim.Optimizer,
    disc_optimizer: torch.optim.Optimizer, *, scene_cano: bool = False,
    dp: Optional[DataParallel] = None,
):
    """step(model, disc, batch, mocap_batch, generator=None, *, z=None,
    nll_noise=None) -> {term: detached value}: the generator's and the
    discriminator's gradients, each from the other's weights before the
    step, then both AdamW steps, in place. With a data-parallel record
    `dp`, `batch` and `mocap_batch` are the rank's blocks; both gradients
    and the terms are averaged over the ranks before the steps."""

    def step(model: ProHMR, disc: Discriminator, batch: Dict, mocap_batch: Dict,
             generator: Optional[torch.Generator] = None, **draws) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        disc_optimizer.zero_grad(set_to_none=True)
        # the generator's loss differentiates through the discriminator to
        # the fakes, not to the discriminator's weights
        disc.requires_grad_(False)
        try:
            total, losses, fake = generator_loss(
                model, disc, cfg, w, smpl_neutral, smpl_male, smpl_female, batch,
                scene_cano=scene_cano, generator=generator, dp=dp, **draws)
            total.backward()
        finally:
            disc.requires_grad_(True)
        d_total, d_losses = discriminator_loss(disc, w, mocap_batch, *fake)
        d_total.backward()
        fill_missing_grads(optimizer)
        fill_missing_grads(disc_optimizer)
        mean_grads(dp, optimizer_tensors(optimizer) + optimizer_tensors(disc_optimizer))
        optimizer.step()
        disc_optimizer.step()
        return mean_metrics(dp, {k: v.detach() for k, v in {**losses, **d_losses}.items()})

    return step
