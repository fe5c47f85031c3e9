"""Learned part-wise body signed-distance field, the VolumetricSMPL family
(port of egohmr_tpu/collision/neural_sdf.py).

The same part decomposition, canonicalisation and net as the occupancy
backend (`neural_occupancy.PartFieldNet`); the head regresses a truncated
part-local signed distance, bounded by `trunc * tanh` for the distilled
family, and the parts compose with a min (distance to a union of parts).
Weights come from `distill_sdf` (CLI `python -m
egohmr_tpu_torch.train.distill_sdf`) or from a VolumetricSMPL release
through `interop.volsmpl_convert`. < 0 is inside the body.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..interop.volsmpl_convert import convert_volsmpl
from ..smpl.model import SMPLModel, SMPLOutput
from .neural_occupancy import (
    LabeledBatch,
    PartFieldNet,
    _load_collision_net,
    distill,
    make_learned_guidance_fn,
    masked_mean_loss,
    part_field_raw,
    sample_labeled_batch,
)


@dataclass(frozen=True)
class SDFNetConfig:
    latent_dim: int = 64
    hidden_dim: int = 128
    num_layers: int = 4
    # learned per-part identity code (see OccupancyConfig.part_embed_dim)
    part_embed_dim: int = 32
    # truncation radius (m): labels are clamped to +-trunc and the output is
    # bounded to the same range
    trunc: float = 0.15
    # separate per-part MLPs stacked as [K, in, out]; filled by
    # interop.volsmpl_convert.convert_volsmpl
    per_part_networks: bool = False
    activation: str = "relu"
    leaky_slope: float = 0.01
    # converted releases regress raw signed distance; the distilled family
    # regresses the tanh-bounded truncated one
    bounded_output: bool = True


def sdf_from_raw(cfg: SDFNetConfig, raw: torch.Tensor) -> torch.Tensor:
    """Compose parts: the bounded head, then the min over parts (the
    distance to the union of parts). raw [B, 24, P] -> [B, P]."""
    if cfg.bounded_output:
        raw = cfg.trunc * torch.tanh(raw)
    return torch.amin(raw, dim=1)


def sdf_query(net: PartFieldNet, smpl_out: SMPLOutput, betas: torch.Tensor,
              points: torch.Tensor) -> torch.Tensor:
    """Signed distance (m) of scene points to the posed body, [B, P, 3] ->
    [B, P]; < 0 is inside."""
    return sdf_from_raw(net.cfg, part_field_raw(net, smpl_out, betas, points))


def sdf_collision_loss(sdf: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squared penetration depth, averaged per body; [B, P] -> [B]."""
    return masked_mean_loss(torch.square(torch.clamp(-sdf, min=0.0)), mask)


def make_volsdf_guidance_fn(net: PartFieldNet, model: SMPLModel, cond, stats, *,
                            max_scene_points: Optional[int] = 4096,
                            global_rows: Optional[int] = None):
    """Collision guidance through the learned SDF in place of the mesh SDF
    (`--collision_backend volsdf`): each point's penalty is its squared
    penetration depth (`sdf_collision_loss`'s)."""
    def penalty(raw):
        return torch.square(torch.clamp(-sdf_from_raw(net.cfg, raw), min=0.0))

    return make_learned_guidance_fn(net, penalty, model, cond, stats,
                                    max_scene_points=max_scene_points,
                                    global_rows=global_rows)


@torch.no_grad()
def sdf_agreement(net: PartFieldNet, model: SMPLModel, generator: torch.Generator, *,
                  n_bodies: int = 16, points_per_body: int = 1024, label_mode: str = "winding",
                  sign_k: int = 4) -> Dict[str, float]:
    """Held-out quality of the learned SDF against the exact mesh SDF on
    freshly drawn poses: inside/outside sign agreement (the artifact's bar),
    the truncated-value MAE, and the MAE in the near-surface band
    |sdf| < trunc / 2."""
    cfg = net.cfg
    b = sample_labeled_batch(generator, model, batch_bodies=n_bodies,
                             points_per_body=points_per_body, label_mode=label_mode,
                             sign_k=sign_k)
    pred = sdf_query(net, b.smpl_out, b.betas, b.points)
    label = torch.clamp(b.sdf, -cfg.trunc, cfg.trunc)
    err = torch.abs(pred - label)
    band = (torch.abs(b.sdf) < cfg.trunc / 2).float()
    return {
        "sign_agreement": float(((pred < 0.0) == (b.sdf < 0.0)).float().mean()),
        "mae_truncated_m": float(err.mean()),
        "mae_near_surface_m": float(torch.sum(err * band) / torch.clamp(band.sum(), min=1.0)),
    }


def sdf_distill_loss(net: PartFieldNet, batch: LabeledBatch) -> torch.Tensor:
    """L2 on the truncated value plus 0.1 x a sign hinge with a 0.01 m
    margin, which sharpens the zero crossing that the value loss blurs."""
    trunc = net.cfg.trunc
    label = torch.clamp(batch.sdf, -trunc, trunc)
    pred = sdf_query(net, batch.smpl_out, batch.betas, batch.points)
    value = torch.mean(torch.square(pred - label))
    hinge = torch.mean(torch.clamp(0.01 - torch.sign(batch.sdf) * pred, min=0.0))
    return value + 0.1 * hinge


def distill_sdf(generator: torch.Generator, model: SMPLModel, cfg: SDFNetConfig = SDFNetConfig(),
                *, steps: int = 300, batch_bodies: int = 4, points_per_body: int = 512,
                lr: float = 1e-3, label_mode: str = "winding", sign_k: int = 4,
                log_every: int = 0, losses: Optional[list] = None) -> PartFieldNet:
    """Train the SDF net against the exact mesh SDF on random poses, labels
    truncated to +-cfg.trunc. The weights are drawn on the CPU from
    `generator`'s seed, the batches from `generator` on its device."""
    init = torch.Generator().manual_seed(generator.initial_seed())
    net = PartFieldNet(cfg, generator=init).to(generator.device)
    return distill(net, model, generator, sdf_distill_loss, steps=steps, lr=lr,
                   draw_kw=dict(batch_bodies=batch_bodies, points_per_body=points_per_body,
                                label_mode=label_mode, sign_k=sign_k),
                   log_every=log_every, tag="distill-sdf", losses=losses)


def load_sdfnet(path: str, device=None) -> PartFieldNet:
    """Volsdf-backend weights: a distilled `.npz` artifact, or a
    VolumetricSMPL release `.pt`/`.pth`/`.ckpt` converted by
    `interop.volsmpl_convert`. The config is `net.cfg`."""
    return _load_collision_net(path, SDFNetConfig, "sdf_config", convert_volsmpl, device)
