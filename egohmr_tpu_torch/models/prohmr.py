"""Stage 1, ProHMR-scene: a conditional flow over the 144-d rot6d pose,
conditioned on the image, the camera and the scene (port of
egohmr_tpu/models/prohmr.py).

  conditioning_feats — the context [B, 2566]: camera centre, box, focal
                       length, ResNet features, scene features, in that
                       order; the scene encoder is kernel K1 at inference on
                       the card with `pointnet_impl="fused"`, else the plain
                       f32 encoder
  forward            — S poses per image through one batched flow inverse
                       (sample 0 the mode, z = 0), betas and the crop camera
                       from the fc head, SMPL, the full-image translation
                       that stage 2 takes as its input, and the reprojections
  initialize         — ActNorm's data-dependent init from the GT poses
  compute_loss       — the mode and expectation terms, the NLL of the
                       (noised) GT pose and the orthogonality term

The module tree (`ProHMR`) is named like the reference `state_dict`
(`backbone.`, `scene_enc.`, `flow.flow.`, `flow.fc_head.`), so
`interop.prohmr_state_dict_from_jax` weights and reference `.pt` files load
with `strict=True`. Everything runs in float32; in training every BatchNorm
normalises by the batch's statistics and writes its running ones in place.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..flow import Glow, GlowConfig, glow_log_prob, glow_sample_and_log_prob, init_glow_
from ..flow import initialize_actnorms as _initialize_actnorms
from ..geometry import (
    aa_to_rotmat,
    convert_pare_to_full_img_cam,
    perspective_projection,
    rot6d_to_rotmat,
)
from ..nn import (
    FCHead,
    ResNet,
    ResnetPointnet,
    fc_head,
    pointnet_forward,
    pointnet_forward_fused,
    resnet_forward,
)
from ..parallel.mesh import DataParallel
from ..smpl import SMPLModel, lbs
from ..smpl import constants as C
from ..utils.profiling import span
from .egohmr import init_random_ as _init_random_parts


@dataclass(frozen=True)
class ProHMRConfig:
    """Model hyperparameters; a copy of egohmr_tpu.models.prohmr.ProHMRConfig."""

    img_feat_dim: int = 2048
    resnet_layers: int = 50
    backbone_type: str = "resnet"  # "resnet" | "stub" (the stub is JAX-only)
    scene_feat_dim: int = 512
    pointnet_hidden_dim: int = 256
    # "fused": kernel K1 at inference on the card; "xla": the plain encoder
    pointnet_impl: str = "xla"
    flow_dim: int = 144
    flow_hidden: int = 1024
    flow_layers: int = 4
    flow_depth: int = 2
    fc_head_hidden: int = 1024
    with_focal_length: bool = True
    with_bbox_info: bool = True
    with_cam_center: bool = True
    num_train_samples: int = 2
    num_test_samples: int = 4
    fx_norm_coeff: float = 1500.0
    default_focal_length: float = 5000.0
    img_size: int = 224
    full_img_w: float = 1920.0
    full_img_h: float = 1080.0
    smpl_param_noise_ratio: float = 0.005

    @property
    def cam_feat_dim(self) -> int:
        return ((1 if self.with_focal_length else 0)
                + (3 if self.with_bbox_info else 0)
                + (2 if self.with_cam_center else 0))

    @property
    def context_feats_dim(self) -> int:
        return self.img_feat_dim + self.cam_feat_dim + self.scene_feat_dim

    def glow_config(self) -> GlowConfig:
        return GlowConfig(features=self.flow_dim, hidden_features=self.flow_hidden,
                          num_layers=self.flow_layers, num_blocks_per_layer=self.flow_depth,
                          context_features=self.context_feats_dim)


class ProHMRFlow(nn.Module):
    def __init__(self, cfg: ProHMRConfig):
        super().__init__()
        self.flow = Glow(cfg.glow_config())
        self.fc_head = FCHead(cfg.context_feats_dim, cfg.fc_head_hidden)


class ProHMR(nn.Module):
    def __init__(self, cfg: ProHMRConfig):
        super().__init__()
        if cfg.backbone_type != "resnet":
            raise ValueError(f"backbone_type {cfg.backbone_type!r}: the port "
                             "has the ResNet backbone only")
        self.backbone = ResNet(cfg.resnet_layers)
        self.scene_enc = ResnetPointnet(cfg.scene_feat_dim, cfg.pointnet_hidden_dim)
        self.flow = ProHMRFlow(cfg)


@torch.no_grad()
def init_random_(model: ProHMR, seed: int, *, training: bool = False) -> ProHMR:
    """Random weights from `seed`. The backbone and the scene encoder as
    `models.egohmr.init_random_` draws them (with `training`, as a training
    run starts; without, the BatchNorm statistics and the PointNet `fc_1`
    drawn too); the flow with the JAX package's init (`flow.init_glow_`:
    ActNorm and LU at the identity); the fc head's linear layers
    U(+-1/sqrt(fan_in)) but the last weight, Xavier-uniform with gain 0.02,
    and its `init_betas` 0, `init_cam` (0.9, 0, 0)."""
    _init_random_parts(model.backbone, seed, training=training)
    _init_random_parts(model.scene_enc, seed + 1, training=training)
    g = torch.Generator().manual_seed(seed + 2)
    init_glow_(model.flow.flow, g)
    head = model.flow.fc_head
    for lin in (head.layers[0], head.layers[2]):
        bound = 1.0 / math.sqrt(lin.in_features)
        lin.weight.copy_((torch.rand(lin.weight.shape, generator=g) * 2 - 1) * bound)
        lin.bias.copy_((torch.rand(lin.bias.shape, generator=g) * 2 - 1) * bound)
    out_f, in_f = head.layers[2].weight.shape
    bound = 0.02 * math.sqrt(6.0 / (in_f + out_f))
    head.layers[2].weight.copy_((torch.rand((out_f, in_f), generator=g) * 2 - 1) * bound)
    head.init_betas.zero_()
    head.init_cam.copy_(torch.tensor([[0.9, 0.0, 0.0]]))
    return model


@functools.lru_cache(maxsize=None)
def _index(device: torch.device, name: str) -> torch.Tensor:
    return torch.tensor(getattr(C, name), dtype=torch.int64, device=device)


def conditioning_feats(model: ProHMR, cfg: ProHMRConfig, batch: Dict[str, torch.Tensor], *,
                       train: bool = False, scene_cano: bool = False,
                       dp: Optional[DataParallel] = None) -> torch.Tensor:
    """The flow's context [B, context_feats_dim], ordered
    [cam_center][bbox][fx][img][scene]. `scene_cano` moves the scene into
    the GT body's frame (minus its translation). With a data-parallel
    record `dp`, the backbone's training statistics are the whole batch's."""
    img_feats = resnet_forward(model.backbone, batch["img"], train=train, dp=dp)
    orig_fx = batch["fx"] * cfg.fx_norm_coeff
    feats = []
    if cfg.with_cam_center:
        feats.append(torch.stack([batch["cam_cx"] / orig_fx, batch["cam_cy"] / orig_fx], -1))
    if cfg.with_bbox_info:
        feats.append(torch.stack([batch["box_center"][:, 0] / orig_fx,
                                  batch["box_center"][:, 1] / orig_fx,
                                  batch["box_size"] / orig_fx], -1))
    if cfg.with_focal_length:
        feats.append(batch["fx"][:, None])
    scene = batch["scene_pcd_verts_full"]
    if scene_cano:
        scene = scene - batch["smpl_params"]["transl"][:, None, :]
    # K1 has no backward and no CPU kernel: training and CPU tensors take
    # the plain encoder, as the JAX package does off the TPU
    if cfg.pointnet_impl == "fused" and not train and scene.device.type == "cuda":
        scene_feats = pointnet_forward_fused(model.scene_enc, scene)
    else:
        scene_feats = pointnet_forward(model.scene_enc, scene)
    return torch.cat(feats + [img_feats, scene_feats], dim=-1)


def gt_pose_prohmr_6d(batch: Dict) -> torch.Tensor:
    """GT axis-angle pose -> 144-d rot6d in the 'prohmr' layout (the first
    two columns of each rotation matrix, as rows)."""
    sp = batch["smpl_params"]
    B = sp["betas"].shape[0]
    aa = torch.cat([sp["global_orient"].reshape(B, 1, 3), sp["body_pose"].reshape(B, 23, 3)], 1)
    rotmat = aa_to_rotmat(aa.reshape(-1, 3))
    return rotmat[:, :, :2].transpose(1, 2).reshape(B, 144)


@torch.no_grad()
def initialize(model: ProHMR, cfg: ProHMRConfig, batch: Dict, *,
               scene_cano: bool = False) -> ProHMR:
    """ActNorm's data-dependent init, in place, from the batch's GT poses
    and eval-mode context."""
    ctx = conditioning_feats(model, cfg, batch, train=False, scene_cano=scene_cano)
    _initialize_actnorms(model.flow.flow, gt_pose_prohmr_6d(batch), ctx)
    return model


class ProHMROutput(NamedTuple):
    pred_pose_6d: torch.Tensor            # [B, S, 144] ('prohmr' layout)
    pred_pose_rotmat: torch.Tensor        # [B, S, 24, 3, 3]
    pred_betas: torch.Tensor              # [B, S, 10]
    pred_cam: torch.Tensor                # [B, S, 3] weak-perspective
    pred_cam_t: torch.Tensor              # [B, S, 3] crop camera translation
    pred_cam_t_full: torch.Tensor         # [B, S, 3] full-image translation (stage 2's input)
    log_prob: torch.Tensor                # [B, S]
    pred_keypoints_3d: torch.Tensor       # [B, S, 45, 3]
    pred_vertices: torch.Tensor           # [B, S, V, 3]
    pred_keypoints_3d_full: torch.Tensor  # [B, S, 45, 3]
    pred_keypoints_2d: torch.Tensor       # [B, S, 45, 2] crop, normalised
    pred_keypoints_2d_full: torch.Tensor  # [B, S, 45, 2] full image, normalised
    conditioning_feats: torch.Tensor      # [B, ctx]


def forward(model: ProHMR, cfg: ProHMRConfig, smpl: SMPLModel, batch: Dict,
            num_samples: int, *, generator: Optional[torch.Generator] = None,
            z: Optional[torch.Tensor] = None, train: bool = False,
            scene_cano: bool = False, dp: Optional[DataParallel] = None) -> ProHMROutput:
    """`num_samples` poses per image; sample 0 is always the mode, z = 0.
    `z` [B, S, 144] is the noise to map (its sample 0 must be zeros), or
    samples 1.. are drawn from `generator` on the batch's device. `dp`: the
    data-parallel record of `conditioning_feats`."""
    B = batch["img"].shape[0]
    S = num_samples
    with span("prohmr.condition"):
        ctx = conditioning_feats(model, cfg, batch, train=train, scene_cano=scene_cano, dp=dp)
    with span("prohmr.glow"):
        if z is None:
            z = ctx.new_zeros((B, S, cfg.flow_dim))
            if S > 1:
                z[:, 1:] = torch.randn((B, S - 1, cfg.flow_dim), generator=generator,
                                       device=ctx.device)
        pose_6d, log_prob = glow_sample_and_log_prob(model.flow.flow, ctx, z)
    with span("prohmr.bodies"):
        return _bodies(model, cfg, smpl, batch, ctx, pose_6d, log_prob)


def _bodies(model: ProHMR, cfg: ProHMRConfig, smpl: SMPLModel, batch: Dict,
            ctx: torch.Tensor, pose_6d: torch.Tensor, log_prob: torch.Tensor) -> ProHMROutput:
    """`forward`'s bodies from the flow's poses [B, S, 144]: the fc head's
    betas and crop camera, SMPL, and the camera into the crop and the full
    image."""
    B, S = pose_6d.shape[:2]
    rotmat = rot6d_to_rotmat(pose_6d.reshape(B * S, -1), "prohmr").reshape(B, S, 24, 3, 3)

    betas, cam = fc_head(model.flow.fc_head, ctx)
    betas = betas[:, None].expand(B, S, 10)
    cam = cam[:, None].expand(B, S, 3)
    out = lbs(smpl, betas.reshape(B * S, 10), rotmat[:, :, :1].reshape(B * S, 1, 3, 3),
              rotmat[:, :, 1:].reshape(B * S, 23, 3, 3), pose2rot=False)
    kp3d = out.joints.reshape(B, S, -1, 3)
    verts = out.vertices.reshape(B, S, -1, 3)

    if cfg.with_focal_length:
        fl = (batch["fx"] * cfg.fx_norm_coeff)[:, None, None].expand(B, S, 2)
        cc_full = torch.stack([batch["cam_cx"], batch["cam_cy"]], -1)[:, None].expand(B, S, 2)
    else:
        fl = ctx.new_full((B, S, 2), cfg.default_focal_length)
        cc_full = ctx.new_tensor([cfg.full_img_w / 2, cfg.full_img_h / 2]).expand(B, S, 2)
    pred_cam_t = torch.stack([cam[..., 1], cam[..., 2],
                              2 * fl[..., 0] / (cfg.img_size * cam[..., 0] + 1e-9)], -1)

    def flat(a):
        return a.reshape(B * S, *a.shape[2:])

    cam_t_full = convert_pare_to_full_img_cam(
        pare_cam=flat(cam), bbox_height=batch["box_size"][:, None].expand(B, S).reshape(-1),
        bbox_center=batch["box_center"][:, None].expand(B, S, 2).reshape(-1, 2),
        img_w=flat(cc_full)[:, 0] * 2, img_h=flat(cc_full)[:, 1] * 2,
        focal_length=flat(fl)[:, 0], crop_res=cfg.img_size)  # [B*S, 3]
    kp3d_flat = flat(kp3d)
    kp3d_full = (kp3d_flat + cam_t_full[:, None]).reshape(B, S, -1, 3)
    kp2d_full = perspective_projection(kp3d_flat, cam_t_full, flat(fl), flat(cc_full))
    kp2d_full = torch.stack([kp2d_full[..., 0] / cfg.full_img_w - 0.5,
                             kp2d_full[..., 1] / cfg.full_img_h - 0.5], -1).reshape(B, S, -1, 2)
    kp2d_crop = perspective_projection(kp3d_flat, flat(pred_cam_t), flat(fl))
    kp2d_crop = (kp2d_crop / cfg.img_size).reshape(B, S, -1, 2)
    return ProHMROutput(
        pred_pose_6d=pose_6d, pred_pose_rotmat=rotmat, pred_betas=betas, pred_cam=cam,
        pred_cam_t=pred_cam_t, pred_cam_t_full=cam_t_full.reshape(B, S, 3), log_prob=log_prob,
        pred_keypoints_3d=kp3d, pred_vertices=verts, pred_keypoints_3d_full=kp3d_full,
        pred_keypoints_2d=kp2d_crop, pred_keypoints_2d_full=kp2d_full, conditioning_feats=ctx)


@dataclass(frozen=True)
class ProHMRLossWeights:
    """A copy of egohmr_tpu.models.prohmr.ProHMRLossWeights."""

    v2v_exp: float = 0.0
    v2v_mode: float = 0.5
    keypoints_3d_exp: float = 0.0
    keypoints_3d_mode: float = 0.05
    keypoints_3d_full_exp: float = 0.0
    keypoints_3d_full_mode: float = 0.02
    keypoints_2d_exp: float = 0.001
    keypoints_2d_mode: float = 0.01
    keypoints_2d_full_exp: float = 0.001
    keypoints_2d_full_mode: float = 0.01
    global_orient_exp: float = 0.0
    global_orient_mode: float = 0.001
    body_pose_exp: float = 0.0
    body_pose_mode: float = 0.001
    betas_exp: float = 0.0
    betas_mode: float = 0.0005
    orthogonal: float = 0.1
    nll: float = 0.001
    adversarial: float = 0.0005
    with_full_2d_loss: bool = True
    with_global_3d_loss: bool = True


def compute_loss(model: ProHMR, cfg: ProHMRConfig, w: ProHMRLossWeights,
                 smpl_male: SMPLModel, smpl_female: SMPLModel, batch: Dict,
                 out: ProHMROutput, *, train: bool,
                 nll_noise: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {term: value}). In training the GT pose whose NLL is taken
    carries noise of `cfg.smpl_param_noise_ratio`: `nll_noise` [B, 144]
    (standard normal), which training must hand in (`train/prohmr_loop.py:
    generator_loss` draws it)."""
    B, S = out.pred_pose_6d.shape[:2]
    dev = out.pred_pose_6d.device
    s2o = _index(dev, "SMPL_TO_OPENPOSE")
    ign = torch.ones(25, device=dev)
    ign[_index(dev, "KEYPOINT_2D_IGNORE_JOINTS")] = 0.0
    gtp = batch["smpl_params"]

    def kp2d_loss(pred, gt):  # [B, S, 25, 2] vs [B, 25, 3] -> [B, S]
        conf = gt[:, None, :, 2:] * ign[None, None, :, None]
        return (conf * (pred - gt[:, None, :, :2]).abs()).sum((2, 3))

    def kp3d_loss(pred, gt, align):  # -> [B, S]
        g = gt[:, None]
        if align:
            pred, g = pred - pred[:, :, :1], g - g[:, :, :1]
        return (pred - g).abs().sum((2, 3))

    l_kp2d = kp2d_loss(out.pred_keypoints_2d[:, :, s2o], batch["keypoints_2d"])
    l_kp2d_full = kp2d_loss(out.pred_keypoints_2d_full[:, :, s2o], batch["orig_keypoints_2d"])
    l_kp3d = kp3d_loss(out.pred_keypoints_3d[:, :, :24], batch["keypoints_3d"][:, :24], True)
    l_kp3d_full = kp3d_loss(out.pred_keypoints_3d_full[:, :, :24],
                            batch["keypoints_3d_full"][:, :24], False)

    gt_m = lbs(smpl_male, gtp["betas"], gtp["global_orient"], gtp["body_pose"], pose2rot=True)
    gt_f = lbs(smpl_female, gtp["betas"], gtp["global_orient"], gtp["body_pose"], pose2rot=True)
    is_f = (batch["gender"] == 1)[:, None, None]
    gt_verts = torch.where(is_f, gt_f.vertices, gt_m.vertices)
    gt_pelvis = torch.where(is_f, gt_f.joints[:, :1], gt_m.joints[:, :1])
    l_v2v = ((out.pred_vertices - out.pred_keypoints_3d[:, :, :1])
             - (gt_verts - gt_pelvis)[:, None]).abs().mean((2, 3))  # [B, S]

    gt_go = aa_to_rotmat(gtp["global_orient"].reshape(-1, 3)).reshape(B, 1, 1, 3, 3)
    gt_bp = aa_to_rotmat(gtp["body_pose"].reshape(-1, 3)).reshape(B, 1, 23, 3, 3)
    l_go = (out.pred_pose_rotmat[:, :, :1] - gt_go).square().sum((2, 3, 4))
    l_bp = (out.pred_pose_rotmat[:, :, 1:] - gt_bp).square().sum((2, 3, 4))
    l_betas = (out.pred_betas - gtp["betas"][:, None]).square().sum(-1)

    zero = l_kp2d.new_zeros(())

    def mode_exp(loss):  # [B, S] -> (mode, expectation)
        exp = loss[:, 1:].sum() / (B * max(S - 1, 1)) if S > 1 else zero
        return loss[:, 0].sum() / B, exp

    kp2d_m, kp2d_e = mode_exp(l_kp2d)
    kp2df_m, kp2df_e = mode_exp(l_kp2d_full)
    kp3d_m, kp3d_e = mode_exp(l_kp3d)
    kp3df_m, kp3df_e = mode_exp(l_kp3d_full)
    go_m, go_e = mode_exp(l_go)
    bp_m, bp_e = mode_exp(l_bp)
    betas_m, betas_e = mode_exp(l_betas)
    v2v_m = l_v2v[:, 0].mean()
    v2v_e = l_v2v[:, 1:].mean() if S > 1 else zero

    gt_6d = gt_pose_prohmr_6d(batch)
    if train:
        if nll_noise is None:
            raise ValueError("compute_loss(train=True) needs nll_noise")
        gt_6d = gt_6d + cfg.smpl_param_noise_ratio * nll_noise
    log_prob, _ = glow_log_prob(model.flow.flow, gt_6d, out.conditioning_feats)
    l_nll = -log_prob.mean()

    p6 = out.pred_pose_6d.reshape(-1, 2, 3)
    gram = p6 @ p6.transpose(1, 2)
    l_orth = (gram - torch.eye(2, device=dev)).square().reshape(B, S, -1)
    orth_m = l_orth[:, 0].mean()
    orth_e = l_orth[:, 1:].mean() if S > 1 else zero

    f2d = 1.0 if w.with_full_2d_loss else 0.0
    g3d = 1.0 if w.with_global_3d_loss else 0.0
    total = (w.keypoints_3d_exp * kp3d_e
             + w.keypoints_3d_full_exp * kp3df_e * g3d
             + w.v2v_exp * v2v_e
             + w.keypoints_2d_exp * kp2d_e * (1 - f2d)
             + w.keypoints_2d_full_exp * kp2df_e * f2d
             + w.nll * l_nll
             + w.orthogonal * (orth_e + orth_m)
             + w.global_orient_exp * go_e + w.body_pose_exp * bp_e
             + w.betas_exp * betas_e
             + w.keypoints_3d_mode * kp3d_m
             + w.keypoints_3d_full_mode * kp3df_m * g3d
             + w.v2v_mode * v2v_m
             + w.keypoints_2d_mode * kp2d_m * (1 - f2d)
             + w.keypoints_2d_full_mode * kp2df_m * f2d
             + w.global_orient_mode * go_m + w.body_pose_mode * bp_m
             + w.betas_mode * betas_m)
    losses = {
        "loss": total, "loss_nll": l_nll,
        "loss_keypoints_3d_mode": kp3d_m, "loss_keypoints_3d_exp": kp3d_e,
        "loss_keypoints_3d_full_mode": kp3df_m, "loss_keypoints_3d_full_exp": kp3df_e,
        "loss_keypoints_2d_mode": kp2d_m, "loss_keypoints_2d_exp": kp2d_e,
        "loss_keypoints_2d_full_mode": kp2df_m, "loss_keypoints_2d_full_exp": kp2df_e,
        "loss_v2v_mode": v2v_m, "loss_v2v_exp": v2v_e,
        "loss_pose_6d_mode": orth_m, "loss_pose_6d_exp": orth_e,
        "loss_global_orient_mode": go_m, "loss_body_pose_mode": bp_m,
        "loss_betas_mode": betas_m,
    }
    return total, losses
