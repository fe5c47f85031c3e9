"""Stage-2 EgoHMR (port of egohmr_tpu/models/egohmr.py).

  compute_condition — image/scene/camera/translation conditioning and the
                      betas head, computed once per batch; in training with
                      batch-statistics BatchNorm and the condition dropped
                      at random
  make_denoise_fn   — the per-step x0 predictor over the ModulatedGCN, with
                      the conditioning half of its input matmul hoisted and
                      the cond/uncond branches fused into one doubled batch
  denoise_x0        — the predictor in one call, as training runs it
  make_guidance_fn  — the collision-score gradient w.r.t. x_t for guided
                      sampling (kernel K2 finds the nearest vertices)
  model_outputs     — SMPL skinning and full-image reprojection
  compute_loss      — the nine weighted training terms (the collision term
                      through K2), and in eval the visible-joint error sums

The module tree (`EgoHMR`) is named like the reference `state_dict`, so
`interop.state_dict_from_jax` weights load with `strict=True`. No function
here turns autograd off: the inference callers (`eval.pipeline`,
`serving`) run under `torch.no_grad()`, and training differentiates
through `compute_condition`, `denoise_x0`, `model_outputs` and
`compute_loss`.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..collision.sdf import (
    bbox_mask,
    collision_loss,
    gather_rows,
    nearest_vertex,
    signed_distance,
    topk_scene_points,
    topk_scene_points_near_body,
)
from ..diffusion.sampler import StatefulGuidanceFn
from ..geometry import aa_to_rotmat, perspective_projection, rot6d_to_rotmat
from ..nn import (
    FCHeadBeta,
    InputProcess,
    ModulatedGCN,
    ResNet,
    ResnetPointnet,
    TimestepEmbedder,
    TranslEnc,
    fc_head_beta,
    input_process,
    modulated_gcn_forward,
    modulated_gcn_forward_tp,
    pointnet_forward,
    pointnet_forward_fused,
    pointnet_forward_tp,
    resnet_forward,
    timestep_embed,
    transl_enc,
)
from ..nn.gcn import ModulatedGraphConv, NonLocalBlock
from ..nn.pointnet import ResnetBlockFC
from ..parallel.mesh import DataParallel
from ..parallel.tp import TensorParallel
from ..smpl import (
    SMPLModel,
    lbs,
    lbs_apply_select,
    lbs_transforms,
    vertex_normals,
)
from ..smpl import constants as C
from ..utils.profiling import mark


@dataclass(frozen=True)
class EgoHMRConfig:
    """Model hyperparameters; a copy of egohmr_tpu.models.EgoHMRConfig."""

    img_feat_dim: int = 2048
    resnet_layers: int = 50
    backbone_type: str = "resnet"  # "resnet" | "stub" (the stub is JAX-only)
    scene_feat_dim: int = 512
    pointnet_hidden_dim: int = 256
    transl_embed_dim: int = 128
    timestep_embed_dim: int = 512
    input_process_dim: int = 512
    gcn_hid_dim: int = 1024
    gcn_layers: int = 4
    gcn_nonlocal_layer: bool = False
    # "xla": the scene encoder as plain torch matmuls in the parameter
    # dtype; "fused": kernel K1 (bf16 arithmetic, f32 pooled feature)
    pointnet_impl: str = "xla"
    with_focal_length: bool = True
    with_bbox_info: bool = True
    with_cam_center: bool = True
    cond_mask_prob: float = 0.01
    only_mask_img_cond: bool = True
    pelvis_vis_loosen: bool = False
    diffuse_fuse: bool = True
    fx_norm_coeff: float = 1500.0
    default_focal_length: float = 5000.0
    img_size: int = 224
    full_img_w: float = 1920.0
    full_img_h: float = 1080.0

    @property
    def cam_feat_dim(self) -> int:
        return ((1 if self.with_focal_length else 0)
                + (3 if self.with_bbox_info else 0)
                + (2 if self.with_cam_center else 0))

    @property
    def context_feats_dim(self) -> int:
        return (self.img_feat_dim + self.scene_feat_dim
                + self.transl_embed_dim + self.cam_feat_dim)

    @property
    def gcn_in_dim(self) -> int:
        return (self.context_feats_dim + self.input_process_dim
                + self.timestep_embed_dim)


class BodyRepStats(NamedTuple):
    """144-d rot6d pose normalisation stats."""

    mean: torch.Tensor  # [144]
    std: torch.Tensor   # [144]


class Condition(NamedTuple):
    """Everything the denoiser needs that does not depend on (x_t, t)."""

    cond: torch.Tensor           # [B, 24, Dc]
    cond_uncond: torch.Tensor    # [B, 24, Dc] image features zeroed
    vis_mask_smpl: torch.Tensor  # [B, 24] bool
    pred_betas: torch.Tensor     # [B, 10]
    img_feats: torch.Tensor      # [B, img_feat_dim]
    scene_feats: torch.Tensor    # [B, scene_feat_dim]
    input_transl: torch.Tensor   # [B, 3]
    scene_pcd: torch.Tensor      # [B, P, 3] f32 (canonicalised)
    focal_length: torch.Tensor   # [B, 2]
    camera_center: torch.Tensor  # [B, 2]


class EgoHMR(nn.Module):
    def __init__(self, cfg: EgoHMRConfig):
        super().__init__()
        if cfg.backbone_type != "resnet":
            raise ValueError(f"backbone_type {cfg.backbone_type!r}: the port "
                             "has the ResNet backbone only")
        self.backbone = ResNet(cfg.resnet_layers)
        self.scene_enc = ResnetPointnet(cfg.scene_feat_dim, cfg.pointnet_hidden_dim)
        self.transl_enc = TranslEnc(3, cfg.transl_embed_dim)
        self.embed_timestep = TimestepEmbedder(cfg.timestep_embed_dim)
        self.input_process = InputProcess(6, cfg.input_process_dim)
        self.diffusion_model = ModulatedGCN(cfg.gcn_in_dim, cfg.gcn_hid_dim, 6,
                                            cfg.gcn_layers, cfg.gcn_nonlocal_layer)
        self.beta_layer = FCHeadBeta(cfg.context_feats_dim)


@torch.no_grad()
def init_random_(model: nn.Module, seed: int, *, training: bool = False) -> nn.Module:
    """Fill `model` (an EgoHMR or any of its parts) with random weights
    drawn from `seed`, with the JAX package's init distributions, except
    that every weight is drawn (JAX zero-initialises the PointNet `fc_1`,
    which would hide half of K1's products) and the BatchNorm statistics
    are random too.

    `training`: the values the JAX package sets rather than draws, as a
    training run starts: every BatchNorm at weight 1, bias 0, statistics 0
    and 1 (the non-local block's output BatchNorm at weight 0, so the block
    starts as the identity), and the PointNet `fc_1` weights at 0."""
    g = torch.Generator().manual_seed(seed)

    def uniform_(t, bound):
        t.copy_((torch.rand(t.shape, generator=g) * 2 - 1) * bound)

    for m in model.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            uniform_(m.weight, bound)
            if m.bias is not None:
                uniform_(m.bias, bound)
        elif isinstance(m, nn.Conv2d) and m.bias is not None:
            # the non-local block's 1x1 convs, per-node linears in JAX
            bound = 1.0 / math.sqrt(m.in_channels)
            uniform_(m.weight, bound)
            uniform_(m.bias, bound)
        elif isinstance(m, nn.Conv2d):
            n = m.kernel_size[0] * m.kernel_size[1] * m.out_channels
            m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                           * math.sqrt(2.0 / n))
        elif isinstance(m, ModulatedGraphConv):
            for w in (m.W, m.M):
                fan_in, fan_out = w.shape[-2], w.shape[-1]
                uniform_(w, 1.414 * math.sqrt(6.0 / (fan_in + fan_out)))
            m.adj2.fill_(1e-6)
            uniform_(m.bias, 1.0 / math.sqrt(m.bias.shape[0]))
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            c = m.num_features
            m.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
            m.bias.copy_(0.1 * torch.randn(c, generator=g))
            m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
            m.running_var.copy_(1 + 0.1 * torch.rand(c, generator=g))
        elif isinstance(m, FCHeadBeta):
            m.init_betas.zero_()
    if training:
        for m in model.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
        for m in model.modules():
            if isinstance(m, NonLocalBlock):
                m.W[1].weight.zero_()
            elif isinstance(m, ResnetBlockFC):
                m.fc_1.weight.zero_()
    return model


# Constants live on the device once: building them per call would copy from
# pageable host memory, which waits for all work queued on the stream and
# stops the host from running ahead of the card.
@functools.lru_cache(maxsize=None)
def _adjacency(device: torch.device) -> torch.Tensor:
    return torch.tensor(C.joint_adjacency(), dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _openpose_to_smpl(device: torch.device, loosened: bool) -> torch.Tensor:
    o2s = C.OPENPOSE_TO_SMPL_PELVIS_LOOSENED if loosened else C.OPENPOSE_TO_SMPL
    return torch.tensor(o2s, dtype=torch.int64, device=device)


def _cam_feats(cfg: EgoHMRConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[B, cam_feat_dim], ordered [cam_center][bbox][fx]."""
    feats = []
    orig_fx = batch["fx"] * cfg.fx_norm_coeff
    if cfg.with_cam_center:
        feats.append(torch.stack([batch["cam_cx"] / orig_fx,
                                  batch["cam_cy"] / orig_fx], dim=-1))
    if cfg.with_bbox_info:
        feats.append(torch.stack([batch["box_center"][:, 0] / orig_fx,
                                  batch["box_center"][:, 1] / orig_fx,
                                  batch["box_size"] / orig_fx], dim=-1))
    if cfg.with_focal_length:
        feats.append(batch["fx"][:, None])
    if not feats:
        return batch["fx"].new_zeros((batch["fx"].shape[0], 0))
    return torch.cat(feats, dim=-1)


def compute_condition(model: EgoHMR, cfg: EgoHMRConfig,
                      batch: Dict[str, torch.Tensor], *, train: bool = False,
                      drop: Optional[torch.Tensor] = None,
                      dp: Optional[DataParallel] = None,
                      tp: Optional[TensorParallel] = None) -> Condition:
    """Run all conditioners once. The scene cloud is moved into the body's
    frame (minus the input translation), as the reference does.

    `train`: every BatchNorm normalises by the batch's statistics and
    updates its running ones; the scene encoder is always the plain
    `pointnet_forward` (kernel K1 has no backward); and with
    `cfg.cond_mask_prob` > 0 an image's condition is replaced by the
    unconditional one where `drop` [B] bool is True (`train.stage2_loss`
    draws it). With a data-parallel record `dp`, the ResNet's training
    statistics are the whole batch's.

    `tp`: `model` placed over a data row's model axis (`model` is then
    `tp.module`); the scene encoder runs split (`pointnet_forward_tp`), the
    rest on the row's first device. Inference with the plain encoder only:
    `train` or `cfg.pointnet_impl == "fused"` raises (kernel K1 is one
    device's program, as JAX's `pallas_call` cannot be partitioned)."""
    if tp is not None and (train or cfg.pointnet_impl == "fused"):
        raise ValueError("tensor parallelism is inference with the plain scene encoder: "
                         f"got train={train}, pointnet_impl={cfg.pointnet_impl!r}")
    B = batch["img"].shape[0]
    img_feats = resnet_forward(model.backbone, batch["img"], train=train, dp=dp)
    mark("scene", img_feats)

    vis_openpose = batch["orig_keypoints_2d"][:, :, -1] > 0
    vis_openpose[:, 8] = True  # pelvis always visible
    o2s = _openpose_to_smpl(vis_openpose.device, cfg.pelvis_vis_loosen)
    vis_mask_smpl = vis_openpose[:, o2s]  # [B, 24]

    cam_feats = _cam_feats(cfg, batch)
    input_transl = batch["smpl_params"]["transl"]
    scene_pcd = batch["scene_pcd_verts_full"] - input_transl[:, None, :]
    # the encoder runs in the image dtype; Condition keeps the f32 cloud
    scene_in = scene_pcd.to(batch["img"].dtype)
    if tp is not None:
        scene_feats = pointnet_forward_tp(tp.sub("scene_enc"), scene_in)
    elif cfg.pointnet_impl == "fused" and not train:
        scene_feats = pointnet_forward_fused(model.scene_enc, scene_in)
    else:
        scene_feats = pointnet_forward(model.scene_enc, scene_in)
    transl_feat = transl_enc(model.transl_enc, input_transl)

    # the whole conditioning tensor stays in the encoder's input dtype, so
    # a bf16 path runs the denoiser in bf16 (f32 transl/cam features, and
    # K1's f32 pooled feature, are cast down rather than promoting `cond`)
    cdt = scene_in.dtype
    shared = torch.cat([scene_feats.to(cdt), transl_feat.to(cdt),
                        cam_feats.to(cdt)], dim=-1)
    shared24 = shared[:, None, :].expand(B, 24, shared.shape[-1])
    img24 = img_feats[:, None, :].expand(B, 24, img_feats.shape[-1])
    img24_vis = img24 * vis_mask_smpl[..., None].to(img24.dtype)
    cond = torch.cat([img24_vis, shared24], dim=-1)
    if cfg.only_mask_img_cond:
        cond_uncond = torch.cat([torch.zeros_like(img24), shared24], dim=-1)
    else:
        cond_uncond = torch.zeros_like(cond)
    if train and cfg.cond_mask_prob > 0.0:
        if drop is None:
            raise ValueError("training with cond_mask_prob > 0 needs the drop mask `drop`")
        cond = torch.where(drop[:, None, None], cond_uncond, cond)

    # the betas head sees the unmasked image features and runs in f32 (the
    # promoted dtype of its inputs), as in the JAX package
    beta_dt = torch.promote_types(img_feats.dtype, transl_feat.dtype)
    beta_in = torch.cat([img_feats.to(beta_dt), scene_feats.to(beta_dt),
                         transl_feat.to(beta_dt), cam_feats.to(beta_dt)], dim=-1)
    pred_betas = fc_head_beta(model.beta_layer, beta_in)

    if cfg.with_focal_length:
        fl = (batch["fx"] * cfg.fx_norm_coeff)[:, None].repeat(1, 2)
        cc = torch.stack([batch["cam_cx"], batch["cam_cy"]], dim=-1)
    else:
        fl = batch["fx"].new_full((B, 2), cfg.default_focal_length)
        cc = batch["fx"].new_tensor(
            [cfg.full_img_w / 2, cfg.full_img_h / 2]).expand(B, 2)
    return Condition(cond=cond, cond_uncond=cond_uncond,
                     vis_mask_smpl=vis_mask_smpl, pred_betas=pred_betas,
                     img_feats=img_feats, scene_feats=scene_feats,
                     input_transl=input_transl, scene_pcd=scene_pcd,
                     focal_length=fl, camera_center=cc)


def make_denoise_fn(model: EgoHMR, cfg: EgoHMRConfig, cond: Condition, *,
                    fuse: Optional[bool] = None, tp: Optional[TensorParallel] = None):
    """Closure (x_t [B, 144], t_orig [B]) -> predicted x0 [B, 144].

    The GCN input is x = [cond | input_process(x_t) | t_emb], so x @ W
    splits into cond @ W_c + xt @ W_x + temb @ W_t. The cond term is the
    same on every step and is projected here, once per sampling run.

    `tp`: `model` placed over a data row's model axis; the GCN runs split
    (`modulated_gcn_forward_tp`). Its input layer is column-parallel, so
    each shard projects with its own output columns of W_c, W_x and W_t, on
    its device; the embedders and the cond/uncond choice run on the row's
    first device."""
    fuse = cfg.diffuse_fuse if fuse is None else fuse
    adj = _adjacency(cond.cond.device)
    Dc, Dx = cfg.context_feats_dim, cfg.input_process_dim
    if tp is None:
        Ws = [model.diffusion_model.gconv_input[0].gconv.W]  # [2, gcn_in_dim, hid]
        conds = [(cond.cond, cond.cond_uncond)]
    else:
        gcn_tp = tp.sub("diffusion_model")
        Ws = [gcn_tp.layer(s, "gconv_input.0.gconv").W for s in range(tp.size)]
        conds = list(zip(tp.scatter(cond.cond), tp.scatter(cond.cond_uncond)))
    # per shard (one without `tp`): W_x, W_t and the projected cond terms
    # [2, B, 24, hid / tp]
    shards = [(W[:, Dc:Dc + Dx], W[:, Dc + Dx:],
               torch.einsum("bjd,wdh->wbjh", c, W[:, :Dc]),
               torch.einsum("bjd,wdh->wbjh", cu, W[:, :Dc]) if fuse else None)
              for W, (c, cu) in zip(Ws, conds)]
    vis = cond.vis_mask_smpl[..., None]

    def fn(x_t: torch.Tensor, t_orig: torch.Tensor) -> torch.Tensor:
        B = x_t.shape[0]
        t_emb = timestep_embed(model.embed_timestep, t_orig)
        x_feat = input_process(model.input_process, x_t.reshape(B, 24, 6))
        ins = ([(x_feat, t_emb)] if tp is None
               else list(zip(tp.scatter(x_feat), tp.scatter(t_emb))))
        hs = []
        for (Wx, Wt, ch, cuh), (xf, te) in zip(shards, ins):
            base = (torch.einsum("bjd,wdh->wbjh", xf, Wx)
                    + torch.einsum("bd,wdh->wbh", te, Wt)[:, :, None])
            if fuse:
                h_c, h_u = ch + base, cuh + base
                hs.append((torch.cat([h_c[0], h_u[0]]), torch.cat([h_c[1], h_u[1]])))
            else:
                h = ch + base
                hs.append((h[0], h[1]))
        if tp is None:
            out = modulated_gcn_forward(model.diffusion_model, adj, None, input_h=hs[0])
        else:
            out = modulated_gcn_forward_tp(gcn_tp, adj, None, input_h=hs)
        if fuse:
            out = torch.where(vis, out[:B], out[B:])
        return out.reshape(B, 24 * 6)

    return fn


def denoise_x0(model: EgoHMR, cfg: EgoHMRConfig, cond: Condition,
               x_t: torch.Tensor, t_orig: torch.Tensor,
               dp: Optional[DataParallel] = None) -> torch.Tensor:
    """Predicted normalised x0 [B, 144] from (x_t [B, 144], t_orig [B]) as
    training runs it: one GCN call on the whole input, the condition as
    drawn (no cond/uncond split), the GCN's BatchNorms on the batch's
    statistics (the whole data-parallel batch's with `dp`). Sampling goes
    through `make_denoise_fn`."""
    B = x_t.shape[0]
    t_emb = timestep_embed(model.embed_timestep, t_orig)
    t_emb24 = t_emb[:, None, :].expand(B, 24, t_emb.shape[-1])
    x_feat = input_process(model.input_process, x_t.reshape(B, 24, 6))
    feats = torch.cat([cond.cond, x_feat, t_emb24], dim=-1)
    out = modulated_gcn_forward(model.diffusion_model, _adjacency(x_t.device),
                                feats, train=True, dp=dp)
    return out.reshape(B, 24 * 6)


# --------------------------------------------------------------- guidance
# gradient scale per joint: only the pelvis-adjacent leg joints keep
# gradient, [1, 2] at x1 and [4, 5, 7, 8, 10, 11] at x2; the pelvis and the
# upper body get none.
_GUIDE_JOINT_SCALE = np.zeros((24,), np.float32)
_GUIDE_JOINT_SCALE[[1, 2]] = 1.0
_GUIDE_JOINT_SCALE[[4, 5, 7, 8, 10, 11]] = 2.0


# The guidance's constants, built once per device as `_adjacency` is: a
# copy from pageable host memory per request would wait for the stream, and
# inside a CUDA graph's capture it is an error.
@functools.lru_cache(maxsize=None)
def _guide_joint_scale(device: torch.device) -> torch.Tensor:
    return torch.tensor(_GUIDE_JOINT_SCALE, device=device)[None, :, None]


@functools.lru_cache(maxsize=None)
def _scene_permutation(n: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(np.random.RandomState(0).permutation(n), device=device)


def make_guidance_fn(
    model: EgoHMR,
    cfg: EgoHMRConfig,
    smpl: SMPLModel,
    cond: Condition,
    stats: BodyRepStats,
    *,
    max_scene_points: Optional[int] = 4096,
    per_step_points: Optional[int] = 1024,
    selection_refresh_every: int = 1,
    global_rows: Optional[int] = None,
):
    """Collision-score gradient w.r.t. x_t, batched with static shapes:
    returns fn(x_t [B, 144], t [B]) -> grad [B, 144]. `model` and `cfg` are
    unused (guidance has no parameters) and kept for the JAX package's
    signature.

    The body is posed without translation and compared against the
    canonicalised scene cloud `cond.scene_pcd`, which must be f32.

    `max_scene_points`: static top-K pre-filter of the scene points nearest
    the canonical origin, computed once per sampling run. Exact when every
    point within the body's reach fits in K; None disables it.

    `per_step_points`: second cap inside each guided step, the K2 points
    nearest the current posed body's bbox. The loss scores bbox-masked
    points only, so it is exact whenever the bbox's points fit in K2. It
    cuts the per-step nearest-vertex search, the step's largest cost, by
    K/K2. None disables it.

    Each guided step has two passes. `selection` is gradient-free: full
    LBS, vertex normals, the per-step cap, the bbox mask, the nearest
    vertex of every kept point (kernel K2 on the card) and the
    inside/outside sign from that vertex's normal. `neg_collision` is the
    differentiable one: only the selected vertices are re-posed
    (`lbs_apply_select`), so the backward is gathers from constant tables
    and matmuls over K2 points. That is exact: the argmin index and the
    sign are piecewise constant in x_t, so differentiating the
    selected-vertex distance alone is the full gradient. The gradient is
    taken under `torch.enable_grad()` on a detached copy of x_t, so the
    function works inside a `torch.no_grad()` caller and builds no graph
    outside `grad_given`.

    `selection_refresh_every`: 1 recomputes the selection on every guided
    step (exact). N > 1 returns a `StatefulGuidanceFn`: the sampler carries
    (pts, mask, nn_idx, sign) across guided steps and refreshes them on
    every N-th; in between, the selection is that of a body a few steps
    old, an approximation.

    `global_rows`: the number of bodies the differentiated batch mean runs
    over, by default x_t's. A shard of a data-parallel batch passes the
    whole batch's, so that each body feels the gradient it would in the
    1-way run: the shard's loss is its sum over the global count (each
    body's gradient depends on its own rows only, so no collective is
    needed)."""
    dev = cond.scene_pcd.device
    scale = _guide_joint_scale(dev)  # [1, 24, 1]
    betas = cond.pred_betas.detach()
    scene = topk_scene_points(cond.scene_pcd.detach(), max_scene_points)
    do_cap = per_step_points is not None and per_step_points < scene.shape[1]
    if do_cap:
        # fixed pre-shuffle: the per-step top-K ranks every in-bbox point at
        # distance 0, so ties break by array index, and on spatially ordered
        # crops that evicts with a spatial bias once the bbox holds more
        # than K2 points. A fixed permutation makes the tie-break unbiased
        # and keeps it deterministic across runs.
        scene = scene[:, _scene_permutation(scene.shape[1], dev)]
    K2 = per_step_points if do_cap else scene.shape[1]

    def rotmats(x_t: torch.Tensor) -> torch.Tensor:
        pose6d = x_t * stats.std + stats.mean
        return rot6d_to_rotmat(pose6d, "diffusion").reshape(-1, 24, 3, 3)

    @torch.no_grad()
    def selection(x_t: torch.Tensor):
        """Gradient-free full pass: posed mesh -> (pts, mask, nn_idx, sign)."""
        rotmat = rotmats(x_t)
        verts = lbs(smpl, betas, rotmat[:, :1], rotmat[:, 1:],
                    pose2rot=False).vertices
        normals = vertex_normals(verts, smpl.faces)
        pts = topk_scene_points_near_body(scene, verts, K2) if do_cap else scene
        mask = bbox_mask(pts, verts)
        idx = nearest_vertex(pts, verts).idx
        sign = torch.sign(torch.sum(
            (pts - gather_rows(verts, idx)) * gather_rows(normals, idx), dim=-1))
        sign = torch.where(sign == 0, torch.ones_like(sign), sign)
        return pts, mask, idx, sign

    def neg_collision(x_t: torch.Tensor, sel) -> torch.Tensor:
        # differentiable selective pass: re-pose only the selected vertices
        pts, mask, idx, sign = sel
        _, pf, _, rel = lbs_transforms(smpl, betas, rotmats(x_t))
        v_near = lbs_apply_select(smpl, betas, pf, rel, idx)
        sdf = sign * torch.linalg.norm(pts - v_near, dim=-1)
        per_body = collision_loss(sdf, mask.to(sdf.dtype))
        return -torch.sum(per_body) / (global_rows or per_body.shape[0])

    def grad_given(x_t: torch.Tensor, sel) -> torch.Tensor:
        with torch.enable_grad():
            x = x_t.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(neg_collision(x, sel), x)
        return (grad.reshape(-1, 24, 6) * scale).reshape(x_t.shape[0], 144)

    if selection_refresh_every <= 1:
        def fn(x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
            return grad_given(x_t, selection(x_t))

        return fn

    def init_state(x: torch.Tensor):
        return None  # the first guided step always refreshes

    def sfn(x_t: torch.Tensor, t: torch.Tensor, state, refresh: bool):
        sel = selection(x_t) if refresh else state
        return grad_given(x_t, sel), sel

    return StatefulGuidanceFn(init_state, sfn, selection_refresh_every)


def model_outputs(cfg: EgoHMRConfig, smpl: SMPLModel, cond: Condition,
                  pred_x_start: torch.Tensor,
                  stats: BodyRepStats) -> Dict[str, torch.Tensor]:
    """SMPL forward and projections for a denoised pose."""
    B = pred_x_start.shape[0]
    pred_pose_6d = pred_x_start * stats.std + stats.mean
    rotmat = rot6d_to_rotmat(pred_pose_6d, "diffusion").reshape(B, 24, 3, 3)
    out = lbs(smpl, cond.pred_betas, rotmat[:, :1], rotmat[:, 1:],
              pose2rot=False)
    kp3d = out.joints
    kp3d_full = kp3d + cond.input_transl[:, None, :]
    kp2d_full = perspective_projection(kp3d, cond.input_transl,
                                       cond.focal_length, cond.camera_center)
    kp2d_full = torch.stack([kp2d_full[..., 0] / cfg.full_img_w - 0.5,
                             kp2d_full[..., 1] / cfg.full_img_h - 0.5], dim=-1)
    return {
        "pred_x_start": pred_x_start,
        "pred_pose_6d": pred_pose_6d,
        "pred_pose_rotmat": rotmat,
        "pred_betas": cond.pred_betas,
        "pred_keypoints_3d": kp3d,
        "pred_keypoints_3d_full": kp3d_full,
        "pred_keypoints_2d_full": kp2d_full,
        "pred_vertices": out.vertices,
        "pred_joints_smpl": out.joints_smpl,
    }


# ------------------------------------------------------------------ losses
@dataclass(frozen=True)
class LossWeights:
    """Stage-2 loss weights (the reference's training defaults)."""

    v2v: float = 0.5
    keypoints_3d: float = 0.05
    keypoints_3d_full: float = 0.02
    keypoints_2d_full: float = 0.01
    betas: float = 0.0005
    body_pose: float = 0.001
    global_orient: float = 0.001
    pose_6d_ortho: float = 0.1
    coap_penetration: float = 0.0002
    start_coap_epoch: int = 3


@functools.lru_cache(maxsize=None)
def _loss_constants(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(SMPL -> OpenPose joint index [25], 2D keypoint weights [25] with the
    ignored joints at 0)."""
    ign = np.ones(25, np.float32)
    ign[list(C.KEYPOINT_2D_IGNORE_JOINTS)] = 0.0
    return (torch.tensor(C.SMPL_TO_OPENPOSE, dtype=torch.int64, device=device),
            torch.tensor(ign, device=device))


def compute_loss(
    cfg: EgoHMRConfig,
    weights: LossWeights,
    smpl_neutral: SMPLModel,
    smpl_male: SMPLModel,
    smpl_female: SMPLModel,
    batch: Dict[str, torch.Tensor],
    cond: Condition,
    outputs: Dict[str, torch.Tensor],
    *,
    train: bool,
    use_collision: bool = False,
    max_collision_points: Optional[int] = 4096,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The weighted stage-2 loss and its terms.

    `use_collision` turns the penetration term on (the CLI's
    `--start_coap_step`). It scores the `max_collision_points` scene points
    nearest the posed body's bbox (exact while the bbox's points fit), each
    by its signed distance to the body: the nearest vertex from kernel K2 on
    the card, the sign from that vertex's normal. Without `train`, the
    per-sample sums of the visible-joint error (the model-selection metric)
    come with the terms."""
    B = outputs["pred_keypoints_3d"].shape[0]
    s2o, ign = _loss_constants(outputs["pred_keypoints_3d"].device)

    pred_kp3d = outputs["pred_keypoints_3d"][:, :24]
    pred_kp3d_full = outputs["pred_keypoints_3d_full"][:, :24]
    pred_kp2d_full = outputs["pred_keypoints_2d_full"][:, s2o]  # [B, 25, 2]
    gt_kp2d_full = batch["orig_keypoints_2d"]  # [B, 25, 3]
    gt_kp3d = batch["keypoints_3d"][:, :24]
    gt_kp3d_full = batch["keypoints_3d_full"][:, :24]

    # 2D full-image keypoints: confidence-weighted L1, joints 1, 9, 12 ignored
    conf = gt_kp2d_full[:, :, 2:] * ign[None, :, None]
    loss_kp2d_full = torch.mean(torch.sum(
        conf * torch.abs(pred_kp2d_full - gt_kp2d_full[:, :, :2]), dim=(1, 2)))

    def pa(x):  # pelvis-aligned
        return x - x[:, :1]

    loss_kp3d = torch.mean(torch.sum(torch.abs(pa(pred_kp3d) - pa(gt_kp3d)), dim=(1, 2)))
    loss_kp3d_full = torch.mean(torch.sum(torch.abs(pred_kp3d_full - gt_kp3d_full), dim=(1, 2)))

    # the gendered ground-truth body for v2v
    gtp = batch["smpl_params"]
    gt_m = lbs(smpl_male, gtp["betas"], gtp["global_orient"], gtp["body_pose"],
               transl=gtp.get("transl"), pose2rot=True)
    gt_f = lbs(smpl_female, gtp["betas"], gtp["global_orient"], gtp["body_pose"],
               transl=gtp.get("transl"), pose2rot=True)
    is_f = (batch["gender"] == 1)[:, None, None]
    gt_vertices = torch.where(is_f, gt_f.vertices, gt_m.vertices)
    gt_joints = torch.where(is_f, gt_f.joints, gt_m.joints)
    pred_vertices = outputs["pred_vertices"]
    loss_v2v = torch.mean(torch.abs((pred_vertices - pred_kp3d[:, :1])
                                    - (gt_vertices - gt_joints[:, :1])))

    # SMPL parameters: squared error of the rotation matrices and betas
    gt_go_rot = aa_to_rotmat(gtp["global_orient"].reshape(-1, 3)).reshape(B, 1, 3, 3)
    gt_bp_rot = aa_to_rotmat(gtp["body_pose"].reshape(-1, 3)).reshape(B, 23, 3, 3)
    pred_rot = outputs["pred_pose_rotmat"]
    loss_global_orient = torch.sum(torch.square(pred_rot[:, :1] - gt_go_rot)) / B
    loss_body_pose = torch.sum(torch.square(pred_rot[:, 1:] - gt_bp_rot)) / B
    loss_betas = torch.sum(torch.square(outputs["pred_betas"] - gtp["betas"])) / B

    # orthonormality of the two rot6d columns ('diffusion' layout)
    p6 = outputs["pred_pose_6d"].reshape(-1, 3, 2)
    gram = torch.einsum("bij,bik->bjk", p6, p6)
    loss_ortho = torch.mean(torch.square(gram - torch.eye(2, device=gram.device)))

    if use_collision:
        scene = topk_scene_points_near_body(cond.scene_pcd, pred_vertices,
                                            max_collision_points)
        normals = vertex_normals(pred_vertices, smpl_neutral.faces)
        mask = bbox_mask(scene, pred_vertices.detach())
        sdf = signed_distance(scene, pred_vertices, normals)
        loss_coll = torch.mean(collision_loss(sdf, mask.to(sdf.dtype)))
    else:
        loss_coll = pred_vertices.new_zeros(())

    total = (weights.v2v * loss_v2v
             + weights.keypoints_3d * loss_kp3d
             + weights.keypoints_3d_full * loss_kp3d_full
             + weights.keypoints_2d_full * loss_kp2d_full
             + weights.betas * loss_betas
             + weights.body_pose * loss_body_pose
             + weights.global_orient * loss_global_orient
             + weights.pose_6d_ortho * loss_ortho
             + weights.coap_penetration * loss_coll)
    losses = {
        "loss": total,
        "loss_v2v": loss_v2v,
        "loss_keypoints_3d": loss_kp3d,
        "loss_keypoints_3d_full": loss_kp3d_full,
        "loss_keypoints_2d_full": loss_kp2d_full,
        "loss_betas": loss_betas,
        "loss_body_pose": loss_body_pose,
        "loss_global_orient": loss_global_orient,
        "loss_pose_6d_ortho": loss_ortho,
        "loss_coap_penetration": loss_coll,
    }
    if not train:
        # the visible-3D-joint error, the reference's model-selection metric
        gt_kp2d = perspective_projection(gt_joints, torch.zeros_like(gt_joints[:, 0]),
                                         cond.focal_length, cond.camera_center)[:, :24]
        u, v = gt_kp2d[..., 0], gt_kp2d[..., 1]
        vis = (u >= 0) & (u < cfg.full_img_w) & (v >= 0) & (v < cfg.full_img_h)
        err = torch.linalg.norm(pa(pred_kp3d) - pa(gt_kp3d), dim=-1) * vis
        # per-sample sums, so callers can leave padded rows out
        losses["loss_keypoints_3d_vis_per_sample"] = err.sum(dim=1)
        losses["joint_vis_num_per_sample"] = vis.sum(dim=1)
        losses["loss_keypoints_3d_vis_batch_sum"] = err.sum()
        losses["joint_vis_num_batch"] = vis.sum()
    return total, losses
