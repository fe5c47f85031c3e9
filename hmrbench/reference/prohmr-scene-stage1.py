"""Plain reference of stage 1 (ProHMR-scene), the yardstick of the cells on
the `prohmr-scene-stage1` configuration.

Plain PyTorch, from the published description (ProHMR with a scene
encoder, as sanweiliti/EgoHMR's prohmr.yaml and test_prohmr_scene.py run
it): the context of camera, box, focal length, ResNet-50 image features
and ResnetPointnet scene features; the conditional Glow flow over the 144-d
6-D pose (each step ActNorm, an LU-parameterised invertible linear map and
an affine coupling whose scale and shift come from a residual net gated by
the context), inverted from z (z = 0 for sample 0, the mode); the betas and
crop-camera head; SMPL; the crop camera turned into the full-image
translation; the reprojection. The flow's linear map is inverted by a
dense solve of L U, not by two triangular solves. It imports nothing of the
program: weights, body tables and inputs are the benchmark's own, and z is
drawn here again from the request's seed.

The stages can be run one by one: `context` (the conditioning), `flow`
(the flow's inverse, the head, SMPL and the camera, from a given context)
and `posed` (SMPL and the camera, from given poses, betas and crop
cameras), so that a check can judge each stage of a program on the
program's own input to it.

Everything runs in float32 with TF32 off (`exact()`). The control runs
each part one precision below what the program runs it in (`CONTROL`):
ResNet-50's convolutions (float32 with cuDNN's TF32 allowed) in bfloat16;
the scene PointNet (kernel K1: bfloat16 in, float32 accumulation) in
float8 e4m3; the flow's and the head's matmuls and solves, SMPL and the
camera (float32, TF32 off) in TF32.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from hmrbench.reference.plain import (  # noqa: F401 (exact, Prec: the drivers' API)
    F32, Prec, Tensor, exact, linear, pointnet, resnet50, smpl)

FLOW = "flow.flow._transform._transforms"
NET_KEYS = ("pred_pose_6d", "pred_betas", "pred_cam", "log_prob")
POSED_KEYS = ("pred_cam_t_full", "pred_keypoints_3d", "pred_keypoints_2d_full")
OUTPUT_KEYS = NET_KEYS + POSED_KEYS


class Precs(NamedTuple):
    """The rounding of each part's matmul and convolution operands."""

    conv: Prec = F32    # ResNet-50's convolutions
    scene: Prec = F32   # the scene PointNet
    flow: Prec = F32    # the flow's matmuls and solves, the head's matmuls
    body: Prec = F32    # SMPL's matmuls and the camera's arithmetic


EXACT = Precs()
CONTROL = Precs(conv=Prec("bf16"), scene=Prec("fp8"), flow=Prec("tf32"), body=Prec("tf32"))


def context_parts(m: Dict) -> Dict[str, slice]:
    """The context's columns: camera and box, image features, scene
    features."""
    cam, img = 6, 6 + m["img_feat_dim"]
    return {"cam": slice(0, cam), "img": slice(cam, img),
            "scene": slice(img, img + m["scene_feat_dim"])}


def context(W, m: Dict, batch: Dict[str, Tensor], p: Precs = EXACT) -> Tensor:
    """[B, 6 + 2048 + 512]: camera centre, box, focal length (each over the
    focal length in pixels but the last), image features, scene features."""
    fx = batch["fx"] * m["fx_norm_coeff"]
    cam = torch.stack([batch["cam_cx"] / fx, batch["cam_cy"] / fx,
                       batch["box_center"][:, 0] / fx, batch["box_center"][:, 1] / fx,
                       batch["box_size"] / fx, batch["fx"]], dim=-1)
    return torch.cat([cam, resnet50(W, batch["img"], p.conv),
                      pointnet(W, "scene_enc", batch["scene_pcd_verts_full"], p.scene)], dim=-1)


def split(features: int, step: int):
    """(identity, transformed) features of step `step`: nflows' mask, -1 on
    the even features and 1 on the odd ones, negated on odd steps."""
    mask = np.ones(features)
    mask[::2] = -1
    if step % 2 == 1:
        mask = -mask
    idx = np.arange(features)
    return idx[mask <= 0], idx[mask > 0]


def lu(W, pre: str, n: int, p: Prec):
    """(L U, bias, log|det|) of an LU-parameterised linear map."""
    dev = W[pre + ".bias"].device
    rows, cols = torch.tril_indices(n, n, -1, device=dev)
    L = torch.eye(n, device=dev)
    L[rows, cols] = W[pre + ".lower_entries"]
    diag = F.softplus(W[pre + ".unconstrained_upper_diag"]) + 1e-3
    U = torch.diag(diag)
    rows, cols = torch.triu_indices(n, n, 1, device=dev)
    U[rows, cols] = W[pre + ".upper_entries"]
    return p(L) @ p(U), W[pre + ".bias"], torch.log(diag).sum()


def coupling_net(W, pre: str, x: Tensor, ctx: Tensor, blocks: int, p: Prec) -> Tensor:
    h = linear(W, pre + ".initial_layer", torch.cat([x, ctx], dim=-1), p)
    for j in range(blocks):
        b = f"{pre}.blocks.{j}"
        t = linear(W, b + ".linear_layers.0", F.relu(h), p)
        t = linear(W, b + ".linear_layers.1", F.relu(t), p)
        h = h + t * torch.sigmoid(linear(W, b + ".context_layer", ctx, p))
    return linear(W, pre + ".final_layer", h, p)


def flow_inverse(W, m: Dict, z: Tensor, ctx: Tensor, p: Prec = F32):
    """Noise z [N, F] -> poses [N, F] and log|det| of the map."""
    n, logdet = m["flow_dim"], torch.zeros(z.shape[0], device=z.device)
    x = z
    for k in reversed(range(m["flow_layers"])):
        ident, trans = split(n, k)
        ident_t = torch.as_tensor(ident, device=z.device)
        trans_t = torch.as_tensor(trans, device=z.device)
        raw = coupling_net(W, f"{FLOW}.{3 * k + 2}.transform_net", x[:, ident_t], ctx,
                           m["flow_depth"], p)
        half = trans.shape[0]
        scale = torch.sigmoid(raw[:, half:] + 2.0) + 1e-3
        out = x.clone()
        out[:, trans_t] = (x[:, trans_t] - raw[:, :half]) / scale
        logdet = logdet - torch.log(scale).sum(-1)
        A, bias, ld = lu(W, f"{FLOW}.{3 * k + 1}", n, p)
        x = torch.linalg.solve(p(A), p(out - bias).T).T
        logdet = logdet - ld
        an = f"{FLOW}.{3 * k}"
        x = (x - W[an + ".shift"]) * torch.exp(-W[an + ".log_scale"])
        logdet = logdet - W[an + ".log_scale"].sum()
    return x, logdet


def rot6d_rows_to_rotmat(x: Tensor) -> Tensor:
    """6-D rotation, the two 3-vectors as rows -> [N, 3, 3]."""
    m = x.reshape(-1, 2, 3)
    b1 = F.normalize(m[:, 0], dim=-1, eps=1e-12)
    a2 = m[:, 1]
    b2 = F.normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1, dim=-1, eps=1e-12)
    return torch.stack([b1, b2, torch.cross(b1, b2, dim=-1)], dim=-1)


def forward(W, m: Dict, S: Dict, batch: Dict[str, Tensor], seed: int, num_samples: int,
            p: Precs = EXACT) -> Dict[str, Tensor]:
    """One batch: `num_samples` bodies per image -> outputs [B, S, ...],
    with the batch's `context` [B, C]."""
    ctx = context(W, m, batch, p)
    return dict(flow(W, m, S, batch, ctx, seed, num_samples, p), context=ctx)


def flow(W, m: Dict, S: Dict, batch: Dict[str, Tensor], ctx: Tensor, seed: int,
         num_samples: int, p: Precs = EXACT) -> Dict[str, Tensor]:
    """The batch's bodies from its context `ctx` [B, C]: outputs
    [B, S, ...]."""
    B, n = batch["img"].shape[0], m["flow_dim"]
    dev = batch["img"].device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    z = torch.zeros(B, num_samples, n, device=dev)
    if num_samples > 1:
        z[:, 1:] = torch.randn((B, num_samples - 1, n), generator=gen, device=dev)
    zf = z.reshape(B * num_samples, n)
    pose, logdet = flow_inverse(W, m, zf, ctx.repeat_interleave(num_samples, 0), p.flow)
    log_prob = -0.5 * (zf * zf).sum(-1) - 0.5 * n * math.log(2 * math.pi) - logdet
    h = F.relu(linear(W, "flow.fc_head.layers.0", ctx, p.flow))
    off = linear(W, "flow.fc_head.layers.2", h, p.flow)
    betas = (off[:, :10] + W["flow.fc_head.init_betas"]).repeat_interleave(num_samples, 0)
    cam = (off[:, 10:] + W["flow.fc_head.init_cam"]).repeat_interleave(num_samples, 0)
    out = {"pred_pose_6d": pose, "pred_betas": betas, "pred_cam": cam, "log_prob": log_prob,
           **posed(m, S, batch, pose, betas, cam, num_samples, p.body)}
    return {k: v.reshape(B, num_samples, *v.shape[1:]) for k, v in out.items()}


def camera(m: Dict, batch: Dict[str, Tensor], num_samples: int):
    """(focal length in pixels, principal point x and y, box size, box
    centre), one row per body."""
    rows = (batch["fx"] * m["fx_norm_coeff"], batch["cam_cx"], batch["cam_cy"],
            batch["box_size"], batch["box_center"])
    return tuple(x.repeat_interleave(num_samples, 0) for x in rows)


def posed(m: Dict, S: Dict, batch: Dict[str, Tensor], pose: Tensor, betas: Tensor,
          cam: Tensor, num_samples: int, q: Prec = F32) -> Dict[str, Tensor]:
    """The bodies of poses [N, 144], betas [N, 10] and crop cameras [N, 3]:
    the translation in the full image, SMPL's keypoints and their
    reprojection into the full image."""
    f, cx, cy, size, center = (q(x) for x in camera(m, batch, num_samples))
    # PARE's crop camera (s, tx, ty) -> the translation in the full image
    s, tx, ty = q(cam).unbind(-1)
    transl = torch.stack([tx + 2.0 * (center[:, 0] - cx) / (s * size),
                          ty + 2.0 * (center[:, 1] - cy) / (s * size),
                          2.0 * f / (size / m["img_size"] * m["img_size"] * s)], dim=-1)
    body = smpl(S, betas, rot6d_rows_to_rotmat(pose).reshape(-1, 24, 3, 3), q)
    kp3d = body.joints
    pts = kp3d + transl[:, None]
    px = pts[..., :2] / pts[..., 2:3] * f[:, None, None] + torch.stack([cx, cy], -1)[:, None]
    kp2d = torch.stack([px[..., 0] / m["full_img_w"] - 0.5, px[..., 1] / m["full_img_h"] - 0.5],
                       dim=-1)
    return {"pred_cam_t_full": transl, "pred_keypoints_3d": kp3d, "pred_keypoints_2d_full": kp2d}
