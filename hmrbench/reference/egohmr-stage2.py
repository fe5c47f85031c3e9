"""Plain reference of stage 2 (EgoHMR), the yardstick of the cells on the
`egohmr-stage2` configuration.

Plain PyTorch, from the published description of the model (sanweiliti/
EgoHMR: ResNet-50 image features, the ResnetPointnet scene encoder, the
translation and camera features, the betas head, the modulated-GCN x0
denoiser under classifier-free conditioning, DDIM over a respaced cosine
schedule, SMPL skinning and the full-image reprojection), written without
the program's fusions: the classifier-free branches are two plain
denoiser calls, the scene encoder concatenates its pooled feature and the
skinning is the textbook chain. It imports nothing of the program and
takes from it nothing but the outputs it judges: weights, body tables and
inputs are the benchmark's own (`lib/synth.py`), and x_T and the schedule
are worked out here again from the seed and the configuration.

Every matmul and convolution runs in float32 with TF32 off (`exact()`).
The control runs each part one precision below what the configuration
states: `p=Prec("fp8")` rounds the operands of the conditioning's and the
denoiser's matmuls and convolutions (bfloat16 in the configuration) to
float8 e4m3 with one scale per tensor, and `q=Prec("tf32")` those of
SMPL's (float32 with TF32 off) to TF32. The layers both stages share are
in `plain.py`.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from hmrbench.reference.plain import (  # noqa: F401 (exact, Prec: the drivers' API)
    F32, Prec, Tensor, batchnorm, exact, linear, pointnet, resnet50, rot6d_to_rotmat, smpl)

SMPL_EDGES = [(0, 1), (0, 2), (0, 3), (1, 4), (2, 5), (3, 6), (4, 7), (5, 8), (6, 9),
              (7, 10), (8, 11), (9, 12), (9, 13), (9, 14), (12, 15), (13, 16), (14, 17),
              (16, 18), (17, 19), (18, 20), (19, 21), (20, 22), (21, 23)]
# per SMPL joint, the OpenPose joint whose confidence makes it visible
OPENPOSE_TO_SMPL = [8, 12, 9, 8, 13, 10, 8, 14, 11, 8, 14, 11, 0, 5, 2, 0, 5, 2, 6, 3, 7,
                    4, 7, 4]


# ------------------------------------------------------------- schedule
class Schedule(NamedTuple):
    alphas_cumprod_prev: Tensor
    recip: Tensor
    recipm1: Tensor
    timestep_map: Tensor

    @property
    def steps(self) -> int:
        return self.timestep_map.shape[0]


def schedule(num_timesteps: int, name: str, respacing: str, device) -> Schedule:
    """The cosine schedule of improved DDPM, respaced to 'ddimN' (every
    k-th step), tables in float64 then float32."""
    if name != "cosine" or not respacing.startswith("ddim"):
        raise ValueError(f"schedule {name!r} {respacing!r}: the reference has the cosine "
                         "one, respaced for DDIM")

    def abar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    T = num_timesteps
    betas = np.array([min(1 - abar((i + 1) / T) / abar(i / T), 0.999) for i in range(T)])
    n = int(respacing[len("ddim"):])
    stride = next(i for i in range(1, T) if len(range(0, T, i)) == n)
    keep = list(range(0, T, stride))
    ac = np.cumprod(1.0 - betas)
    last, nb = 1.0, []
    for i in keep:
        nb.append(1 - ac[i] / last)
        last = ac[i]
    ac = np.cumprod(1.0 - np.array(nb))
    ac_prev = np.append(1.0, ac[:-1])

    def t32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return Schedule(alphas_cumprod_prev=t32(ac_prev), recip=t32(np.sqrt(1.0 / ac)),
                    recipm1=t32(np.sqrt(1.0 / ac - 1)),
                    timestep_map=torch.tensor(keep, dtype=torch.int64, device=device))


# ------------------------------------------------------------- layers
def sinusoid(d: int, positions: Tensor) -> Tensor:
    """The transformer's sin/cos position table, rows `positions`."""
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float64) * (-math.log(10000.0) / d))
    ang = positions.double()[:, None].cpu() * div[None]
    out = torch.zeros(positions.shape[0], d, dtype=torch.float64)
    out[:, 0::2], out[:, 1::2] = torch.sin(ang), torch.cos(ang)
    return out.float().to(positions.device)


def adjacency(device) -> Tensor:
    """The joint graph, row-normalised, unit self-loops."""
    a = torch.zeros(24, 24, dtype=torch.float64)
    for i, j in SMPL_EDGES:
        a[i, j] = a[j, i] = 1.0
    a = a / a.sum(1, keepdim=True)
    a = a * (1 - torch.eye(24, dtype=torch.float64)) + torch.eye(24, dtype=torch.float64)
    return a.float().to(device)


def gconv(W, name, adj, x, p: Prec) -> Tensor:
    """Modulated graph convolution: self and neighbour weights, a learned
    per-node modulation M and a learned symmetric adjacency offset."""
    h0 = p(x) @ p(W[name + ".W"][0])
    h1 = p(x) @ p(W[name + ".W"][1])
    a = adj + W[name + ".adj2"]
    a = (a.T + a) / 2
    eye = torch.eye(24, device=x.device)
    M = W[name + ".M"]
    return (p(a * eye) @ p(M * h0) + p(a * (1 - eye)) @ p(M * h1)) + W[name + ".bias"]


def bn_last(W, name, x) -> Tensor:
    """BatchNorm1d on [B, J, C], running statistics per channel."""
    B, J, C = x.shape
    return batchnorm(W, name, x.reshape(B * J, C)).reshape(B, J, C)


def gcn(W, adj, x, p: Prec = F32, layers: int = 4) -> Tensor:
    pre = "diffusion_model"
    out = F.relu(bn_last(W, f"{pre}.gconv_input.0.bn",
                         gconv(W, f"{pre}.gconv_input.0.gconv", adj, x, p)))
    for i in range(layers):
        blk = f"{pre}.gconv_layers.{i}"
        h = F.relu(bn_last(W, blk + ".gconv1.bn", gconv(W, blk + ".gconv1.gconv", adj, out, p)))
        h = F.relu(bn_last(W, blk + ".gconv2.bn", gconv(W, blk + ".gconv2.gconv", adj, h, p)))
        out = out + h
    return gconv(W, f"{pre}.gconv_output", adj, out, p)


# ------------------------------------------------------------ condition
class Cond(NamedTuple):
    cond: Tensor        # [N, 24, Dc]
    uncond: Tensor      # [N, 24, Dc]
    vis: Tensor         # [N, 24] bool
    betas: Tensor       # [N, 10]
    transl: Tensor      # [N, 3]
    focal: Tensor       # [N, 2]
    center: Tensor      # [N, 2]

    def tile(self, s: int) -> "Cond":
        return Cond(*(x.repeat_interleave(s, dim=0) for x in self))


def condition(W, m: Dict, batch: Dict[str, Tensor], p: Prec = F32) -> Cond:
    img = resnet50(W, batch["img"], p)
    vis_op = batch["orig_keypoints_2d"][:, :, -1] > 0
    vis_op[:, 8] = True
    vis = vis_op[:, OPENPOSE_TO_SMPL]
    fx = batch["fx"] * m["fx_norm_coeff"]
    cam = torch.stack([batch["cam_cx"] / fx, batch["cam_cy"] / fx,
                       batch["box_center"][:, 0] / fx, batch["box_center"][:, 1] / fx,
                       batch["box_size"] / fx, batch["fx"]], dim=-1)
    transl = batch["smpl_params"]["transl"]
    # the scene in the body's frame (minus the translation)
    scene_f = pointnet(W, "scene_enc", batch["scene_pcd_verts_full"] - transl[:, None], p)
    tf = linear(W, "transl_enc.layers.2", F.relu(linear(W, "transl_enc.layers.0", transl, p)),
                p)
    shared = torch.cat([scene_f, tf, cam], dim=-1)
    B = img.shape[0]
    shared24 = shared[:, None].expand(B, 24, shared.shape[-1])
    img24 = img[:, None].expand(B, 24, img.shape[-1])
    cond = torch.cat([img24 * vis[..., None].float(), shared24], dim=-1)
    uncond = torch.cat([torch.zeros_like(img24), shared24], dim=-1)
    h = F.relu(linear(W, "beta_layer.layers.0", torch.cat([img, shared], dim=-1), p))
    betas = linear(W, "beta_layer.layers.2", h, p) + W["beta_layer.init_betas"]
    focal = fx[:, None].repeat(1, 2)
    center = torch.stack([batch["cam_cx"], batch["cam_cy"]], dim=-1)
    return Cond(cond, uncond, vis, betas, transl, focal, center)


def denoise(W, m, adj, c: Cond, x: Tensor, t_orig: Tensor, p: Prec = F32) -> Tensor:
    """x0 from (x_t [N, 144], t [N]): the conditional and the
    unconditional call, each joint taking the conditional output where it
    is visible."""
    N = x.shape[0]
    d = m["timestep_embed_dim"]
    temb = linear(W, "embed_timestep.time_embed.2",
                  F.silu(linear(W, "embed_timestep.time_embed.0", pe_rows(W, d, t_orig), p)), p)
    xf = linear(W, "input_process.poseEmbedding", x.reshape(N, 24, 6), p)
    tail = torch.cat([xf, temb[:, None].expand(N, 24, d)], dim=-1)
    oc = gcn(W, adj, torch.cat([c.cond, tail], -1), p, m["gcn_layers"])
    ou = gcn(W, adj, torch.cat([c.uncond, tail], -1), p, m["gcn_layers"])
    return torch.where(c.vis[..., None], oc, ou).reshape(N, 144)


def pe_rows(W, d: int, t: Tensor) -> Tensor:
    """Rows t of the timestep table: the trained one where the weights hold
    it, else the sin/cos formula."""
    if "embed_timestep.pe" in W:
        return W["embed_timestep.pe"][t]
    return sinusoid(d, t)


# ------------------------------------------------------------------ SMPL
def outputs(m: Dict, S, c: Cond, x0: Tensor, stats, q: Prec = F32) -> Dict[str, Tensor]:
    """The served outputs of denoised bodies x0 [N, 144]."""
    return posed(m, S, c, x0 * stats[1] + stats[0], c.betas, q)


def posed(m: Dict, S, c: Cond, pose6d: Tensor, betas: Tensor,
          q: Prec = F32) -> Dict[str, Tensor]:
    """The bodies of poses [N, 144] and betas [N, 10]: SMPL's keypoints,
    in the camera frame and reprojected into the full image."""
    N = pose6d.shape[0]
    body = smpl(S, betas, rot6d_to_rotmat(pose6d).reshape(N, 24, 3, 3), q)
    kp3d = body.joints
    cam = kp3d + c.transl[:, None]
    px = cam[..., :2] / cam[..., 2:3] * c.focal[:, None] + c.center[:, None]
    kp2d = torch.stack([px[..., 0] / m["full_img_w"] - 0.5,
                        px[..., 1] / m["full_img_h"] - 0.5], dim=-1)
    return {"pred_pose_6d": pose6d, "pred_betas": betas, "pred_keypoints_3d": kp3d,
            "pred_keypoints_3d_full": cam, "pred_keypoints_2d_full": kp2d,
            "pred_vertices": body.vertices}


def camera(m: Dict, batch: Dict[str, Tensor], num_samples: int) -> Cond:
    """The translation and camera of each body of a request (the rest of
    the condition left empty), for `posed`."""
    fx = batch["fx"] * m["fx_norm_coeff"]
    none = fx.new_zeros(0)
    c = Cond(none, none, none, none, batch["smpl_params"]["transl"], fx[:, None].repeat(1, 2),
             torch.stack([batch["cam_cx"], batch["cam_cy"]], -1))
    return Cond(*(x.repeat_interleave(num_samples, 0) if x.numel() else x for x in c))


# --------------------------------------------------------------- sampling
def sample(W, m, S, stats, sched: Schedule, batch, seed: int, num_samples: int, *,
           p: Prec = F32, q: Prec = F32) -> Dict[str, Tensor]:
    """One served request, DDIM from x_T drawn first from the request's
    generator on the card: `num_samples` bodies per image -> outputs
    [B * num_samples, ...] (image-major)."""
    dev = batch["img"].device
    c = condition(W, m, batch, p).tile(num_samples)
    N = c.cond.shape[0]
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    x = torch.randn((N, 144), generator=gen, device=dev)
    adj = adjacency(dev)
    for i in range(sched.steps - 1, -1, -1):
        t = torch.full((N,), i, dtype=torch.int64, device=dev)
        x0 = denoise(W, m, adj, c, x, sched.timestep_map[t], p)
        eps = (sched.recip[i] * x - x0) / sched.recipm1[i]
        x = x0 * torch.sqrt(sched.alphas_cumprod_prev[i]) \
            + torch.sqrt(1 - sched.alphas_cumprod_prev[i]) * eps
    return outputs(m, S, c, x, stats, q)
