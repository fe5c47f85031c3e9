"""Learned part-wise body occupancy, the COAP family (port of
egohmr_tpu/collision/neural_occupancy.py).

The body is cut into 24 parts, one per skeleton joint. Each scene point is
taken into every part's posed bone frame; a per-part latent comes from the
bone transform, the betas and (optionally) a learned part code; an MLP
decodes one scalar per (point, part); the parts compose with a max (inside
any part is inside the body). The weights are distilled from the exact mesh
SDF (`distill_occupancy`, CLI `python -m
egohmr_tpu_torch.train.distill_occupancy`) or converted from a COAP release
(`interop.coap_convert`). `neural_sdf.py` shares the forward and swaps the
head.

`PartFieldNet` holds the weights of either layout:
  * shared: one encoder (`encoder.l0`, `encoder.l1`) and one decoder
    (`decoder.i`) for every part, told apart by `part_embed`; these are
    `nn.Linear`s, so their weights are the transpose of the JAX package's
    [in, out] `w` (`interop.collision_net_state_dict_from_jax` transposes);
  * `per_part_networks`: a separate MLP per part, held as [K, in, out]
    stacks, the JAX layout as it is, which `torch.baddbmm` takes for the
    part-batched product.
The first decoder layer is split: `local @ W[:3] + (latent @ W[3:] + b)`,
the latent half once per (body, part) rather than once per point, so no
[B, 24, P, 3 + latent] input is built. The arithmetic is the JAX package's
up to f32 summation order.

Everything runs in float32; on the card the matmuls run without TF32 (the
PyTorch default for cuBLAS), as the JAX package's "highest" precision does.
Nothing here is a hand-written kernel: the JAX package computes these nets
as plain einsums, outside any Pallas kernel.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..geometry import rot6d_to_rotmat
from ..interop import collision_net_from_jax
from ..interop.coap_convert import convert_coap
from ..models.egohmr import _guide_joint_scale
from ..smpl import constants as C
from ..smpl.model import SMPLModel, SMPLOutput, lbs, lbs_transforms, vertex_normals
from ..utils.checkpoint import load_npz_tree
from .sdf import (
    gather_rows,
    nearest_vertex,
    signed_distance,
    signed_distance_winding,
    topk_scene_points,
)

# one part per skeleton joint, points canonicalised by that joint's global
# transform: COAP's 24-part SMPL setting
NUM_PARTS = 24
# rows (body x part x point) of one chunk of `field_in_chunks`: about
# 1.5 GiB per 192-wide f32 activation
QUERY_ROWS = 1 << 21


@dataclass(frozen=True)
class OccupancyConfig:
    latent_dim: int = 64
    hidden_dim: int = 128
    num_layers: int = 4
    # learned per-part identity code fed to the latent encoder (0: none,
    # the layout of the oldest artifact)
    part_embed_dim: int = 0
    # soft scale of the sdf -> occupancy label in distillation
    label_sharpness: float = 50.0
    # a separate encoder and decoder per part (COAP's release layout), held
    # as [K, in, out] stacks; filled by interop.coap_convert.convert_coap
    per_part_networks: bool = False
    # activation of the per-part nets (COAP uses LeakyReLU); the shared
    # layout always uses ReLU, as in the JAX package
    activation: str = "relu"
    leaky_slope: float = 0.01


def _activation(cfg) -> Callable[[torch.Tensor], torch.Tensor]:
    """The per-part nets' activation (cfg: OccupancyConfig or
    neural_sdf.SDFNetConfig)."""
    if cfg.activation == "relu":
        return F.relu
    if cfg.activation == "leaky_relu":
        return lambda x: F.leaky_relu(x, cfg.leaky_slope)
    if cfg.activation == "softplus":
        return F.softplus
    raise ValueError(f"unknown collision-net activation: {cfg.activation}")


class PartLinear(nn.Module):
    """K linears, one per part: weight [K, in, out] (the JAX layout, not
    transposed), bias [K, out]."""

    def __init__(self, parts: int, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(parts, d_in, d_out))
        self.bias = nn.Parameter(torch.empty(parts, d_out))


class PartFieldNet(nn.Module):
    """The weights of a learned collision net, either layout (see the module
    docstring). `enc_dims`/`dec_dims` are the layer widths, input first; by
    default those `cfg` implies. With `generator`, the weights are drawn as
    the JAX package's `linear_init` draws them (U(+-1/sqrt(in)) for weights
    and biases, `part_embed` 0.1 N(0, 1)); without, they are left empty for
    a `load_state_dict`."""

    def __init__(self, cfg, *, enc_dims: Optional[Sequence[int]] = None,
                 dec_dims: Optional[Sequence[int]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        enc_dims = tuple(enc_dims or (22 + cfg.part_embed_dim, cfg.latent_dim, cfg.latent_dim))
        dec_dims = tuple(dec_dims or (3 + cfg.latent_dim,
                                      *[cfg.hidden_dim] * (cfg.num_layers - 1), 1))
        pairs = lambda d: list(zip(d[:-1], d[1:]))  # noqa: E731
        if cfg.per_part_networks:
            self.part_encoder = nn.ModuleList(
                PartLinear(NUM_PARTS, a, b) for a, b in pairs(enc_dims))
            self.part_decoder = nn.ModuleList(
                PartLinear(NUM_PARTS, a, b) for a, b in pairs(dec_dims))
        else:
            if len(enc_dims) != 3:
                raise ValueError(f"the shared layout has two encoder layers, got {enc_dims}")
            self.encoder = nn.ModuleDict({"l0": nn.Linear(*enc_dims[:2]),
                                          "l1": nn.Linear(*enc_dims[1:])})
            self.decoder = nn.ModuleList(nn.Linear(a, b) for a, b in pairs(dec_dims))
            if cfg.part_embed_dim:
                self.part_embed = nn.Parameter(torch.empty(NUM_PARTS, cfg.part_embed_dim))
        if generator is not None:
            with torch.no_grad():
                for m in self.modules():
                    if isinstance(m, (nn.Linear, PartLinear)):
                        fan_in = m.weight.shape[-2 if isinstance(m, PartLinear) else -1]
                        bound = 1.0 / math.sqrt(fan_in)
                        for t in (m.weight, m.bias):
                            t.uniform_(-bound, bound, generator=generator)
                if not cfg.per_part_networks and cfg.part_embed_dim:
                    self.part_embed.normal_(generator=generator).mul_(0.1)


def _part_transforms(smpl_out: SMPLOutput):
    """Per-part global rigid transforms of the posed skeleton: part k's
    frame is (R_k global, j_k). Returns (rot [B, 24, 3, 3], trans
    [B, 24, 3])."""
    pose = smpl_out.full_pose
    rots = [pose[:, 0]]
    for k in range(1, 24):
        rots.append(torch.matmul(rots[C.PARENTS[k]], pose[:, k]))
    return torch.stack(rots, dim=1), smpl_out.joints_smpl[:, :24]


class PartCodes(NamedTuple):
    """What the decoder needs of a posed body, once per body: the part
    frames and the latent's share of the first decoder layer."""

    rot: torch.Tensor    # [B, 24, 3, 3]
    trans: torch.Tensor  # [B, 24, 3]
    dec0: torch.Tensor   # [B, 24, hidden]: latent @ W0[3:] + b0


def encode_parts(net: PartFieldNet, smpl_out: SMPLOutput, betas: torch.Tensor) -> PartCodes:
    """The per-(body, part) half of the forward: part frames, the latent
    from the flattened bone transform, betas and part code, and its product
    with the first decoder layer."""
    cfg = net.cfg
    rot, trans = _part_transforms(smpl_out)
    B = rot.shape[0]
    feats = [rot.reshape(B, 24, 9), trans, betas[:, None, :].expand(B, 24, betas.shape[-1])]
    if cfg.per_part_networks:
        act = _activation(cfg)
        h = torch.cat(feats, dim=-1).transpose(0, 1)  # [K, B, Din]
        for i, lp in enumerate(net.part_encoder):
            h = torch.baddbmm(lp.bias[:, None, :], h, lp.weight)
            if i < len(net.part_encoder) - 1:
                h = act(h)
        w0 = net.part_decoder[0]
        dec0 = torch.baddbmm(w0.bias[:, None, :], h, w0.weight[:, 3:]).transpose(0, 1)
        return PartCodes(rot, trans, dec0)
    if cfg.part_embed_dim:
        feats.append(net.part_embed[None].expand(B, 24, cfg.part_embed_dim))
    h = F.relu(net.encoder["l0"](torch.cat(feats, dim=-1)))
    latent = net.encoder["l1"](h)
    w0 = net.decoder[0]
    return PartCodes(rot, trans, F.linear(latent, w0.weight[:, 3:], w0.bias))


def decode_parts(net: PartFieldNet, codes: PartCodes, points: torch.Tensor) -> torch.Tensor:
    """The per-point half: points [B, P, 3] -> raw part field [B, 24, P]."""
    B, P, _ = points.shape
    # canonicalise: x_local = R_k^T (x - j_k), as rows: (x - j_k) @ R_k
    rel = points[:, None, :, :] - codes.trans[:, :, None, :]
    local = torch.matmul(rel, codes.rot)  # [B, 24, P, 3]
    if net.cfg.per_part_networks:
        act = _activation(net.cfg)
        dec = net.part_decoder
        x = local.transpose(0, 1).reshape(NUM_PARTS, B * P, 3)
        x = torch.bmm(x, dec[0].weight[:, :3]).reshape(NUM_PARTS, B, P, -1)
        x = (x + codes.dec0.transpose(0, 1)[:, :, None, :]).reshape(NUM_PARTS, B * P, -1)
        for lp in dec[1:]:
            x = torch.baddbmm(lp.bias[:, None, :], act(x), lp.weight)
        return x.reshape(NUM_PARTS, B, P).transpose(0, 1)
    dec = net.decoder
    x = F.linear(local, dec[0].weight[:, :3]) + codes.dec0[:, :, None, :]
    for lp in dec[1:]:
        x = lp(F.relu(x))
    return x[..., 0]


def part_field_raw(net: PartFieldNet, smpl_out: SMPLOutput, betas: torch.Tensor,
                   points: torch.Tensor) -> torch.Tensor:
    """Raw per-part field of scene points: [B, P, 3] -> [B, 24, P], the
    forward shared by the occupancy and the signed-distance backends (only
    the head differs)."""
    return decode_parts(net, encode_parts(net, smpl_out, betas), points)


@torch.no_grad()
def field_in_chunks(net: PartFieldNet, smpl_out: SMPLOutput, betas: torch.Tensor,
                    points: torch.Tensor, head: Callable[[torch.Tensor], torch.Tensor]
                    ) -> torch.Tensor:
    """head(part_field_raw(...)) [B, P] without autograd, over the points in
    chunks of QUERY_ROWS (body, part, point) rows, so that the hidden
    activations of an evaluation-sized query (40 bodies x 24 parts x 20,000
    points) are never whole in memory. The field is per point, so chunking
    changes nothing but cuBLAS's blocking."""
    codes = encode_parts(net, smpl_out, betas)
    n = chunk_points(points.shape[0], points.shape[1])
    return torch.cat([head(decode_parts(net, codes, p)) for p in points.split(n, dim=1)], dim=1)


def occupancy_from_raw(raw: torch.Tensor) -> torch.Tensor:
    """Compose parts: inside any part is inside the body (max, then sigmoid)."""
    return torch.sigmoid(torch.amax(raw, dim=1))


def occupancy_query(net: PartFieldNet, smpl_out: SMPLOutput, betas: torch.Tensor,
                    points: torch.Tensor) -> torch.Tensor:
    """Occupancy in [0, 1] of scene points, [B, P, 3] -> [B, P]; > 0.5 is
    inside the body."""
    return occupancy_from_raw(part_field_raw(net, smpl_out, betas, points))


def masked_mean_loss(pen: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of a per-point penalty over the valid points; [B, P] -> [B]."""
    if mask is not None:
        return torch.sum(pen * mask, dim=-1) / torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    return torch.mean(pen, dim=-1)


def occupancy_collision_loss(occ: torch.Tensor,
                             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Penalise scene points predicted inside the body; [B, P] -> [B]."""
    return masked_mean_loss(torch.square(torch.clamp(occ - 0.5, min=0.0)), mask)


def chunk_points(bodies: int, points: int) -> int:
    """Scene points per chunk of a field query over `bodies` bodies: at most
    QUERY_ROWS (body, part, point) rows, at least one point."""
    return max(1, min(points, QUERY_ROWS // (bodies * NUM_PARTS)))


def make_learned_guidance_fn(net: PartFieldNet, penalty, model: SMPLModel, cond, stats, *,
                             max_scene_points: Optional[int] = 4096,
                             global_rows: Optional[int] = None):
    """The guidance of the learned backends: fn(x_t [B, 144], t) -> grad
    [B, 144] of minus the batch mean of each body's collision loss w.r.t.
    x_t, through rot6d, the skeleton and the learned field `net`, with
    `make_guidance_fn`'s per-joint 1x/2x scale. A body's loss is the mean
    over its scene points of `penalty(raw)` ([B, 24, p] part field -> [B,
    p] per-point penalty). The field reads only the posed skeleton, so the
    body is posed by `lbs_transforms` alone (no vertex is skinned).

    `max_scene_points`: the scene's top-K points nearest the canonical
    origin (`topk_scene_points`; None: every point). The field's forward
    and its backward run over the points in chunks of at most QUERY_ROWS
    (body, part, point) rows (`chunk_points`), so that a whole 20,000-point
    scene's activations are never whole in memory: each chunk's gradient
    w.r.t. the part codes (frames and the latent's share of the first
    decoder layer) is summed, then taken back to x_t once. That is the
    unchunked gradient up to f32 summation order.

    The gradient is taken w.r.t. x_t only, under `torch.enable_grad()`, so
    the function works inside a `torch.no_grad()` caller; it reads nothing
    back to the host and allocates by shape alone, so it runs inside a CUDA
    graph's capture. `global_rows`: the bodies the mean runs over, as in
    `make_guidance_fn` (a data-parallel shard passes the whole batch's)."""
    scale = _guide_joint_scale(cond.scene_pcd.device)
    betas = cond.pred_betas.detach()
    scene = topk_scene_points(cond.scene_pcd.detach(), max_scene_points)
    chunks = scene.split(chunk_points(scene.shape[0], scene.shape[1]), dim=1)

    def fn(x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        weight = -1.0 / ((global_rows or x_t.shape[0]) * scene.shape[1])
        with torch.enable_grad():
            x = x_t.detach().requires_grad_(True)
            rotmat = rot6d_to_rotmat(x * stats.std + stats.mean,
                                     "diffusion").reshape(-1, 24, 3, 3)
            _, _, joints, _ = lbs_transforms(model, betas, rotmat)
            out = SMPLOutput(vertices=None, joints=None, full_pose=rotmat, joints_smpl=joints)
            codes = encode_parts(net, out, betas)
            leaves = PartCodes(*(c.detach().requires_grad_(True) for c in codes))
            total = None
            for pts in chunks:
                loss = torch.sum(penalty(decode_parts(net, leaves, pts))) * weight
                grads = torch.autograd.grad(loss, leaves)
                total = grads if total is None else [a + g for a, g in zip(total, grads)]
            (grad,) = torch.autograd.grad(codes, x, grad_outputs=total)
        return (grad.reshape(-1, 24, 6) * scale).reshape(x_t.shape[0], 144)

    return fn


def occupancy_penalty(raw: torch.Tensor) -> torch.Tensor:
    """The occupancy backend's per-point penalty of a raw part field [B, 24,
    p]: the squared occupancy above 0.5 (`occupancy_collision_loss`'s)."""
    return torch.square(torch.clamp(occupancy_from_raw(raw) - 0.5, min=0.0))


def make_occupancy_guidance_fn(net: PartFieldNet, model: SMPLModel, cond, stats, *,
                               max_scene_points: Optional[int] = 4096,
                               global_rows: Optional[int] = None):
    """Collision guidance through the learned occupancy in place of the mesh
    SDF (`--collision_backend occupancy`)."""
    return make_learned_guidance_fn(net, occupancy_penalty, model, cond, stats,
                                    max_scene_points=max_scene_points,
                                    global_rows=global_rows)


class LabeledBatch(NamedTuple):
    betas: torch.Tensor      # [B, 10]
    smpl_out: SMPLOutput
    points: torch.Tensor     # [B, P, 3]
    sdf: torch.Tensor        # [B, P], < 0 inside


@torch.no_grad()
def sample_labeled_batch(generator: torch.Generator, model: SMPLModel, *, batch_bodies: int,
                         points_per_body: int, label_mode: str = "signed",
                         proximity_tau: float = 0.08, sign_k: int = 4) -> LabeledBatch:
    """Random posed bodies, query points and exact mesh-SDF labels, drawn
    from `generator` on its device (the model's). Half the points are
    uniform in the body's bbox grown by 0.2 m, half are vertices jittered by
    0.05 m. `label_mode`: 'signed' (nearest-vertex distance, sign from a
    k-NN normal vote), 'winding' (the generalised winding number, exact on a
    watertight mesh) or 'proximity' (unsigned distance - tau). On the card
    every mode's distance is kernel K2's nearest vertex."""
    g, dev = generator, generator.device
    B, P = batch_bodies, points_per_body
    betas = torch.randn(B, 10, generator=g, device=dev) * 0.5
    aa = torch.randn(B, 24, 3, generator=g, device=dev) * 0.2
    out = lbs(model, betas, aa[:, 0], aa[:, 1:].reshape(B, 69), pose2rot=True)
    half = P // 2
    lo = torch.amin(out.vertices, dim=1, keepdim=True) - 0.2
    hi = torch.amax(out.vertices, dim=1, keepdim=True) + 0.2
    u = torch.rand(B, half, 3, generator=g, device=dev)
    vid = torch.randint(0, model.num_vertices, (B, P - half), generator=g, device=dev)
    surf = gather_rows(out.vertices, vid)
    pts_near = surf + 0.05 * torch.randn(surf.shape, generator=g, device=dev)
    pts = torch.cat([lo + u * (hi - lo), pts_near], dim=1)
    if label_mode == "signed":
        normals = vertex_normals(out.vertices, model.faces)
        sdf = signed_distance(pts, out.vertices, normals, block_size=512, sign_k=sign_k)
    elif label_mode == "winding":
        sdf = signed_distance_winding(pts, out.vertices, model.faces, block_size=512,
                                      face_block_size=1024)
    elif label_mode == "proximity":
        sdf = nearest_vertex(pts, out.vertices, block_size=512).dist - proximity_tau
    else:
        raise ValueError(f"unknown label_mode: {label_mode}")
    return LabeledBatch(betas, out, pts, sdf)


@torch.no_grad()
def occupancy_agreement(net: PartFieldNet, model: SMPLModel, generator: torch.Generator, *,
                        n_bodies: int = 16, points_per_body: int = 1024,
                        label_mode: str = "signed", proximity_tau: float = 0.08,
                        sign_k: int = 4) -> float:
    """Held-out inside/outside agreement of the learned occupancy with the
    exact mesh SDF on freshly drawn poses: the distilled artifact's bar."""
    b = sample_labeled_batch(generator, model, batch_bodies=n_bodies,
                             points_per_body=points_per_body, label_mode=label_mode,
                             proximity_tau=proximity_tau, sign_k=sign_k)
    occ = occupancy_query(net, b.smpl_out, b.betas, b.points)
    return float(((occ > 0.5) == (b.sdf < 0.0)).float().mean())


def occupancy_distill_loss(net: PartFieldNet, batch: LabeledBatch) -> torch.Tensor:
    """L2 between the occupancy and the soft label sigmoid(-sharpness sdf)."""
    label = torch.sigmoid(-net.cfg.label_sharpness * batch.sdf)  # inside -> 1
    occ = occupancy_query(net, batch.smpl_out, batch.betas, batch.points)
    return torch.mean(torch.square(occ - label))


def make_distill_optimizer(net: PartFieldNet, lr: float, steps: int):
    """Adam (optax.adam's b1, b2, eps) under the cosine decay of
    `optax.cosine_decay_schedule(lr, steps)`: lr at the first update, 0 at
    `steps`."""
    opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    steps = max(steps, 1)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda i: 0.5 * (1.0 + math.cos(math.pi * min(i, steps) / steps)))
    return opt, sched


def distill_step(net: PartFieldNet, opt, sched, loss_fn, batch: LabeledBatch) -> torch.Tensor:
    """One Adam step on `loss_fn(net, batch)`; returns the loss (before the
    step)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(net, batch)
    loss.backward()
    opt.step()
    sched.step()
    return loss.detach()


def distill(net: PartFieldNet, model: SMPLModel, generator: torch.Generator, loss_fn, *,
            steps: int, lr: float, draw_kw: dict, log_every: int = 0, tag: str = "distill",
            losses: Optional[list] = None) -> PartFieldNet:
    """The distillation loop shared by both backends: each step draws a
    fresh labelled batch from `generator` and takes one Adam step. Each
    step's loss is appended to `losses` when given (read on the host only
    there and where it is logged)."""
    opt, sched = make_distill_optimizer(net, lr, steps)
    for i in range(steps):
        loss = distill_step(net, opt, sched, loss_fn,
                            sample_labeled_batch(generator, model, **draw_kw))
        if losses is not None:
            losses.append(loss)
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"[{tag}] step {i} loss {float(loss):.6f}")
    return net


def distill_occupancy(generator: torch.Generator, model: SMPLModel,
                      cfg: OccupancyConfig = OccupancyConfig(), *, steps: int = 300,
                      batch_bodies: int = 4, points_per_body: int = 512, lr: float = 1e-3,
                      label_mode: str = "signed", proximity_tau: float = 0.08, sign_k: int = 4,
                      log_every: int = 0, losses: Optional[list] = None) -> PartFieldNet:
    """Train the occupancy net against the exact mesh SDF on random poses.
    The weights are drawn on the CPU from `generator`'s seed, the batches
    from `generator` on its device."""
    init = torch.Generator().manual_seed(generator.initial_seed())
    net = PartFieldNet(cfg, generator=init).to(generator.device)
    return distill(net, model, generator, occupancy_distill_loss, steps=steps, lr=lr,
                   draw_kw=dict(batch_bodies=batch_bodies, points_per_body=points_per_body,
                                label_mode=label_mode, proximity_tau=proximity_tau,
                                sign_k=sign_k),
                   log_every=log_every, tag="distill", losses=losses)


def load_torch_state_dict(path: str) -> dict:
    """A torch release checkpoint as a flat {name: NumPy array} dict (a
    Lightning `state_dict` wrapper unwrapped; tensors only, copied)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.detach().cpu().numpy().copy() for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


def _load_collision_net(path: str, cfg_cls, meta_key: str, convert_release,
                        device=None) -> PartFieldNet:
    """The loader shared by the learned backends.

    * `.npz` (+ `.json` sidecar): an artifact in the JAX package's layout
      (either package's distillation CLI writes one). The shared layout
      loads into a net built from the sidecar's config (`strict`, so a
      missing or extra key fails); a `per_part_networks` config takes its
      layer widths from the arrays.
    * `.pt` / `.pth` / `.ckpt`: a torch release, mapped through
      `convert_release` (interop.coap_convert / volsmpl_convert).
    The net comes back in eval mode with `requires_grad` off: guidance
    differentiates w.r.t. x_t only."""
    if path.endswith((".pt", ".pth", ".ckpt")):
        params, cfg = convert_release(load_torch_state_dict(path))
    else:
        cfg = cfg_cls()
        if os.path.exists(path + ".json"):
            with open(path + ".json") as f:
                cfg = cfg_cls(**json.load(f).get(meta_key, {}))
        params = load_npz_tree(path)
    net = collision_net_from_jax(params, cfg)
    return net.to(device).eval().requires_grad_(False)


def load_occupancy(path: str, device=None) -> PartFieldNet:
    """Occupancy-backend weights: a distilled `.npz` artifact, or a COAP
    release `.pt`/`.pth`/`.ckpt` converted by `interop.coap_convert`. The
    config is `net.cfg`."""
    return _load_collision_net(path, OccupancyConfig, "occupancy_config", convert_coap, device)

