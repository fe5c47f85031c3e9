"""Human-scene collision: batched signed distance to the SMPL surface
(port of egohmr_tpu/collision/sdf.py).

Everything is batched with static shapes: the body-bbox crop is a weight
mask, and the sign of the distance comes from the nearest vertex's normal
(occupancy > 0.5 of a learned model corresponds to sdf < 0 here).

Top-k with ties: `jax.lax.top_k` breaks ties by the lowest index, and ties
are the normal case here (every in-bbox point ranks at distance 0).
`torch.topk` promises no order among equals, so every "k smallest" in this
module is a stable ascending sort cut to its first k entries.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .knn import nearest_vertex_idx


class NearestResult(NamedTuple):
    dist: torch.Tensor  # [B, P] euclidean distance to the nearest vertex
    idx: torch.Tensor   # [B, P] int64 index of the nearest vertex


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, C], idx [B, K] -> x[b, idx[b, k]] as [B, K, C]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _k_smallest(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries along the last axis, ascending, ties to the
    lowest index (what `jax.lax.top_k(-d2, k)` selects)."""
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_scene_points(scene: torch.Tensor, k: Optional[int]) -> torch.Tensor:
    """Static top-K pre-filter: the K scene points nearest the canonical
    origin (where the body sits). scene [B, P, 3] -> [B, min(K, P), 3];
    None or an oversize K is a no-op.

    Approximate on dense body-centred crops, where points near the origin
    can outnumber K while a penetrator sits farther out; use
    `topk_scene_points_near_body` when the posed vertices are at hand."""
    if k is None or scene.shape[1] <= k:
        return scene
    _, idx = _k_smallest(torch.sum(scene * scene, dim=-1), k)
    return gather_rows(scene, idx)


def topk_scene_points_near_body(scene: torch.Tensor, verts: torch.Tensor,
                                k: Optional[int], margin: float = 0.0) -> torch.Tensor:
    """The K scene points nearest the body's bounding box (distance 0
    inside it). Every bbox-masked point ranks before any outside point, so
    a computation that masks to the bbox afterwards (`bbox_mask` +
    `collision_loss`) is exact as long as the masked points number <= K.

    The ranking `margin` must be <= the downstream `bbox_mask` margin (both
    default 0): a larger one makes margin-shell points tie at distance 0
    with the scoring points, and the index-order tie-break could evict
    scoring points even when they fit in K.
    scene [B, P, 3]; verts [B, V, 3] (detached here)."""
    if k is None or scene.shape[1] <= k:
        return scene
    v = verts.detach()
    lo = v.amin(dim=1, keepdim=True) - margin  # [B, 1, 3]
    hi = v.amax(dim=1, keepdim=True) + margin
    d = scene - torch.minimum(torch.maximum(scene, lo), hi)  # 0 inside the bbox
    _, idx = _k_smallest(torch.sum(d * d, dim=-1), k)
    return gather_rows(scene, idx)


def nearest_vertex(points: torch.Tensor, verts: torch.Tensor, *,
                   block_size: int = 2048) -> NearestResult:
    """For each point, the nearest body vertex. points [B, P, 3]; verts
    [B, V, 3], any V (a body's 6890 vertices or a 20,000-point cloud).

    The index comes from `nearest_vertex_idx` (collision/knn.py): kernel K2
    for CUDA tensors, the plain version in blocks of `block_size` points
    for CPU tensors. It is computed without autograd; the distance is
    recomputed from the gathered vertex, so gradients flow through the
    gather (the exact subgradient)."""
    idx = nearest_vertex_idx(points.detach(), verts.detach(), block_size=block_size)
    dist = torch.linalg.norm(points - gather_rows(verts, idx), dim=-1)
    return NearestResult(dist=dist, idx=idx)


def nearest_k_vertices(points: torch.Tensor, verts: torch.Tensor, k: int, *,
                       block_size: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest body vertices per point (blocked). points [B, P, 3]; verts
    [B, V, 3] -> (d2 [B, P, k], idx [B, P, k]); d2 are squared distances,
    ascending."""
    v_sq = torch.sum(verts * verts, dim=-1)[:, None, :]
    v_t = verts.transpose(1, 2)
    d2s, idxs = [], []
    for blk in points.split(block_size, dim=1):
        part, idx = _k_smallest(v_sq - 2.0 * torch.matmul(blk, v_t), k)
        d2_true = part + torch.sum(blk * blk, dim=-1, keepdim=True)
        d2s.append(torch.clamp(d2_true, min=0.0))
        idxs.append(idx)
    return torch.cat(d2s, dim=1), torch.cat(idxs, dim=1)


def signed_distance(points: torch.Tensor, verts: torch.Tensor,
                    normals: torch.Tensor, *, block_size: int = 2048,
                    sign_k: int = 1) -> torch.Tensor:
    """Signed distance of points to the body surface (negative = inside).

    sign_k=1: sign(dot(p - nearest_vert, nearest_normal)). sign_k>1 (robust
    near thin parts and concave creases): a distance-weighted vote over the
    k nearest vertices, sign(sum_i w_i dot(p - v_i, n_i)) with
    w_i = 1/(d_i^2 + eps); the magnitude still comes from the true nearest
    vertex. points [B, P, 3]; verts, normals [B, V, 3] -> [B, P]."""
    nn = nearest_vertex(points, verts, block_size=block_size)
    if sign_k <= 1:
        nearest, n = gather_rows(verts, nn.idx), gather_rows(normals, nn.idx)
        sign = torch.sign(torch.sum((points - nearest) * n, dim=-1))
    else:
        d2, idx = nearest_k_vertices(points, verts, sign_k, block_size=block_size)
        B, P, _ = idx.shape
        flat = idx.reshape(B, P * sign_k)
        vk = gather_rows(verts, flat).reshape(B, P, sign_k, 3)
        nk = gather_rows(normals, flat).reshape(B, P, sign_k, 3)
        proj = torch.sum((points[:, :, None] - vk) * nk, dim=-1)  # [B, P, k]
        sign = torch.sign(torch.sum(proj / (d2 + 1e-8), dim=-1))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return nn.dist * sign


def winding_number(points: torch.Tensor, verts: torch.Tensor,
                   faces: torch.Tensor, *, block_size: int = 1024) -> torch.Tensor:
    """Generalised winding number of points w.r.t. a triangle mesh.

    points [B, P, 3]; verts [B, V, 3]; faces [F, 3] int -> [B, P]. |w| > 0.5
    means inside for a watertight mesh, whatever the normals' quality. Van
    Oosterom-Strackee solid angle per triangle, in blocks of faces."""
    tri = verts[:, faces.long()]  # [B, F, 3, 3]
    p = points[:, :, None]        # [B, P, 1, 3]
    omega = torch.zeros(points.shape[:2], dtype=points.dtype, device=points.device)
    for tb in tri.split(block_size, dim=1):
        a, b, c = (tb[:, None, :, i] - p for i in range(3))  # [B, P, block, 3]
        la, lb, lc = (torch.linalg.norm(x, dim=-1) for x in (a, b, c))
        det = torch.sum(a * torch.linalg.cross(b, c, dim=-1), dim=-1)
        denom = (la * lb * lc + torch.sum(a * b, -1) * lc
                 + torch.sum(b * c, -1) * la + torch.sum(c * a, -1) * lb)
        omega = omega + torch.sum(torch.atan2(det, denom), dim=-1)
    # the per-triangle angle is Omega/2; winding = sum(Omega) / 4 pi
    return omega / (2.0 * math.pi)


def signed_distance_winding(points: torch.Tensor, verts: torch.Tensor,
                            faces: torch.Tensor, *, block_size: int = 2048,
                            face_block_size: int = 1024) -> torch.Tensor:
    """Signed distance with the exact winding-number inside test: O(P*F),
    for evaluation, not for the per-step guidance. points [B, P, 3] ->
    [B, P]."""
    nn = nearest_vertex(points, verts, block_size=block_size)
    w = winding_number(points, verts, faces, block_size=face_block_size)
    return torch.where(torch.abs(w) > 0.5, -nn.dist, nn.dist)


def bbox_mask(points: torch.Tensor, verts: torch.Tensor,
              margin: float = 0.0) -> torch.Tensor:
    """Scene points inside the body's axis-aligned bbox. -> bool [B, P]."""
    lo = verts.amin(dim=1, keepdim=True) - margin
    hi = verts.amax(dim=1, keepdim=True) + margin
    return torch.all((points >= lo) & (points <= hi), dim=-1)


def collision_loss(sdf: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared penetration depth per sample. sdf [B, P] -> [B];
    `mask` [B, P] weights the points (the mean is over the masked ones)."""
    pen = torch.square(torch.clamp(-sdf, min=0.0))
    if mask is not None:
        denom = torch.clamp(torch.sum(mask, dim=-1), min=1.0)
        return torch.sum(pen * mask, dim=-1) / denom
    return torch.mean(pen, dim=-1)


def collision_ratio(sdf: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fraction of scene points inside the body; the denominator is the
    total number of scene points."""
    inside = (sdf < 0.0).to(torch.float32)
    if mask is not None:
        inside = inside * mask
    return torch.sum(inside, dim=-1) / sdf.shape[-1]


def chamfer_distance(x: torch.Tensor, y: torch.Tensor, *,
                     block_size: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point squared nearest-neighbour distances, both directions.
    x [B, P1, 3]; y [B, P2, 3] -> (cham_x [B, P1], cham_y [B, P2])."""
    dx = nearest_vertex(x, y, block_size=block_size).dist
    dy = nearest_vertex(y, x, block_size=block_size).dist
    return torch.square(dx), torch.square(dy)


def min_body_scene_distance(verts: torch.Tensor, scene: torch.Tensor, *,
                            block_size: int = 2048) -> torch.Tensor:
    """min over (body vertex, scene point) pairs of the distance, per
    sample (contact iff it is under 0.02 m)."""
    nn = nearest_vertex(verts, scene, block_size=block_size)
    return torch.amin(nn.dist, dim=-1)
