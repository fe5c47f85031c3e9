"""Evaluation metrics: the MPJPE family, Procrustes alignment, diversity
(port of egohmr_tpu/eval/metrics.py).

All errors are per sample, in metres; the CLI prints millimetres. Everything
is f32; on the card the 3x3 products must run without TF32
(`torch.backends.cuda.matmul.allow_tf32 = False`, the PyTorch default).
"""
from __future__ import annotations

from typing import Optional

import torch


def _fit_and_apply(F1: torch.Tensor, F2: torch.Tensor, S1: torch.Tensor) -> torch.Tensor:
    """Fit the similarity transform (scale, R, t) that takes the points F1
    [..., N, 3] onto F2, and apply it to S1. The SVD's signs may differ
    between libraries; R, scale and t do not depend on them."""
    mu1 = torch.mean(F1, dim=-2, keepdim=True)
    mu2 = torch.mean(F2, dim=-2, keepdim=True)
    X1 = F1 - mu1
    X2 = F2 - mu2
    var1 = torch.sum(torch.square(X1), dim=(-2, -1))

    Kmat = torch.einsum("...ni,...nj->...ij", X1, X2)
    U, s, Vh = torch.linalg.svd(Kmat)
    V = Vh.transpose(-1, -2)
    sign = torch.sign(torch.linalg.det(torch.einsum("...ij,...kj->...ik", V, U)))
    # R = V diag(1, 1, sign) U^T: flip the last column of V and the last
    # singular value by a multiply, with no in-place write
    ones = torch.ones_like(sign)
    flip = torch.stack([ones, ones, sign], dim=-1)             # [..., 3]
    R = torch.einsum("...ij,...kj->...ik", V * flip[..., None, :], U)
    scale = torch.sum(s * flip, dim=-1) / var1
    t = mu2 - scale[..., None, None] * torch.einsum("...ij,...nj->...ni", R, mu1)
    return scale[..., None, None] * torch.einsum("...ij,...nj->...ni", R, S1) + t


def similarity_transform(S1: torch.Tensor, S2: torch.Tensor) -> torch.Tensor:
    """Procrustes: align S1 [..., N, 3] to S2; returns the aligned S1."""
    return _fit_and_apply(S1, S2, S1)


def similarity_transform_vis_mask(vis: torch.Tensor, S1: torch.Tensor,
                                  S2: torch.Tensor) -> torch.Tensor:
    """Procrustes fitted on the visibility-weighted points (S1 * vis and
    S2 * vis enter the fit), applied to ALL points of S1. With no visible
    joint the fit divides 0 by 0 and the result is NaN, as in the JAX
    package."""
    w = vis[..., None]
    return _fit_and_apply(S1 * w, S2 * w, S1)


def _masked_mean(err: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.mean(err, dim=-1)
    denom = torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    return torch.sum(err * mask, dim=-1) / denom


def mpjpe(pred: torch.Tensor, gt: torch.Tensor, *, pelvis_align: bool = False,
          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean (or masked-mean) per-joint position error [..., N, 3] -> [...]."""
    if pelvis_align:
        pred = pred - pred[..., :1, :]
        gt = gt - gt[..., :1, :]
    return _masked_mean(torch.linalg.norm(pred - gt, dim=-1), mask)


def pa_mpjpe(pred: torch.Tensor, gt: torch.Tensor, *,
             vis_mask: Optional[torch.Tensor] = None,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Procrustes-aligned MPJPE. `vis_mask` selects the joints used for the
    fit; `mask` selects the joints averaged for the error."""
    if vis_mask is not None:
        aligned = similarity_transform_vis_mask(vis_mask, pred, gt)
    else:
        aligned = similarity_transform(pred, gt)
    return _masked_mean(torch.linalg.norm(aligned - gt, dim=-1), mask)


def v2v(pred_verts: torch.Tensor, gt_verts: torch.Tensor, pred_pelvis: torch.Tensor,
        gt_pelvis: torch.Tensor, *, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pelvis-aligned vertex-to-vertex error."""
    p = pred_verts - pred_pelvis[..., None, :]
    g = gt_verts - gt_pelvis[..., None, :]
    return _masked_mean(torch.linalg.norm(p - g, dim=-1), mask)


def joint_visibility_mask(gt_joints: torch.Tensor, focal_length: torch.Tensor,
                          camera_center: torch.Tensor, img_w: float = 1920.0,
                          img_h: float = 1080.0) -> torch.Tensor:
    """Visible = the GT joint projects inside the full image.
    gt_joints [B, N, 3] in camera coordinates -> bool [B, N]."""
    xy = gt_joints[..., :2] / gt_joints[..., 2:3]
    uv = xy * focal_length[:, None, :] + camera_center[:, None, :]
    return ((uv[..., 0] >= 0) & (uv[..., 0] < img_w)
            & (uv[..., 1] >= 0) & (uv[..., 1] < img_h))


def diversity_std(samples: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-joint unbiased std over the sample axis, averaged (NaN with one
    sample). samples [B, S, N, 3] -> [B]."""
    std = torch.std(samples, dim=1, unbiased=True)  # [B, N, 3]
    return _masked_mean(torch.mean(std, dim=-1), mask)


def apd(samples: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Average pairwise distance across samples: the sum over ordered pairs
    divided by n (n - 1) 2, i.e. HALF the mean pairwise distance (the
    reference's convention, kept). samples [B, S, N, 3] -> [B]."""
    S = samples.shape[1]
    diff = samples[:, :, None] - samples[:, None]  # [B, S, S, N, 3]
    d = torch.linalg.norm(diff, dim=-1)            # [B, S, S, N]
    if mask is not None:
        denom = torch.clamp(torch.sum(mask, dim=-1), min=1.0)
        d = torch.sum(d * mask[:, None, None, :], dim=-1) / denom[:, None, None]
    else:
        d = torch.mean(d, dim=-1)
    return torch.sum(d, dim=(1, 2)) / max(S * (S - 1) * 2, 1)
