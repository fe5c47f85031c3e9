"""The pose and shape discriminator of stage 1's GAN (port of
egohmr_tpu/models/discriminator.py).

The module tree is the reference's: 1x1 convolutions `D_conv1` and
`D_conv2` (weights [out, in, 1, 1]) over each joint's 9-d rotation matrix,
23 per-joint heads `pose_out.{i}` (`Linear(32, 1)`), the betas branch and
the all-joints branch. The forward is plain matmuls in float32.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..nn.core import linear

NUM_JOINTS = 23


class Discriminator(nn.Module):
    def __init__(self):
        super().__init__()
        self.D_conv1 = nn.Conv2d(9, 32, kernel_size=1)
        self.D_conv2 = nn.Conv2d(32, 32, kernel_size=1)
        self.pose_out = nn.ModuleList([nn.Linear(32, 1) for _ in range(NUM_JOINTS)])
        self.betas_fc1 = nn.Linear(10, 10)
        self.betas_fc2 = nn.Linear(10, 5)
        self.betas_out = nn.Linear(5, 1)
        self.D_alljoints_fc1 = nn.Linear(32 * NUM_JOINTS, 1024)
        self.D_alljoints_fc2 = nn.Linear(1024, 1024)
        self.D_alljoints_out = nn.Linear(1024, 1)


@torch.no_grad()
def init_discriminator_(disc: Discriminator, seed: int) -> Discriminator:
    """The JAX package's init distributions from `seed`: Xavier-uniform
    weights (gain 1) and zero biases."""
    g = torch.Generator().manual_seed(seed)
    for m in disc.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_out, fan_in = m.weight.shape[:2]
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            m.weight.copy_((torch.rand(m.weight.shape, generator=g) * 2 - 1) * bound)
            m.bias.zero_()
    return disc


def _conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return x @ conv.weight[:, :, 0, 0].t() + conv.bias


def discriminator_forward(disc: Discriminator, poses: torch.Tensor,
                          betas: torch.Tensor) -> torch.Tensor:
    """poses [B, 23, 3, 3] (or [B, 207]), betas [B, 10] -> logits [B, 25]:
    the 23 joints', the betas' and the all-joints one."""
    B = poses.shape[0]
    h = torch.relu(_conv1x1(disc.D_conv1, poses.reshape(B, NUM_JOINTS, 9)))
    h = torch.relu(_conv1x1(disc.D_conv2, h))  # [B, 23, 32]
    w = torch.cat([m.weight for m in disc.pose_out])           # [23, 32]
    b = torch.cat([m.bias for m in disc.pose_out])             # [23]
    poses_out = torch.einsum("bjc,jc->bj", h, w) + b

    bh = torch.relu(linear(disc.betas_fc1, betas))
    bh = torch.relu(linear(disc.betas_fc2, bh))
    betas_out = linear(disc.betas_out, bh)

    # the reference flattens its conv output [B, 32, 23, 1] channel-major
    flat = h.transpose(1, 2).reshape(B, -1)
    ah = torch.relu(linear(disc.D_alljoints_fc1, flat))
    ah = torch.relu(linear(disc.D_alljoints_fc2, ah))
    return torch.cat([poses_out, betas_out, linear(disc.D_alljoints_out, ah)], dim=1)
