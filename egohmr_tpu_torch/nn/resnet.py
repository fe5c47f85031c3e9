"""Headless ResNet backbone (port of egohmr_tpu/nn/resnet.py).

NHWC at the API, as in the JAX package; inside, the NHWC tensor is viewed
as NCHW, which is exactly PyTorch's `channels_last` layout. Convolutions go
to cuDNN through `F.conv2d` (the JAX package has no kernel of its own here).
Module and key names follow torchvision (`layer1.0.conv1`, ...,
`downsample.0/1`), the reference `state_dict` layout.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import DataParallel
from .core import batchnorm

RESNET_LAYERS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
BOTTLENECK_DEPTHS = {50, 101, 152}


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, downsample: bool):
        super().__init__()
        self.conv1, self.bn1 = _conv(inplanes, planes, 3), nn.BatchNorm2d(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), nn.BatchNorm2d(planes)
        self.downsample = (nn.Sequential(_conv(inplanes, planes, 1),
                                         nn.BatchNorm2d(planes))
                           if downsample else None)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, downsample: bool):
        super().__init__()
        self.conv1, self.bn1 = _conv(inplanes, planes, 1), nn.BatchNorm2d(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), nn.BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(_conv(inplanes, planes * 4, 1),
                                         nn.BatchNorm2d(planes * 4))
                           if downsample else None)


class ResNet(nn.Module):
    def __init__(self, num_layers: int = 50):
        super().__init__()
        block = Bottleneck if num_layers in BOTTLENECK_DEPTHS else BasicBlock
        self.conv1 = _conv(3, 64, 7)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for li, (planes, n_blocks, stride) in enumerate(
                zip((64, 128, 256, 512), RESNET_LAYERS[num_layers], (1, 2, 2, 2)),
                start=1):
            blocks = []
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                ds = s != 1 or inplanes != planes * block.expansion
                blocks.append(block(inplanes, planes, ds))
                inplanes = planes * block.expansion
            setattr(self, f"layer{li}", nn.Sequential(*blocks))


def _block(blk: nn.Module, x: torch.Tensor, stride: int, train: bool,
           dp: Optional[DataParallel]) -> torch.Tensor:
    def bn(mod, y):  # statistics over (N, H, W) in training
        return batchnorm(mod, y, channel_dim=1, train=train, dp=dp)

    if isinstance(blk, Bottleneck):
        out = torch.relu(bn(blk.bn1, F.conv2d(x, blk.conv1.weight)))
        # the stride sits on the 3x3 conv, as in torchvision's Bottleneck
        out = torch.relu(bn(blk.bn2, F.conv2d(out, blk.conv2.weight, stride=stride,
                                        padding=1)))
        out = bn(blk.bn3, F.conv2d(out, blk.conv3.weight))
    else:
        out = torch.relu(bn(blk.bn1, F.conv2d(x, blk.conv1.weight, stride=stride,
                                        padding=1)))
        out = bn(blk.bn2, F.conv2d(out, blk.conv2.weight, padding=1))
    if blk.downsample is not None:
        res = bn(blk.downsample[1], F.conv2d(x, blk.downsample[0].weight, stride=stride))
    else:
        res = x
    return torch.relu(out + res)


def resnet_forward(model: ResNet, x_nhwc: torch.Tensor, *, train: bool = False,
                   dp: Optional[DataParallel] = None) -> torch.Tensor:
    """x [B, H, W, 3] NHWC -> mean-pooled stage-4 features [B, C]. `train`:
    every BatchNorm normalises by the batch's statistics and updates its
    running ones; with `dp`, by the whole data-parallel batch's."""
    x = x_nhwc.permute(0, 3, 1, 2)  # NCHW view, channels_last in memory
    out = F.conv2d(x, model.conv1.weight, stride=2, padding=3)
    out = torch.relu(batchnorm(model.bn1, out, channel_dim=1, train=train, dp=dp))
    out = F.max_pool2d(out, 3, 2, 1)  # pads with -inf, as the JAX max_pool
    for li in range(1, 5):
        for b, blk in enumerate(getattr(model, f"layer{li}")):
            stride = (2 if li > 1 else 1) if b == 0 else 1
            out = _block(blk, out, stride, train, dp)
    return out.mean(dim=(2, 3))
