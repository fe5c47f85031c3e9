"""Headless ResNet backbone (port of egohmr_tpu/nn/resnet.py).

NHWC at the API, as in the JAX package; inside, the NHWC tensor is viewed
as NCHW, which is exactly PyTorch's `channels_last` layout. Convolutions go
to cuDNN through `F.conv2d` (the JAX package has no kernel of its own here).
Module and key names follow torchvision (`layer1.0.conv1`, ...,
`downsample.0/1`), the reference `state_dict` layout.

On the card, in bf16 inference, what follows each convolution (eval
BatchNorm, ReLU and, at a block's end, the residual add through the
downsample branch's BatchNorm) is one kernel (`nn/resnet_epilogue.py`),
writing into the convolution's output; see `_fused`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import DataParallel
from . import resnet_epilogue as epilogue
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


def _block(blk: nn.Module, x: torch.Tensor, stride: int, glue) -> torch.Tensor:
    """One residual block. `glue(y, bn, residual=None)` is what follows each
    convolution's output y: its BatchNorm `bn`, then, at the block's end,
    the residual, and ReLU. `residual()` gives the identity input, or the
    downsample convolution's output and its BatchNorm."""
    def residual():
        ds = blk.downsample
        if ds is None:
            return x, None
        return F.conv2d(x, ds[0].weight, stride=stride), ds[1]

    # each activation is a temporary, freed once the next convolution has
    # read it (the plain glue frees the convolution's output after BatchNorm)
    if isinstance(blk, Bottleneck):
        return glue(F.conv2d(
            glue(F.conv2d(
                glue(F.conv2d(x, blk.conv1.weight), blk.bn1),
                # the stride sits on the 3x3 conv, as in torchvision's Bottleneck
                blk.conv2.weight, stride=stride, padding=1), blk.bn2),
            blk.conv3.weight), blk.bn3, residual)
    return glue(F.conv2d(
        glue(F.conv2d(x, blk.conv1.weight, stride=stride, padding=1), blk.bn1),
        blk.conv2.weight, padding=1), blk.bn2, residual)


def _plain_glue(train: bool, dp: Optional[DataParallel]):
    """`_block`'s glue as separate ops: BatchNorm (on the batch's statistics
    in training), the residual add, ReLU."""
    def bn(mod, y):  # statistics over (N, H, W) in training
        return batchnorm(mod, y, channel_dim=1, train=train, dp=dp)

    def glue(y, mod, residual=None):
        out = bn(mod, y)
        del y
        if residual is not None:
            res, res_bn = residual()
            out = out + (res if res_bn is None else bn(res_bn, res))
        return torch.relu(out)

    return glue


def _fused(model: ResNet, train: bool, x: torch.Tensor) -> bool:
    """Whether the forward of `model` on x takes the fused epilogue: on the
    card, where `_kernel_arithmetic_holds`."""
    return x.is_cuda and _kernel_arithmetic_holds(model, train, x)


def _kernel_arithmetic_holds(model: ResNet, train: bool, x: torch.Tensor) -> bool:
    """Whether the kernel computes what the caller asks for: bf16
    activations and convolution weights, every BatchNorm f32 on its running
    statistics (so that `batchnorm_eval` folds it to a bf16 scale and
    shift), and nothing for autograd to record. The kernel's f32 arithmetic
    with one rounding then stands in for the plain path's rounding after
    every op, as XLA's fusions do on the JAX side."""
    bf, f32 = torch.bfloat16, torch.float32
    if train or x.dtype != bf or model.conv1.weight.dtype != bf:
        return False
    if torch.is_grad_enabled() and (x.requires_grad
                                    or any(p.requires_grad for p in model.parameters())):
        return False
    return all(m.weight.dtype == m.running_var.dtype == f32
               for m in model.modules() if isinstance(m, nn.BatchNorm2d))


def _fused_glue(y: torch.Tensor, bn: nn.BatchNorm2d, residual=None) -> torch.Tensor:
    """`_block`'s glue as one kernel pass, in place into the convolution's
    output y: relu(bn(y) (+ the residual, through its BatchNorm if any))."""
    res, res_bn = (None, None) if residual is None else residual()
    c_res = None if res_bn is None else epilogue.bn_constants(res_bn)
    return epilogue.resnet_epilogue(y, epilogue.bn_constants(bn), res, c_res)


def resnet_forward(model: ResNet, x_nhwc: torch.Tensor, *, train: bool = False,
                   dp: Optional[DataParallel] = None) -> torch.Tensor:
    """x [B, H, W, 3] NHWC -> mean-pooled stage-4 features [B, C]. `train`:
    every BatchNorm normalises by the batch's statistics and updates its
    running ones; with `dp`, by the whole data-parallel batch's."""
    x = x_nhwc.permute(0, 3, 1, 2)  # NCHW view, channels_last in memory
    fused = _fused(model, train, x)
    glue = _fused_glue if fused else _plain_glue(train, dp)
    # on the kernel's path cuDNN keeps channels_last, the kernel's rows,
    # from the input on
    out = glue(F.conv2d(x.contiguous(memory_format=torch.channels_last) if fused else x,
                        model.conv1.weight, stride=2, padding=3), model.bn1)
    out = F.max_pool2d(out, 3, 2, 1)  # pads with -inf, as the JAX max_pool
    for li in range(1, 5):
        for b, blk in enumerate(getattr(model, f"layer{li}")):
            stride = (2 if li > 1 else 1) if b == 0 else 1
            out = _block(blk, out, stride, glue)
    return out.mean(dim=(2, 3))
