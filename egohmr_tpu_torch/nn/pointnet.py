"""ResnetPointnet scene encoder, plain PyTorch (port of
egohmr_tpu/nn/pointnet.py:pointnet_forward). This is the float32 path and
the reference the fused kernel K1 is held to. `pointnet_forward_tp` is the
same network split over a data row's model axis (`parallel/tp.py`)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel.mesh import DataParallel, all_reduce_max
from ..parallel.tp import TensorParallel
from .core import linear, mm


class ResnetBlockFC(nn.Module):
    def __init__(self, size_in: int, size_out: int, size_h: int):
        super().__init__()
        self.fc_0 = nn.Linear(size_in, size_h)
        self.fc_1 = nn.Linear(size_h, size_out)
        self.shortcut = (nn.Linear(size_in, size_out, bias=False)
                         if size_in != size_out else None)


class ResnetPointnet(nn.Module):
    def __init__(self, out_dim: int = 512, hidden_dim: int = 256):
        super().__init__()
        self.fc_pos_0 = nn.Linear(3, 2 * hidden_dim)
        for i in range(4):
            setattr(self, f"block_{i}",
                    ResnetBlockFC(2 * hidden_dim, hidden_dim, hidden_dim))
        self.fc_c = nn.Linear(hidden_dim, out_dim)


def _block(p: ResnetBlockFC, x: torch.Tensor) -> torch.Tensor:
    net = linear(p.fc_0, torch.relu(x))
    dx = linear(p.fc_1, torch.relu(net))
    xs = mm(x, p.shortcut.weight) if p.shortcut is not None else x
    return xs + dx


def _block_split(p: ResnetBlockFC, x: torch.Tensor,
                 pooled: torch.Tensor) -> torch.Tensor:
    """The block on cat([x, broadcast(pooled)]) without building the concat:
    cat(a, b) @ W == a @ W[:H] + b @ W[H:] (weights are [out, in] here)."""
    h = x.shape[-1]
    w0, ws = p.fc_0.weight, p.shortcut.weight
    net = (mm(torch.relu(x), w0[:, :h]) + mm(torch.relu(pooled), w0[:, h:])) + p.fc_0.bias
    dx = linear(p.fc_1, torch.relu(net))
    xs = mm(x, ws[:, :h]) + mm(pooled, ws[:, h:])
    return xs + dx


def pointnet_forward(model: ResnetPointnet, points: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """points [B, N, 3] -> [B, out_dim]; `mask` [B, N] bool keeps padded
    points out of the max-pools."""
    def pool(net):
        if mask is not None:
            net = torch.where(mask[..., None], net, -1e30)
        return net.amax(dim=1, keepdim=True)

    net = linear(model.fc_pos_0, points)
    net = _block(model.block_0, net)
    net = _block_split(model.block_1, net, pool(net))
    net = _block_split(model.block_2, net, pool(net))
    net = _block_split(model.block_3, net, pool(net))
    net = pool(net)[:, 0]
    return linear(model.fc_c, torch.relu(net))


@torch.no_grad()
def pointnet_forward_point_sharded(model: ResnetPointnet, points: torch.Tensor,
                                   dp: DataParallel) -> torch.Tensor:
    """`pointnet_forward` with the POINT axis sharded over the ranks of
    `dp`: each rank encodes its shard [B, N / world, 3] of every cloud, and
    the four max-pools become an all-reduce(MAX), so that every rank
    returns the whole clouds' [B, out_dim]. Equal to `pointnet_forward` on
    the gathered clouds up to the matmuls' rounding: a max is exact in any
    order. Inference only, as in the JAX package (a `pmax` there)."""
    def pool(net):
        return all_reduce_max(dp, net.amax(dim=1, keepdim=True))

    net = linear(model.fc_pos_0, points)
    net = _block(model.block_0, net)
    net = _block_split(model.block_1, net, pool(net))
    net = _block_split(model.block_2, net, pool(net))
    net = _block_split(model.block_3, net, pool(net))
    net = pool(net)[:, 0]
    return linear(model.fc_c, torch.relu(net))


def _add_bias(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return y + b.to(torch.promote_types(y.dtype, b.dtype))


@torch.no_grad()
def pointnet_forward_tp(tp: TensorParallel, points: torch.Tensor) -> torch.Tensor:
    """`pointnet_forward` (without a mask) split over the devices of one data
    row (`tp`, a placed `ResnetPointnet`: `parallel.place_params` with
    `pointnet_tp_specs`). In each block every shard computes its columns of
    `fc_0` from the replicated stream and its partial `fc_1` product; the
    partial sums are added on the row's first device, shard 0 first, in the
    activation dtype, before `fc_1`'s bias and the residual. `fc_pos_0`, the
    shortcuts, the max-pools and `fc_c` run replicated on the first device.
    Equal to `pointnet_forward` up to the order of the split sums.
    Inference only."""
    def pool(net):
        return net.amax(dim=1, keepdim=True)

    def block(i, x, pooled=None):
        """`_block` (no `pooled`) or `_block_split`: cat([x, pooled]) @ W ==
        x @ W[:h] + pooled @ W[h:]."""
        name, h = f"block_{i}", x.shape[-1]
        xs = tp.scatter(torch.relu(x))
        ps = tp.scatter(torch.relu(pooled)) if pooled is not None else None
        parts = []
        for s in range(tp.size):
            fc0, fc1 = tp.layer(s, f"{name}.fc_0"), tp.layer(s, f"{name}.fc_1")
            if ps is None:
                net = mm(xs[s], fc0.weight)
            else:
                net = mm(xs[s], fc0.weight[:, :h]) + mm(ps[s], fc0.weight[:, h:])
            parts.append(mm(torch.relu(_add_bias(net, fc0.bias)), fc1.weight))
        dx = _add_bias(tp.reduce(parts), tp.layer(0, f"{name}.fc_1").bias)
        ws = tp.layer(0, f"{name}.shortcut").weight  # every block maps 2H to H
        if pooled is None:
            return mm(x, ws) + dx
        return mm(x, ws[:, :h]) + mm(pooled, ws[:, h:]) + dx

    net = linear(tp.layer(0, "fc_pos_0"), points)
    net = block(0, net)
    net = block(1, net, pool(net))
    net = block(2, net, pool(net))
    net = block(3, net, pool(net))
    net = pool(net)[:, 0]
    return linear(tp.layer(0, "fc_c"), torch.relu(net))
