"""Modulated graph-convolutional denoiser (port of egohmr_tpu/nn/gcn.py).

The 24-node joint graph is tiny, so each layer is two [B*24, in] x [in, out]
matmuls plus 24x24 adjacency mixes; plain torch ops (the JAX package removed
its GCN kernel after it lost to XLA). BatchNorm statistics reduce over
(batch, joints).

The optional embedded-gaussian non-local block (`gcn_nonlocal_layer`, off in
the default config) follows the residual layers. Its modules carry the
reference's names and shapes: `g`, `theta`, `phi` and `W.0` are 1x1 Conv2d
over a [B, C, 1, 24] layout, which are per-node linears here, and `W.1` is
its BatchNorm2d.

`modulated_gcn_forward_tp` is the same network split over a data row's
model axis (`parallel/tp.py`), for inference.

On the card, in bf16 inference, each BatchNorm'd graph convolution of
`modulated_gcn_forward` runs what follows its two weight products (the
modulation, the adjacency mix, the bias, BatchNorm, ReLU and the residual
add) as one kernel (`nn/gconv_epilogue.py`); see `_fused`.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..parallel.mesh import DataParallel
from ..parallel.tp import TensorParallel
from . import gconv_epilogue as epilogue
from .core import batchnorm, mm


class ModulatedGraphConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, n_nodes: int = 24):
        super().__init__()
        self.W = nn.Parameter(torch.zeros(2, in_dim, out_dim))
        self.M = nn.Parameter(torch.zeros(n_nodes, out_dim))
        self.adj2 = nn.Parameter(torch.full((n_nodes, n_nodes), 1e-6))
        self.bias = nn.Parameter(torch.zeros(out_dim))


class GraphConv(nn.Module):
    """gconv -> BatchNorm (stats over batch and joints) -> ReLU."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.gconv = ModulatedGraphConv(in_dim, out_dim)
        self.bn = nn.BatchNorm1d(out_dim)


class ResGraphConv(nn.Module):
    def __init__(self, hid_dim: int):
        super().__init__()
        self.gconv1 = GraphConv(hid_dim, hid_dim)
        self.gconv2 = GraphConv(hid_dim, hid_dim)


class NonLocalBlock(nn.Module):
    """Embedded-gaussian non-local block over the 24 nodes, with the
    reference's configuration (no sub-sampling, BatchNorm on the output)."""

    def __init__(self, channels: int):
        super().__init__()
        inter = max(channels // 2, 1)
        self.g = nn.Conv2d(channels, inter, 1)
        self.theta = nn.Conv2d(channels, inter, 1)
        self.phi = nn.Conv2d(channels, inter, 1)
        self.W = nn.Sequential(nn.Conv2d(inter, channels, 1), nn.BatchNorm2d(channels))


class ModulatedGCN(nn.Module):
    def __init__(self, in_dim: int, hid_dim: int = 1024, out_dim: int = 6,
                 num_layers: int = 4, nonlocal_layer: bool = False):
        super().__init__()
        self.gconv_input = nn.ModuleList([GraphConv(in_dim, hid_dim)])
        self.gconv_layers = nn.ModuleList(
            [ResGraphConv(hid_dim) for _ in range(num_layers)])
        self.non_local = NonLocalBlock(hid_dim) if nonlocal_layer else None
        self.gconv_output = ModulatedGraphConv(hid_dim, out_dim)


def modulated_gconv_mix(p: ModulatedGraphConv, adj: torch.Tensor,
                        h0: torch.Tensor, h1: torch.Tensor) -> torch.Tensor:
    """Modulation + adjacency mix given h0 = x @ W[0], h1 = x @ W[1]."""
    # symmetrise in f32, then drop to the activation dtype: a f32 adjacency
    # would promote every layer's activations back to f32 on the bf16 path
    a = adj.float() + p.adj2.float()
    a = ((a.T + a) / 2).to(h0.dtype)
    eye = torch.eye(a.shape[0], dtype=h0.dtype, device=h0.device)
    m = p.M
    out = (torch.einsum("jk,bkd->bjd", a * eye, m * h0)
           + torch.einsum("jk,bkd->bjd", a * (1 - eye), m * h1))
    return out + p.bias


def modulated_gconv(p: ModulatedGraphConv, adj: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """x [B, J, in] -> [B, J, out]."""
    return modulated_gconv_mix(p, adj, x @ p.W[0], x @ p.W[1])


def _bn_relu(bn: nn.BatchNorm1d, x: torch.Tensor, train: bool,
             dp: Optional[DataParallel] = None) -> torch.Tensor:
    return torch.relu(batchnorm(bn, x, channel_dim=-1, train=train, dp=dp))


def _fused(p: GraphConv, train: bool, *acts: torch.Tensor) -> bool:
    """Whether the graph convolution `p` on the activations `acts` takes the
    fused epilogue: on the card, where `_kernel_arithmetic_holds`."""
    return all(a.is_cuda for a in acts) and _kernel_arithmetic_holds(p, train, *acts)


def _kernel_arithmetic_holds(p: GraphConv, train: bool, *acts: torch.Tensor) -> bool:
    """Whether the kernel computes what the caller asks for: bf16
    activations and weights, channels the kernel's width divides, BatchNorm
    on its running statistics, and nothing for autograd to record. The
    kernel's f32 arithmetic with one rounding then stands in for the plain
    path's rounding after every op, as XLA's fusions do on the JAX side."""
    gc = p.gconv
    bf = torch.bfloat16
    return (not train
            and all(a.dtype == bf for a in acts)
            and gc.M.dtype == gc.bias.dtype == gc.adj2.dtype == bf
            and gc.M.shape[-1] % epilogue.VEC == 0
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in (*acts, *p.parameters()))))


def _graph_conv_mix(p: GraphConv, adj: torch.Tensor, h0: torch.Tensor, h1: torch.Tensor,
                    train: bool, dp: Optional[DataParallel],
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """relu(BN(gconv mix of h0 = x @ W[0], h1 = x @ W[1])) (+ residual)."""
    if _fused(p, train, h0, h1):
        c = epilogue.epilogue_constants(p.gconv, adj, p.bn)
        return epilogue.gconv_epilogue(c, h0, h1, residual)
    out = _bn_relu(p.bn, modulated_gconv_mix(p.gconv, adj, h0, h1), train, dp)
    return out if residual is None else residual + out


def graph_conv(p: GraphConv, adj: torch.Tensor, x: torch.Tensor,
               train: bool = False, dp: Optional[DataParallel] = None,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """relu(BN(gconv(x))) (+ residual)."""
    W = p.gconv.W
    return _graph_conv_mix(p, adj, x @ W[0], x @ W[1], train, dp, residual)


def _conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 Conv2d on [B, C, 1, J] as a linear on x [B, J, C]."""
    y = mm(x, conv.weight.view(conv.weight.shape[0], -1))
    return y + conv.bias.to(torch.promote_types(y.dtype, conv.bias.dtype))


def nonlocal_block(p: NonLocalBlock, x: torch.Tensor, *, train: bool = False,
                   dp: Optional[DataParallel] = None) -> torch.Tensor:
    """x [B, J, C] -> [B, J, C]: z = BN(W(softmax(theta(x) phi(x)^T) g(x))) + x,
    the softmax over the nodes in f32 whatever the activation dtype."""
    g_x, theta_x, phi_x = (_conv1x1(c, x) for c in (p.g, p.theta, p.phi))
    f = torch.einsum("bjc,bkc->bjk", theta_x, phi_x)
    f = torch.softmax(f.float(), dim=-1).to(x.dtype)
    y = torch.einsum("bjk,bkc->bjc", f, g_x)
    w_y = batchnorm(p.W[1], _conv1x1(p.W[0], y), channel_dim=-1, train=train, dp=dp)
    return x + w_y


def modulated_gcn_forward(
    model: ModulatedGCN,
    adj: torch.Tensor,
    x: Optional[torch.Tensor],
    *,
    train: bool = False,
    input_h: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    dp: Optional[DataParallel] = None,
) -> torch.Tensor:
    """x [B, 24, in] -> [B, 24, out]. `train`: BatchNorm on the batch's
    statistics, updating the running ones; with `dp`, on the whole
    data-parallel batch's.

    `input_h`: precomputed (x @ W[0], x @ W[1]) of the input layer, so the
    sampler can hoist the loop-invariant conditioning projection; `x` is
    ignored when given."""
    gi = model.gconv_input[0]
    if input_h is not None:
        out = _graph_conv_mix(gi, adj, *input_h, train, dp)
    else:
        out = graph_conv(gi, adj, x, train, dp)
    for blk in model.gconv_layers:
        h = graph_conv(blk.gconv1, adj, out, train, dp)
        out = graph_conv(blk.gconv2, adj, h, train, dp, residual=out)
    if model.non_local is not None:
        out = nonlocal_block(model.non_local, out, train=train, dp=dp)
    return modulated_gconv(model.gconv_output, adj, out)


def _nonlocal_block_tp(tp: TensorParallel, x: torch.Tensor) -> torch.Tensor:
    """`nonlocal_block` in eval with `g`, `theta` and `phi` column-parallel:
    the logits theta(x) phi(x)^T contract over the split channels, so the
    shards' partial logits are added (shard 0 first) before the f32
    softmax; each shard applies the softmax to its slice of g(x), and
    `W.0`, row-parallel, sums the shards' products before its bias and the
    replicated BatchNorm `W.1`."""
    xs = tp.scatter(x)
    gs, logits = [], []
    for s in range(tp.size):
        g, theta, phi = (_conv1x1(tp.layer(s, f"non_local.{n}"), xs[s])
                         for n in ("g", "theta", "phi"))
        gs.append(g)
        logits.append(torch.einsum("bjc,bkc->bjk", theta, phi))
    f = torch.softmax(tp.reduce(logits).float(), dim=-1).to(x.dtype)
    fs = tp.scatter(f)
    parts = []
    for s in range(tp.size):
        w = tp.layer(s, "non_local.W.0").weight
        y = torch.einsum("bjk,bkc->bjc", fs[s], gs[s])
        parts.append(mm(y, w.view(w.shape[0], -1)))
    w0 = tp.layer(0, "non_local.W.0")
    w_y = tp.reduce(parts)
    w_y = w_y + w0.bias.to(torch.promote_types(w_y.dtype, w0.bias.dtype))
    return x + batchnorm(tp.layer(0, "non_local.W.1"), w_y, channel_dim=-1, train=False)


@torch.no_grad()
def modulated_gcn_forward_tp(
    tp: TensorParallel,
    adj: torch.Tensor,
    x: Optional[torch.Tensor],
    *,
    train: bool = False,
    input_h: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> torch.Tensor:
    """`modulated_gcn_forward` in eval, split over the devices of one data
    row (`tp`, a placed `ModulatedGCN`, `parallel.place_params` with
    `gcn_tp_specs`). x [B, 24, in] on the row's first device -> [B, 24, out]
    there.

    A column-parallel layer (`gconv_input`, every `gconv1`) runs whole on
    each shard with its slices of W, M, the bias and the BatchNorm, `adj2`
    replicated; `gconv_input`'s output is gathered back in shard order,
    because the residual stream is replicated and every `gconv1` reads all
    of it. A row-parallel layer (`gconv2`, `gconv_output`) adds the shards'
    partial x @ W[0] and x @ W[1] (each shard's slice of the input's
    channels) on the first device, shard 0 first, in the activation dtype,
    before the replicated modulation, adjacency mix, bias and BatchNorm.
    Equal to the dense forward up to the order of the split sums.

    `input_h`: per shard, the precomputed (x @ W[0], x @ W[1]) of the input
    layer's columns on that shard's device (the sampler's hoisted
    conditioning projection); `x` is ignored when given. `train=True`
    raises: the split is inference only, as in the JAX package."""
    if train:
        raise ValueError("the tensor-parallel GCN is inference only (train=False)")
    adjs = tp.scatter(adj)

    def column(path, xs=None, hs=None):
        outs = []
        for s in range(tp.size):
            gc = tp.layer(s, f"{path}.gconv")
            h0, h1 = hs[s] if hs is not None else (xs[s] @ gc.W[0], xs[s] @ gc.W[1])
            outs.append(_bn_relu(tp.layer(s, f"{path}.bn"),
                                 modulated_gconv_mix(gc, adjs[s], h0, h1), False))
        return outs

    def row(path, hs):
        parts0, parts1 = [], []
        for s in range(tp.size):
            W = tp.layer(s, path).W
            parts0.append(hs[s] @ W[0])
            parts1.append(hs[s] @ W[1])
        return modulated_gconv_mix(tp.layer(0, path), adj, tp.reduce(parts0),
                                   tp.reduce(parts1))

    if input_h is not None:
        out = tp.gather(column("gconv_input.0", hs=input_h))
    else:
        out = tp.gather(column("gconv_input.0", xs=tp.scatter(x)))
    for i in range(len(tp.module.gconv_layers)):
        residual = out
        h = column(f"gconv_layers.{i}.gconv1", xs=tp.scatter(out))
        out = _bn_relu(tp.layer(0, f"gconv_layers.{i}.gconv2.bn"),
                       row(f"gconv_layers.{i}.gconv2.gconv", h), False)
        out = residual + out
    if tp.module.non_local is not None:
        out = _nonlocal_block_tp(tp, out)
    return row("gconv_output", tp.split(out))
