"""Conditional Glow normalising flow of stage 1 (port of
egohmr_tpu/flow/glow.py).

Each of the flow's steps is ActNorm -> LU-decomposed invertible linear ->
affine coupling whose scale and shift come from a residual net over the
identity half and the context; the base distribution is a standard normal.
`glow_forward` maps data to noise (`glow_log_prob` uses it), `glow_inverse`
noise to data (sampling). Plain torch ops in float32.

The module tree follows the nflows `ConditionalGlow` of the reference
checkpoints, so its `state_dict` keys are those of `flow.flow.` there:
  _transform._transforms.{3k}    ActNorm   log_scale, shift  [1, F]
  _transform._transforms.{3k+1}  LULinear  lower_entries, upper_entries,
                                           unconstrained_upper_diag, bias
  _transform._transforms.{3k+2}  coupling  transform_net.{initial_layer,
                                           blocks.{j}.linear_layers.{0,1},
                                           blocks.{j}.context_layer,
                                           final_layer}
nflows also stores state that this port computes instead: ActNorm's
`initialized` flag and the coupling's `identity_features` and
`transform_features` index buffers.
`Glow` takes those keys when a reference checkpoint has them and leaves
them out of its own `state_dict`, so a reference `.pt` and a dict from
`interop.prohmr_state_dict_from_jax` (which has none of them) both load with
`strict=True`; index buffers that disagree with the coupling's split are
refused.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.core import linear

# nflows state that the port recomputes (see the module docstring)
_NFLOWS_STEP_KEY = re.compile(
    r"_transform\._transforms\.(\d+)\.(initialized|identity_features|transform_features)$")


@dataclass(frozen=True)
class GlowConfig:
    features: int = 144
    hidden_features: int = 1024
    num_layers: int = 4             # flow steps
    num_blocks_per_layer: int = 2   # residual blocks inside each coupling net
    context_features: int = 2566    # 2048 image + 6 camera + 512 scene


def coupling_split(features: int, step: int) -> Tuple[np.ndarray, np.ndarray]:
    """(identity, transformed) feature indices of step `step`: the nflows
    mask is ones with the even indices -1, its sign flipped on odd steps, so
    the halves interleave and swap from step to step."""
    mask = np.ones(features)
    mask[::2] = -1
    if step % 2 == 1:
        mask = -mask
    idx = np.arange(features)
    return idx[mask <= 0], idx[mask > 0]


class ActNorm(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.log_scale = nn.Parameter(torch.zeros(1, features))
        self.shift = nn.Parameter(torch.zeros(1, features))


class LULinear(nn.Module):
    """Identity at init: zero triangles, softplus(diag) + 1e-3 = 1."""

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        n_tri = features * (features - 1) // 2
        self.eps = eps
        self.lower_entries = nn.Parameter(torch.zeros(n_tri))
        self.upper_entries = nn.Parameter(torch.zeros(n_tri))
        self.unconstrained_upper_diag = nn.Parameter(
            torch.full((features,), math.log(math.exp(1.0 - eps) - 1.0)))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("tril", torch.tril_indices(features, features, -1), persistent=False)
        self.register_buffer("triu", torch.triu_indices(features, features, 1), persistent=False)


class ResidualBlock(nn.Module):
    def __init__(self, hidden: int, context_features: int):
        super().__init__()
        self.context_layer = nn.Linear(context_features, hidden)
        self.linear_layers = nn.ModuleList([nn.Linear(hidden, hidden), nn.Linear(hidden, hidden)])


class ResidualNet(nn.Module):
    def __init__(self, in_features: int, out_features: int, hidden: int,
                 context_features: int, num_blocks: int):
        super().__init__()
        self.initial_layer = nn.Linear(in_features + context_features, hidden)
        self.blocks = nn.ModuleList([ResidualBlock(hidden, context_features)
                                     for _ in range(num_blocks)])
        self.final_layer = nn.Linear(hidden, out_features)


class AffineCoupling(nn.Module):
    def __init__(self, cfg: GlowConfig, step: int):
        super().__init__()
        id_idx, tr_idx = coupling_split(cfg.features, step)
        self.register_buffer("id_idx", torch.tensor(id_idx), persistent=False)
        self.register_buffer("tr_idx", torch.tensor(tr_idx), persistent=False)
        # [identity | transformed] back to feature order
        self.register_buffer("unsplit", torch.tensor(np.argsort(np.concatenate([id_idx, tr_idx]))),
                             persistent=False)
        self.transform_net = ResidualNet(len(id_idx), 2 * len(tr_idx), cfg.hidden_features,
                                         cfg.context_features, cfg.num_blocks_per_layer)


class _Transforms(nn.Module):
    def __init__(self, cfg: GlowConfig):
        super().__init__()
        steps = []
        for k in range(cfg.num_layers):
            steps += [ActNorm(cfg.features), LULinear(cfg.features), AffineCoupling(cfg, k)]
        self._transforms = nn.ModuleList(steps)


class Glow(nn.Module):
    def __init__(self, cfg: GlowConfig):
        super().__init__()
        self.cfg = cfg
        self._transform = _Transforms(cfg)

    def steps(self):
        """[(ActNorm, LULinear, AffineCoupling)] in flow order."""
        t = self._transform._transforms
        return [(t[3 * k], t[3 * k + 1], t[3 * k + 2]) for k in range(self.cfg.num_layers)]

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict, missing_keys,
                              unexpected_keys, error_msgs):
        for key in [k for k in state_dict if k.startswith(prefix)]:
            m = _NFLOWS_STEP_KEY.match(key[len(prefix):])
            if m is None:
                continue
            value = state_dict.pop(key)
            i, name = int(m.group(1)), m.group(2)
            if name == "initialized":
                continue
            steps = self._transform._transforms
            want = getattr(steps[i] if i < len(steps) else None,
                           "id_idx" if name == "identity_features" else "tr_idx", None)
            if want is None or not torch.equal(value.to(want.device).long(), want):
                error_msgs.append(f"{key}: nflows' coupling split differs from the port's")
        super()._load_from_state_dict(state_dict, prefix, local_metadata, strict, missing_keys,
                                      unexpected_keys, error_msgs)


@torch.no_grad()
def init_glow_(glow: Glow, generator: torch.Generator) -> Glow:
    """The JAX package's init distributions: identity ActNorm and LU, linear
    layers U(+-1/sqrt(fan_in)), and the last layer of every residual block
    U(+-1e-3) (nflows' zero initialisation), so each step starts close to
    the identity."""
    def uniform_(t, bound):
        t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * bound)

    for an, lu, coupling in glow.steps():
        an.log_scale.zero_()
        an.shift.zero_()
        lu.lower_entries.zero_()
        lu.upper_entries.zero_()
        lu.unconstrained_upper_diag.fill_(math.log(math.exp(1.0 - lu.eps) - 1.0))
        lu.bias.zero_()
        net = coupling.transform_net
        for m in net.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                uniform_(m.weight, bound)
                uniform_(m.bias, bound)
        for blk in net.blocks:
            uniform_(blk.linear_layers[1].weight, 1e-3)
            uniform_(blk.linear_layers[1].bias, 1e-3)
    return glow


# ------------------------------------------------------------------ steps
def actnorm_forward(an: ActNorm, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    y = torch.exp(an.log_scale) * x + an.shift
    return y, an.log_scale.sum().expand(x.shape[0])


def actnorm_inverse(an: ActNorm, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = (y - an.shift) * torch.exp(-an.log_scale)
    return x, (-an.log_scale.sum()).expand(y.shape[0])


def _lu_matrices(lu: LULinear):
    n = lu.bias.shape[0]
    eye = torch.eye(n, dtype=lu.bias.dtype, device=lu.bias.device)
    lower = eye.index_put((lu.tril[0], lu.tril[1]), lu.lower_entries)
    diag = F.softplus(lu.unconstrained_upper_diag) + lu.eps
    upper = torch.diag(diag).index_put((lu.triu[0], lu.triu[1]), lu.upper_entries)
    return lower, upper, diag


def lu_linear_forward(lu: LULinear, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    lower, upper, diag = _lu_matrices(lu)
    y = x @ (lower @ upper).t() + lu.bias
    return y, torch.log(diag).sum().expand(x.shape[0])


def lu_linear_inverse(lu: LULinear, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two triangular solves on [F, B], as the JAX package; the matrix is
    never inverted."""
    lower, upper, diag = _lu_matrices(lu)
    rhs = (y - lu.bias).t()
    sol = torch.linalg.solve_triangular(lower, rhs, upper=False)
    x = torch.linalg.solve_triangular(upper, sol, upper=True).t()
    return x, (-torch.log(diag).sum()).expand(y.shape[0])


def residual_net(net: ResidualNet, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
    h = linear(net.initial_layer, torch.cat([x, context], dim=-1))
    for blk in net.blocks:
        t = linear(blk.linear_layers[0], torch.relu(h))
        t = linear(blk.linear_layers[1], torch.relu(t))
        # nflows' GLU: the block's output gated by its context projection
        h = h + t * torch.sigmoid(linear(blk.context_layer, context))
    return linear(net.final_layer, h)


def _scale_and_shift(coupling: AffineCoupling, x_id: torch.Tensor, context: torch.Tensor):
    raw = residual_net(coupling.transform_net, x_id, context)
    n = coupling.tr_idx.shape[0]
    return torch.sigmoid(raw[:, n:] + 2.0) + 1e-3, raw[:, :n]


def coupling_forward(coupling: AffineCoupling, x: torch.Tensor,
                     context: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x_id, x_tr = x[:, coupling.id_idx], x[:, coupling.tr_idx]
    scale, shift = _scale_and_shift(coupling, x_id, context)
    y = torch.cat([x_id, x_tr * scale + shift], dim=1)[:, coupling.unsplit]
    return y, torch.log(scale).sum(-1)


def coupling_inverse(coupling: AffineCoupling, y: torch.Tensor,
                     context: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    y_id, y_tr = y[:, coupling.id_idx], y[:, coupling.tr_idx]
    scale, shift = _scale_and_shift(coupling, y_id, context)
    x = torch.cat([y_id, (y_tr - shift) / scale], dim=1)[:, coupling.unsplit]
    return x, -torch.log(scale).sum(-1)


# ------------------------------------------------------------------- flow
def glow_forward(glow: Glow, x: torch.Tensor,
                 context: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """data -> noise: (z [B, F], total log|det| [B])."""
    logdet = x.new_zeros(x.shape[0])
    for an, lu, coupling in glow.steps():
        x, ld0 = actnorm_forward(an, x)
        x, ld1 = lu_linear_forward(lu, x)
        x, ld2 = coupling_forward(coupling, x, context)
        logdet = logdet + ld0 + ld1 + ld2
    return x, logdet


def glow_inverse(glow: Glow, z: torch.Tensor,
                 context: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """noise -> data: (x [B, F], total log|det| of the inverse [B])."""
    logdet = z.new_zeros(z.shape[0])
    for an, lu, coupling in reversed(glow.steps()):
        z, ld0 = coupling_inverse(coupling, z, context)
        z, ld1 = lu_linear_inverse(lu, z)
        z, ld2 = actnorm_inverse(an, z)
        logdet = logdet + ld0 + ld1 + ld2
    return z, logdet


def std_normal_log_prob(z: torch.Tensor) -> torch.Tensor:
    return -0.5 * (z * z).sum(-1) - 0.5 * z.shape[-1] * math.log(2 * math.pi)


def glow_log_prob(glow: Glow, x: torch.Tensor,
                  context: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """log p(x | context) [B] and z [B, F]."""
    z, logdet = glow_forward(glow, x, context)
    return std_normal_log_prob(z) + logdet, z


def glow_sample_and_log_prob(glow: Glow, context: torch.Tensor,
                             noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map the noise z [B, S, F] to samples x ~ p(x | context): (x [B, S, F],
    log_prob [B, S]). Each context row serves its S samples (b-major,
    `repeat_interleave`), and a sample's log-probability is N(z) less the
    inverse's log|det|."""
    B, S, d = noise.shape
    z = noise.reshape(B * S, d)
    x, logdet_inv = glow_inverse(glow, z, context.repeat_interleave(S, dim=0))
    return x.reshape(B, S, d), (std_normal_log_prob(z) - logdet_inv).reshape(B, S)


@torch.no_grad()
def initialize_actnorms(glow: Glow, x: torch.Tensor, context: torch.Tensor) -> Glow:
    """ActNorm's data-dependent init, in place: walk the chain on a batch of
    data and set each ActNorm from its input, scale 1 / (std + 1e-10) with
    ddof 1 and shift -mean(x / std), so that its output is standardised."""
    h = x
    for an, lu, coupling in glow.steps():
        std = h.std(dim=0, correction=1) + 1e-10
        an.log_scale.copy_(-torch.log(std)[None])
        an.shift.copy_(-(h / std).mean(dim=0)[None])
        h, _ = actnorm_forward(an, h)
        h, _ = lu_linear_forward(lu, h)
        h, _ = coupling_forward(coupling, h, context)
    return glow
