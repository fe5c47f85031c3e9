"""Opt-in tensor parallelism: the data x model grid and the placement rules
(port of egohmr_tpu/parallel/tp.py).

The JAX package's inference-only Megatron split of the two custom networks
over the "model" axis of a data x model mesh:

  * scene PointNet (`nn/pointnet.py`): each ResnetBlockFC's `fc_0` is
    column-parallel (the block's hidden width split), its `fc_1`
    row-parallel (the partial sums added back into the replicated residual
    stream); `fc_pos_0`, the shortcuts and `fc_c` stay replicated;
  * ModulatedGCN denoiser (`nn/gcn.py`): `gconv_input` and every `gconv1`
    are column-parallel, their BatchNorm split per channel (BatchNorm is
    elementwise per channel, so no cross-shard statistics are needed);
    `gconv2` and `gconv_output` are row-parallel; in the non-local block
    `g`, `theta` and `phi` are column-parallel and `W.0` row-parallel.

JAX places the parameters and lets GSPMD insert the all-reduces. Here one
process drives the whole grid, as the multi-device `Predictor` drives its
flat device list: `place_params` cuts each split tensor into one shard per
device of a data row, and the split forwards (`nn.pointnet_forward_tp`,
`nn.modulated_gcn_forward_tp`) run each shard's matmuls on its device and
add the partial sums on the row's first device, shard 0 first, in the
activation dtype (bf16 on the bf16 path), as GSPMD's all-reduce of a dot's
output is. Everything else (the ResNet, the embedders, the betas head,
SMPL, the guidance) stays replicated on the row's first device. Inference
only, as in the JAX package.

The rules name the `state_dict` keys of the port's modules, which are the
reference's: an `nn.Linear` weight is [out, in], so a column split cuts
dim 0 and a row split dim 1; a `ModulatedGraphConv.W` is [2, in, out], as
in JAX; the non-local block's 1x1 `Conv2d` weights are [out, in, 1, 1].
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch import nn

Device = Union[torch.device, str]


class Placement(NamedTuple):
    """Where a tensor lives on a data row's model axis: whole on the row's
    first device ("replicated"), or cut on `dim` into one shard per device
    of a column-parallel ("column") or row-parallel ("row") layer."""

    kind: str
    dim: Optional[int] = None


REPLICATED = Placement("replicated")


def column(dim: int) -> Placement:
    return Placement("column", dim)


def row(dim: int) -> Placement:
    return Placement("row", dim)


Specs = Dict[str, Placement]


def make_dp_tp_grid(dp: int, tp: int,
                    devices: Optional[Sequence[Device]] = None) -> List[List[torch.device]]:
    """A dp x tp grid: `dp` rows, each one data block, of `tp` devices each
    (the model axis innermost, as in JAX's `make_dp_tp_mesh`), taken in
    order from `devices` (default: every visible CUDA device). An entry may
    repeat: several shards may share one card."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) < dp * tp:
        raise ValueError(f"need {dp * tp} devices for a {dp}x{tp} grid, have {len(devices)}")
    return [devices[r * tp:(r + 1) * tp] for r in range(dp)]


_LINEAR_COL = {"weight": column(0), "bias": column(0)}  # [out, in] and 1x1 [out, in, 1, 1]
_LINEAR_ROW = {"weight": row(1)}                        # the bias is added after the sum
_GCONV_COL = {"W": column(2), "M": column(1), "bias": column(0)}  # adj2 replicated
_GCONV_ROW = {"W": row(1)}                              # M, adj2, bias act on the sum
_BN_COL = {k: column(0) for k in ("weight", "bias", "running_mean", "running_var")}


def _leaf_rules(path: str) -> Dict[str, Placement]:
    """The split leaves of the layer at `path` (relative to its network);
    leaves not named are replicated."""
    parts = path.split(".")
    if parts[0].startswith("block_"):  # ResnetPointnet's blocks
        return {"fc_0": _LINEAR_COL, "fc_1": _LINEAR_ROW}.get(parts[1], {})
    if parts[0] == "gconv_layers":  # ModulatedGCN's residual pairs
        parts = parts[2:]
    return {
        "gconv_input.0.gconv": _GCONV_COL, "gconv_input.0.bn": _BN_COL,
        "gconv1.gconv": _GCONV_COL, "gconv1.bn": _BN_COL,
        "gconv2.gconv": _GCONV_ROW, "gconv_output": _GCONV_ROW,
        "non_local.g": _LINEAR_COL, "non_local.theta": _LINEAR_COL,
        "non_local.phi": _LINEAR_COL, "non_local.W.0": _LINEAR_ROW,
    }.get(".".join(parts), {})


def _specs(module: nn.Module, prefix: str = "") -> Specs:
    out = {}
    for key in module.state_dict():
        path, leaf = key.rsplit(".", 1)
        out[prefix + key] = _leaf_rules(path).get(leaf, REPLICATED)
    return out


def pointnet_tp_specs(model: nn.Module, prefix: str = "") -> Specs:
    """Placement of every `state_dict` key of a `ResnetPointnet`: each
    block's `fc_0` column-parallel, `fc_1`'s weight row-parallel (its bias
    is added once, after the partial sums), the residual stream's layers
    (`fc_pos_0`, the shortcuts, `fc_c`) replicated."""
    return _specs(model, prefix)


def gcn_tp_specs(model: nn.Module, prefix: str = "") -> Specs:
    """Placement of every `state_dict` key of a `ModulatedGCN`:
    column-parallel `gconv_input` and `gconv1` (W on its output dim, M and
    bias with it, `adj2` replicated; the BatchNorm per channel), row-parallel
    `gconv2` and `gconv_output` (W on its input dim; the modulation, the
    adjacency mix, the bias and `gconv2`'s BatchNorm act on the summed
    output, replicated); in the non-local block `g`, `theta` and `phi`
    column-parallel, `W.0` row-parallel and its BatchNorm `W.1` replicated.
    `num_batches_tracked` is replicated."""
    return _specs(model, prefix)


def egohmr_tp_specs(model: nn.Module) -> Specs:
    """Placement of every `state_dict` key of an `EgoHMR`: the scene
    PointNet and the GCN denoiser tensor-parallel, everything else (the
    ResNet, the embedders, the betas head) replicated."""
    specs = {k: REPLICATED for k in model.state_dict()}
    specs.update(pointnet_tp_specs(model.scene_enc, "scene_enc."))
    specs.update(gcn_tp_specs(model.diffusion_model, "diffusion_model."))
    return specs


@dataclass(frozen=True)
class TensorParallel:
    """One data row of a placed model.

    `module` is the model on `devices[0]` with every split tensor emptied
    (zero elements), so that a dense forward of a split network fails
    rather than run one-way. `shards[s]` maps, on `devices[s]`, every split
    key to its s-th shard, and every replicated key of a module that has a
    split tensor to a copy (on shard 0: the module's own tensor, as for
    every other replicated key under the split networks)."""

    devices: Tuple[torch.device, ...]
    module: nn.Module
    shards: Tuple[Dict[str, torch.Tensor], ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def sub(self, name: str) -> "TensorParallel":
        """The placement of the submodule `name` (its keys relative)."""
        pre = name + "."
        return TensorParallel(
            self.devices, self.module.get_submodule(name),
            tuple({k[len(pre):]: v for k, v in sh.items() if k.startswith(pre)}
                  for sh in self.shards))

    def layer(self, s: int, path: str) -> SimpleNamespace:
        """Shard s's tensors of the layer at `path`, as the attributes that
        the dense forward functions read off a module (`weight`, `bias`,
        `W`, `M`, `adj2`, `running_mean`, ..., and a BatchNorm's `eps`)."""
        mod = self.module.get_submodule(path)
        names = [n for n, _ in (*mod.named_parameters(recurse=False),
                                *mod.named_buffers(recurse=False))]
        return SimpleNamespace(**{"bias": None, "eps": getattr(mod, "eps", None),
                                  **{n: self.shards[s][f"{path}.{n}"] for n in names}})

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Column-parallel outputs concatenated on their last dim in shard
        order on the row's first device."""
        return torch.cat([p.to(self.devices[0]) for p in parts], dim=-1)

    def reduce(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Row-parallel partial sums added on the row's first device in a
        fixed order, shard 0 first, in their own dtype."""
        out = parts[0].to(self.devices[0])
        for p in parts[1:]:
            out = out + p.to(self.devices[0])
        return out

    def scatter(self, x: torch.Tensor) -> List[torch.Tensor]:
        """A replicated activation on every shard's device."""
        return [x.to(d) for d in self.devices]

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Each shard's contiguous slice of the last dim of a replicated
        activation, on its device: a row-parallel layer's input."""
        return [c.to(d) for c, d in zip(x.chunk(self.size, dim=-1), self.devices)]


def _set(module: nn.Module, key: str, value: torch.Tensor) -> None:
    path, leaf = key.rsplit(".", 1) if "." in key else ("", key)
    mod = module.get_submodule(path)
    if leaf in mod._parameters:
        mod._parameters[leaf].data = value
    else:
        mod._buffers[leaf] = value


@torch.no_grad()
def place_params(grid: Sequence[Sequence[Device]], model: nn.Module,
                 specs: Specs) -> List[TensorParallel]:
    """Place a copy of `model` on every row of `grid` (a sequence of rows of
    devices): each split tensor cut on its dimension into one contiguous
    shard per device of the row, in the row's order; the rest whole on the
    row's first device. `specs` holds a placement for every `state_dict`
    key. A split dimension that the row's width does not divide raises, as
    `jax.device_put` does. `model` is not changed."""
    state = model.state_dict()
    if set(specs) != set(state):
        missing, extra = sorted(set(state) - set(specs)), sorted(set(specs) - set(state))
        raise ValueError(f"specs do not match the module's keys: missing {missing[:5]}, "
                         f"extra {extra[:5]}")
    rows = [[torch.device(d) for d in r] for r in grid]
    if not rows or any(len(r) != len(rows[0]) or not r for r in rows):
        raise ValueError(f"a grid is rows of equal, non-zero width: {[len(r) for r in rows]}")
    tp = len(rows[0])
    split = {k: p for k, p in specs.items() if p.kind != "replicated"}
    for k, p in split.items():
        n = state[k].shape[p.dim]
        if n % tp:
            raise ValueError(f"{k}: dim {p.dim} of size {n} does not divide by the "
                             f"{tp}-way model axis")
    split_modules = {k.rsplit(".", 1)[0] for k in split}
    placed = []
    for devices in rows:
        module = copy.deepcopy(model)
        for k in split:
            _set(module, k, state[k].new_empty(0))
        module.to(devices[0])
        mine = module.state_dict(keep_vars=True)
        shards = []
        for s, dev in enumerate(devices):
            sh = {}
            for k, p in specs.items():
                if p.kind != "replicated":
                    size = state[k].shape[p.dim] // tp
                    sh[k] = state[k].detach().narrow(p.dim, s * size, size).to(
                        dev, copy=True).contiguous()
                elif s == 0:
                    sh[k] = mine[k]
                elif k.rsplit(".", 1)[0] in split_modules:
                    sh[k] = mine[k].detach().to(dev, copy=True)
            shards.append(sh)
        placed.append(TensorParallel(tuple(devices), module, tuple(shards)))
    return placed
