"""Data parallelism over processes (port of egohmr_tpu/parallel/mesh.py).

The JAX package scales out over a 1-D "data" mesh: parameters replicated,
the batch sharded on its leading axis, gradients and metrics `pmean`-ed,
BatchNorm statistics synchronised across replicas. Here one process holds
one replica on its device (`torchrun --nproc_per_node=N -m ...`), a frozen
`DataParallel` record stands for the mesh, and these plain functions for its
shardings and collectives:

* `rows` / `shard_batch`: the rank's contiguous block of the leading axis,
  JAX's `P("data")`;
* `draw_rows`: a random draw made for the whole batch, of which the block
  keeps its rows, so that N-way draws what 1-way draws;
* `gather_rows`: the blocks concatenated in rank order;
* `replicate`: every parameter and buffer broadcast from rank 0;
* `mean_grads` / `mean_metrics`: JAX's `pmean` of gradients and metrics,
  one `all_reduce` per dtype over a flattened buffer;
* `all_reduce_sum`: JAX's `psum` with its transpose under
  `shard_map(check_vma=False)`, a sum again, as the backward: what
  cross-replica BatchNorm differentiates through.

`None` in place of a record is the 1-way run, and every function is then
the identity. The row functions also take a plain block `(i, n)`, the i-th
of n equal blocks, where no process group stands behind the split (the
multi-device `Predictor` of one process). The backend is NCCL where each rank has a card of its own,
gloo on the CPU, and gloo where several ranks name the same card (NCCL
refuses two ranks on one GPU); gloo's `all_reduce`, `broadcast` and
`all_gather` take CUDA tensors.
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

# the record of the `init_data_parallel` call that created the default
# process group: `shutdown` destroys the group for that record only
_OWNED: Optional["DataParallel"] = None


@dataclass(frozen=True)
class DataParallel:
    """One rank of a data-parallel run: its index, the world size, the
    process group its collectives run in, and its device."""

    rank: int
    size: int
    group: Any
    device: torch.device


def _local_device(device: torch.device, local_rank: int) -> torch.device:
    """`cuda` without an index is the card of the rank's local index (modulo
    the visible cards); an explicit index or the CPU is kept."""
    if device.type != "cuda" or device.index is not None:
        return device
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("--device cuda: no CUDA device is available")
    return torch.device("cuda", local_rank % n)


def init_data_parallel(device: Union[str, torch.device] = "cuda", *,
                       init_method: Optional[str] = None) -> Optional[DataParallel]:
    """The rank's record from torchrun's `env://` variables (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`), or None at world size 1
    when no process group exists. An existing default process group is
    taken as it is (a caller may set one up itself, e.g. on a `file://`
    store); else one is created on `init_method` (default `env://`).

    Backend: NCCL when every rank has a card of its own, gloo on the CPU,
    and gloo when several ranks of a host name the same card. Rank 0 prints
    the choice to stderr."""
    global _OWNED
    device = torch.device(device)
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        local = int(os.environ.get("LOCAL_RANK", rank))
        backend = dist.get_backend()
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world <= 1:
            return None
        rank = int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        backend = None
    explicit = device.index is not None
    device = _local_device(device, local)
    shared = False
    if device.type == "cuda":
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        shared = local_world > 1 and (explicit or local_world > torch.cuda.device_count())
        torch.cuda.set_device(device)
    created = backend is None
    if created:
        backend = "nccl" if device.type == "cuda" and not shared else "gloo"
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world)
    if rank == 0:
        why = ("every rank has a card of its own" if backend == "nccl"
               else "ranks share a card (NCCL refuses two ranks on one GPU)" if shared
               else f"{device.type} tensors")
        print(f"[data parallel] {world} ranks, backend {backend}: {why}",
              file=sys.stderr, flush=True)
    dp = DataParallel(rank=rank, size=world, group=dist.group.WORLD, device=device)
    if created:
        _OWNED = dp
    return dp


def shutdown(dp: Optional[DataParallel]) -> None:
    """Destroy the default process group if the `init_data_parallel` call
    that returned `dp` created it (a group the caller set up, or an earlier
    call made, is left alone)."""
    global _OWNED
    if dp is not None and dp is _OWNED and dist.is_initialized():
        dist.destroy_process_group()
        _OWNED = None


def is_main(dp: Optional[DataParallel]) -> bool:
    """Whether this process writes files and logs: rank 0, or the 1-way run."""
    return dp is None or dp.rank == 0


def barrier(dp: Optional[DataParallel]) -> None:
    if dp is not None:
        dist.barrier(group=dp.group)


# a block of a batch: a rank's record, or (i, n) for the i-th of n equal
# blocks; None is the whole batch
Shard = Union[None, DataParallel, Tuple[int, int]]


def _block(shard: Shard) -> Tuple[int, int]:
    if shard is None:
        return 0, 1
    if isinstance(shard, DataParallel):
        return shard.rank, shard.size
    i, n = shard
    return int(i), int(n)


def global_rows(shard: Shard, n_local: int) -> int:
    """The rows of the whole batch of which `shard` holds `n_local`."""
    return n_local * _block(shard)[1]


def rows(shard: Shard, n_global: int) -> slice:
    """The block's contiguous rows of a leading axis of `n_global` rows.
    Raises unless the number of blocks divides `n_global`: nothing runs
    1-way in its place."""
    i, n = _block(shard)
    if n_global % n:
        raise ValueError(f"a batch of {n_global} rows does not divide by the "
                         f"{n}-way data-parallel world")
    per = n_global // n
    return slice(i * per, (i + 1) * per)


def shard_batch(shard: Shard, batch: Any) -> Any:
    """`rows` applied to the leading axis of every tensor and array of a
    batch tree (dicts, lists, tuples); other leaves are kept."""
    if shard is None:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(shard, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(shard, v) for v in batch)
    if isinstance(batch, (torch.Tensor, np.ndarray)) and batch.ndim >= 1:
        return batch[rows(shard, batch.shape[0])]
    return batch


def draw_rows(shard: Shard, n_local: int,
              draw: Callable[[int], torch.Tensor]) -> torch.Tensor:
    """The block's `n_local` rows of `draw(n)`, a random draw of n rows made
    for the whole batch (n = `global_rows`). Every rank draws from the same
    seeded generator, so each keeps its rows of what the 1-way run draws:
    the port's counterpart of the JAX package's global-sample-index keys."""
    n = global_rows(shard, n_local)
    return draw(n)[rows(shard, n)]


def gather_rows(dp: Optional[DataParallel], x: torch.Tensor) -> torch.Tensor:
    """Every rank's `x` concatenated on the leading axis in rank order (an
    `all_gather` into a list, which both backends take)."""
    if dp is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dp.size)]
    dist.all_gather(parts, x, group=dp.group)
    return torch.cat(parts)


def _flat_by_dtype(tensors: Iterable[torch.Tensor], op) -> None:
    """Apply the in-place collective `op` to one flattened buffer per dtype
    of `tensors`, and copy the result back into each."""
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        op(flat)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def replicate(dp: Optional[DataParallel], module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast every parameter and buffer of `module` from rank 0, in
    place: the replicas start equal."""
    if dp is not None:
        with torch.no_grad():
            _flat_by_dtype(
                [*module.parameters(), *module.buffers()],
                lambda flat: dist.broadcast(flat, src=0, group=dp.group))
    return module


def mean_grads(dp: Optional[DataParallel], tensors: Iterable[torch.Tensor]) -> None:
    """Replace each tensor's `.grad` by its mean over the ranks: one
    `all_reduce` per dtype over a flattened buffer, then a division by the
    world size (JAX's `pmean` of the gradients). Every tensor must have a
    gradient."""
    if dp is None:
        return
    grads = []
    for t in tensors:
        if t.grad is None:
            raise ValueError("mean_grads: a tensor has no gradient")
        grads.append(t.grad)

    def op(flat):
        dist.all_reduce(flat, group=dp.group)
        flat.div_(dp.size)

    _flat_by_dtype(grads, op)


def mean_metrics(dp: Optional[DataParallel],
                 metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalar metrics averaged over the ranks (JAX's `pmean` of metrics)."""
    if dp is None or not metrics:
        return metrics
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat, group=dp.group)
    flat.div_(dp.size)
    return dict(zip(keys, flat.unbind()))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(dp: Optional[DataParallel], x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable: the backward sums the
    incoming gradient over the ranks too (JAX's `psum` and its transpose
    under `shard_map(check_vma=False)`)."""
    if dp is None:
        return x
    return _AllReduceSum.apply(x, dp.group)


def all_reduce_max(dp: Optional[DataParallel], x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of `x` over the ranks (JAX's `pmax`);
    without autograd."""
    if dp is None:
        return x
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=dp.group)
    return y
