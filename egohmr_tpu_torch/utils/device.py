"""The device check that the command-line entry points share."""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.mesh import DataParallel, init_data_parallel


def _world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def resolve_device(name: str, data_parallel: Optional[bool] = None,
                   entry: str = "") -> torch.device:
    """`--device` as a `torch.device`. A CUDA device must exist: nothing
    falls back to the CPU. Nothing runs 1-way in place of a data-parallel
    run either. Refused:

    * a torchrun world of several ranks without `--data_parallel true`
      (`data_parallel` None: the entry point has no such flag);
    * `--data_parallel true` over several visible cards without torchrun:
      one process drives one card, so the message gives the torchrun line
      for module `entry`. (The JAX package's CLIs use every visible device
      from one process.)"""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available; pass "
                           "--device cpu to run on the CPU")
    world = _world_size()
    if world > 1 and not data_parallel:
        raise ValueError(
            f"torchrun started {world} ranks, but "
            + ("--data_parallel is false: pass --data_parallel true, or run one process"
               if data_parallel is not None else
               "this entry point runs in one process on one device"))
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    if data_parallel and world == 1 and n > 1:
        raise RuntimeError(
            f"--data_parallel true over {n} visible cards needs one process per card: "
            f"torchrun --nproc_per_node={n} -m {entry or '<module>'} ... (or pass "
            "--data_parallel false, or show the process one card)")
    return device


def resolve_data_parallel(name: str, data_parallel: bool,
                          entry: str) -> Tuple[torch.device, Optional[DataParallel]]:
    """`resolve_device`, then the rank's data-parallel record under torchrun
    (None in a 1-way run), and the rank's device (`cuda` picks the card of
    the rank's local index)."""
    device = resolve_device(name, data_parallel, entry)
    dp = init_data_parallel(device) if data_parallel else None
    return (dp.device if dp is not None else device), dp
