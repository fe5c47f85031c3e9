"""The device check that the command-line entry points share."""
from __future__ import annotations

import torch


def resolve_device(name: str, data_parallel: bool = False) -> torch.device:
    """`--device` as a `torch.device`. A CUDA device must exist: nothing
    falls back to the CPU. `--data_parallel` is a no-op on one device, as
    in the JAX package; over several visible cards it is refused until the
    data-parallel path is ported."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available; pass "
                           "--device cpu to run on the CPU")
    if data_parallel and device.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "--data_parallel over several devices is not ported yet (ROADMAP "
            "queue 1, multi-device): pass --data_parallel false, or show the process one "
            "device")
    return device
