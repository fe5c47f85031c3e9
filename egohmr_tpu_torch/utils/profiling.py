"""Profiling (port of egohmr_tpu/utils/profiling.py): `trace()` records a
`torch.profiler` trace of the CPU and, when there is one, the CUDA device,
and `PhaseTimer` sums host time per phase, waiting for the device where a
phase ends."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional, Union

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    """Profile the block and write `<logdir>/trace.json` (Chrome / Perfetto
    format); a no-op yielding None when `logdir` is empty."""
    if not logdir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


Syncable = Union[torch.Tensor, torch.device, str, None]


def synchronize(sync: Syncable) -> None:
    """Wait for the work queued on the device of `sync` (a tensor or a
    device); nothing to wait for on the CPU."""
    if sync is None:
        return
    device = sync.device if isinstance(sync, torch.Tensor) else torch.device(sync)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Mean host time per named phase. With `sync`, a phase ends only when
    the work it queued on that tensor's or device's stream has run."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: Syncable = None) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        synchronize(sync)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {name: self.totals[name] / max(self.counts[name], 1) for name in self.totals}
