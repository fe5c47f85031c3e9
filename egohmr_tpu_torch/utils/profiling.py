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


# the host's CUDA API calls that put work on a stream, by kind, as
# `torch.profiler` names them
HOST_LAUNCH_CALLS = {
    "graph_launches": ("cudaGraphLaunch", "cuGraphLaunch"),
    "kernel_launches": ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                        "cuLaunchKernelEx", "cudaLaunchCooperativeKernel"),
    "copies": ("cudaMemcpyAsync", "cudaMemcpy", "cudaMemsetAsync", "cudaMemset",
               "cudaMemcpy2DAsync", "cuMemcpyAsync", "cuMemsetD32Async"),
}


def host_launches(prof: torch.profiler.profile) -> Dict[str, int]:
    """How many times the host called each kind of `HOST_LAUNCH_CALLS` in a
    `torch.profiler` session, and their total. A replayed CUDA graph is one
    graph launch for all the kernels inside it; the device kernels the
    profiler records are counted apart, from its device events."""
    counts = {kind: 0 for kind in HOST_LAUNCH_CALLS}
    for e in prof.key_averages():
        for kind, names in HOST_LAUNCH_CALLS.items():
            if e.key in names:
                counts[kind] += e.count
    counts["total"] = sum(counts.values())
    return counts


def device_kernels(prof: torch.profiler.profile) -> Dict[str, float]:
    """The device's work in a `torch.profiler` session: the number of
    kernels and copies it ran (`count`), inside graphs too, and their
    summed time (`ms`)."""
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"count": sum(e.count for e in events),
            "ms": sum(e.self_device_time_total for e in events) / 1e3}
