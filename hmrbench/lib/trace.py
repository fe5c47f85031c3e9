"""The traced sub-window: `torch.profiler` over a short steady stretch of a
cell's own loop, reduced to what the per-layer metrics read.

The trace goes to a file in the temporary directory (TMPDIR), is read back
and deleted. Host spans are the benchmark's own `record_function` ranges,
named `hmrbench.<span>`; device work is every kernel, copy and memset the
profiler records, those inside replayed CUDA graphs included.

The host-call sums follow egohmr_tpu_torch/utils/profiling.py:host_launches
and device_kernels, read here from the trace's events.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Tuple

import torch

SPAN_PREFIX = "hmrbench."
# the host's CUDA API calls that put work on a stream, by kind, as
# torch.profiler names them (copied from the port's utils/profiling.py)
HOST_LAUNCH_CALLS = {
    "graph_launches": ("cudaGraphLaunch", "cuGraphLaunch"),
    "kernel_launches": ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                        "cuLaunchKernelEx", "cudaLaunchCooperativeKernel"),
    "copies": ("cudaMemcpyAsync", "cudaMemcpy", "cudaMemsetAsync", "cudaMemset",
               "cudaMemcpy2DAsync", "cuMemcpyAsync", "cuMemsetD32Async"),
}
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 120  # device op names are cut to this length in the breakdown


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """A host span of the benchmark's own code, visible in a trace."""
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


@dataclass
class Trace:
    """A traced sub-window, reduced. Times in seconds; `ops` are the
    device's (name, start, duration); `spans` the host's (name, start,
    duration); `host_calls` the launch calls by kind, with their total."""

    start_s: float
    window_s: float
    busy_s: float
    ops: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]
    host_calls: Dict[str, int]
    units: int                     # requests or steps inside the sub-window
    counters: Dict[str, float] = field(default_factory=dict)

    def device_seconds(self, names: Tuple[str, ...]) -> float:
        """Summed device time of the ops whose name holds one of `names`."""
        return sum(d for n, _, d in self.ops if any(k in n for k in names))

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        by_name: Dict[str, float] = {}
        for n, _, d in self.ops:
            key = n[:NAME_CHARS]
            by_name[key] = by_name.get(key, 0.0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps()[:top]]}

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """The stretches of the window with no device op, longest first,
        each named by the innermost benchmark span open on the host when
        it began ('-' where none was)."""
        t0 = self.start_s
        end = t0 + self.window_s
        gaps, cursor = [], t0
        for _, s, d in sorted(self.ops, key=lambda o: o[1]):
            if s > cursor:
                gaps.append((cursor, s - cursor))
            cursor = max(cursor, s + d)
        if end > cursor:
            gaps.append((cursor, end - cursor))
        named = []
        for start, length in gaps:
            open_spans = [(s, n) for n, s, d in self.spans
                          if s <= start < s + d and n != "window"]
            named.append((max(open_spans)[1] if open_spans else "-", length))
        return sorted(named, key=lambda g: -g[1])


def _union(intervals: List[Tuple[float, float]], lo: float, hi: float) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def reduce_events(events: List[Dict], units: int) -> Trace:
    """The Chrome-trace events of one profiled sub-window -> `Trace`. The
    window is the host span `hmrbench.window` that the caller opened."""
    ops, spans = [], []
    calls = {kind: 0 for kind in HOST_LAUNCH_CALLS}
    win = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)) * 1e-6, float(e.get("dur", 0.0)) * 1e-6
        if cat in DEVICE_CATEGORIES:
            ops.append((name, ts, dur))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            short = name[len(SPAN_PREFIX):]
            spans.append((short, ts, dur))
            if short == "window":
                win = (ts, ts + dur)
        elif cat in ("cuda_runtime", "cuda_driver"):
            for kind, names in HOST_LAUNCH_CALLS.items():
                if name in names:
                    calls[kind] += 1
    if win is None:
        raise RuntimeError("the trace holds no hmrbench.window span")
    ops = [o for o in ops if o[1] < win[1] and o[1] + o[2] > win[0]]
    busy = _union([(s, s + d) for _, s, d in ops], *win)
    calls["total"] = sum(calls.values())
    return Trace(start_s=win[0], window_s=win[1] - win[0], busy_s=busy, ops=ops, spans=spans,
                 host_calls=calls, units=units)


def profile(run: Callable[[], int]) -> Trace:
    """Profile `run()` (which returns how many requests or steps it made)
    on the host and the card, inside a `hmrbench.window` span that ends
    once the card is idle; the trace file is written to the temporary
    directory, read and deleted."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with span("window"):
            units = run()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="hmrbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return reduce_events(events, units)


class Stopwatch:
    """Host-clock durations of one named stretch, kept in memory."""

    def __init__(self):
        self.seconds: List[float] = []

    @contextlib.contextmanager
    def time(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds.append(time.perf_counter() - t0)
