"""Profiling (port of egohmr_tpu/utils/profiling.py) and the program's own
spans and device phase markers.

  * `trace()` records a `torch.profiler` trace of the CPU and, when there
    is one, the CUDA device;
  * `span(name)` is a host span of the program, live only while a
    `torch.profiler` session records: a range on the trace's timeline and
    a record in a bounded store in memory (`recorded()`, `clear()`);
  * `mark(phase, like)` queues an empty kernel named for a request's phase
    or for a mark inside one (`csrc/markers.cu`), so the device's timeline
    shows where each begins, inside a replayed CUDA graph too;
  * `host_launches` and `device_kernels` sum a session's host launch calls
    and device kernels.
"""
from __future__ import annotations

import contextlib
import ctypes
import itertools
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Iterator, List, Optional

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


SPAN_PREFIX = "egohmr."
STORE_SPANS = 65536  # the store keeps the newest spans, this many at most


@dataclass
class Span:
    """One span entered while a profiler recorded: its place in the order
    spans were entered (`index`), its name, the `index` of the span it was
    entered in (None at the top), its request (its own, else its
    parent's; None outside a request), and its start and end on
    `time.perf_counter_ns` (`end_ns` None while it is open)."""

    index: int
    name: str
    parent: Optional[int]
    request: Optional[int]
    start_ns: int
    end_ns: Optional[int] = None


_store: Deque[Span] = deque(maxlen=STORE_SPANS)
_indices = itertools.count()
_open = threading.local()  # each thread's stack of open spans
_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _Recording:
    __slots__ = ("name", "request", "span", "range")

    def __init__(self, name: str, request: Optional[int]):
        self.name, self.request = name, request

    def __enter__(self) -> Span:
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent = stack[-1] if stack else None
        request = self.request
        if request is None and parent is not None:
            request = parent.request
        self.range = torch.profiler.record_function(SPAN_PREFIX + self.name)
        self.range.__enter__()
        self.span = Span(next(_indices), self.name, parent.index if parent else None, request,
                         time.perf_counter_ns())
        _store.append(self.span)
        stack.append(self.span)
        return self.span

    def __exit__(self, *exc) -> None:
        self.span.end_ns = time.perf_counter_ns()
        _open.stack.pop()
        self.range.__exit__(*exc)


def span(name: str, request: Optional[int] = None):
    """A host span of the program, entered with `with`. While a
    `torch.profiler` session records it is a `record_function` range named
    `egohmr.<name>` on the trace's timeline, beside the device's kernels,
    and a `Span` in the store (`recorded()`), with `request` (or its
    parent's); otherwise it returns after that one check and records
    nothing."""
    if not _profiling():
        return _OFF
    return _Recording(name, request)


def recorded() -> List[Span]:
    """The spans in the store, in the order they were entered."""
    return list(_store)


def clear() -> None:
    """Empty the store."""
    _store.clear()


# The phases of a stage-2 request on the device, in order; `mark(phase)`
# queues the empty kernel `MARKER_PREFIX + phase` (csrc/markers.cu), so a
# phase runs from its marker to the next one
PHASES = ("image", "scene", "sampler", "smpl", "end")
MARKER_PREFIX = "egohmr_phase_"
# marks inside the sampler phase, around each guided step's guidance (its
# gradient, `eval/pipeline.py:sample_bodies`): `mark("guide")` queues
# `STEP_MARKER_PREFIX + "guide"`. They are named apart from the phases, so
# a reader of the five phases in order passes over them
STEP_MARKS = ("guide", "guide_end")
STEP_MARKER_PREFIX = "egohmr_step_"
_phase_index = {p: i for i, p in enumerate(PHASES + STEP_MARKS)}
_markers = None
_marking = 0


def _load_markers():
    global _markers
    if _markers is None:
        from .. import _build

        lib = _build.load("markers")
        lib.egohmr_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.egohmr_mark.restype = ctypes.c_int
        lib.egohmr_mark_error_string.argtypes = [ctypes.c_int]
        lib.egohmr_mark_error_string.restype = ctypes.c_char_p
        _markers = lib
    return _markers


@contextlib.contextmanager
def marking() -> Iterator[None]:
    """`mark` launches inside this block, profiler or not: the warm-up runs
    of `utils/graphs.py:CapturedProgram`, so that the markers' library is
    built and its kernels loaded before a capture."""
    global _marking
    _marking += 1
    try:
        yield
    finally:
        _marking -= 1


def mark(phase: str, like: torch.Tensor) -> None:
    """Queue the empty kernel `egohmr_phase_<phase>` (`egohmr_step_<phase>`
    for the `STEP_MARKS`) on the current stream of `like`'s device: the
    device's timeline then shows where `phase` begins. It launches while that stream captures a CUDA graph (every
    replay then carries it), inside `marking()`, and while a profiler
    records; otherwise, and on the CPU, it does nothing."""
    index = _phase_index.get(phase)
    if index is None:
        raise ValueError(f"unknown phase {phase!r}; the phases are {PHASES}, the marks "
                         f"inside one {STEP_MARKS}")
    dev = like.device
    if dev.type != "cuda":
        return
    if not (_marking or _profiling() or torch.cuda.is_current_stream_capturing()):
        return
    lib = _load_markers()
    with torch.cuda.device(dev):
        code = lib.egohmr_mark(index, torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"marker {phase!r}: CUDA error {code} "
                           f"({lib.egohmr_mark_error_string(code).decode()})")


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
