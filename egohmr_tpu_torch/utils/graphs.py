"""A function of tensors run as one captured CUDA graph per input shape:
the port's counterpart of `jax.jit`, which compiles one program per shape
of its arguments.

`CapturedProgram(fn)(*args, **kwargs)` on CUDA tensors:

  * looks up the program of the arguments' signature: the tree's structure
    and, per tensor, its shape, dtype and device; any other leaf (an int,
    a string) by value, as a static argument of `jax.jit`;
  * on a signature it has not seen, copies the arguments into static
    input buffers, runs `fn` eagerly on a side stream (the first run builds
    the kernels, lets cuDNN pick its algorithms, prepares K1's weights and
    fills the cached device constants; the second runs under
    `torch.cuda.set_sync_debug_mode("error")`, which raises on any hidden
    host synchronisation, something a graph cannot hold) and then captures
    one more run into a private memory pool;
  * copies the arguments into the static buffers and replays the graph,
    on the current stream. The result is the graph's static output: the
    next call overwrites it, so a caller that keeps it copies it first
    (stream order makes a copy queued before the next call safe).

A replay calls no Python wrapper, so a kernel's wrapper counts its launch
through `count_launch`: one more at once, or, while a program captures,
one more on every replay of that program (a captured launch runs only when
the graph is replayed). The warm-up runs launch for real and count.

On CPU tensors the program is `fn` itself. `program.eager(*args)` is `fn`
on any device: the comparisons of replay against eager and the callers'
recording of kernel calls use it. On a CUDA device a capture that fails
raises; nothing falls back to eager.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from .profiling import marking

WARMUP_RUNS = 2  # eager runs before the capture; the last one checks for syncs
# only the capturing thread is held to the capture's rules. The work that
# other threads queue on the capturing stream is captured all the same (the
# guided steps' backward, on the autograd engine's thread); what they do
# elsewhere (a profiler's flush) cannot break the capture. Under "global" a
# guided DDPM-50 capture failed once on the card
CAPTURE_ERROR_MODE = "thread_local"

# one tally per capture in progress: {(id of counter, attribute): [counter,
# attribute, launches per replay]}
_capturing: List[Dict[Tuple[int, str], list]] = []


def count_launch(counter: Any, attr: str = "launches", n: int = 1) -> None:
    """Called by a kernel's wrapper where it launches its kernel: `n` more
    (one launch by default) on `counter.attr`, or, while a
    `CapturedProgram` captures, `n` more on every replay of that program.
    A program's counters of its own work (`Predictor.field_rows`) count
    the same way."""
    if _capturing:
        _capturing[-1].setdefault((id(counter), attr), [counter, attr, 0])[2] += n
    else:
        setattr(counter, attr, getattr(counter, attr) + n)


def _flatten(tree: Any, leaves: List[torch.Tensor]) -> Any:
    """The tree's signature; its tensors appended to `leaves` in order."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return ("dict", tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_flatten(v, leaves) for v in tree))
    return ("static", tree)


def _rebuild(sig: Any, tensors) -> Any:
    """The tree of signature `sig` with its tensors drawn from the iterator
    `tensors`."""
    kind, body = sig[0], sig[1]
    if kind == "tensor":
        return next(tensors)
    if kind == "dict":
        return {k: _rebuild(s, tensors) for k, s in body}
    if kind in ("list", "tuple"):
        items = [_rebuild(s, tensors) for s in body]
        return items if kind == "list" else tuple(items)
    return body


class Capture(NamedTuple):
    """One captured program: its static inputs and outputs, `replay` (queues
    the graph on the current stream), the launches its capture counted
    ((counter, attribute, launches per replay)), the seconds the capture took and the bytes its pool reserved."""

    inputs: List[torch.Tensor]
    outputs: Any
    replay: Callable[[], None]
    launches: Tuple[Tuple[Any, str, int], ...]
    seconds: float
    pool_bytes: int


def cuda_capture(run: Callable[[], Any],
                 device: torch.device) -> Tuple[Callable[[], None], Any, int]:
    """Capture `run()` into a `torch.cuda.CUDAGraph` with a private memory
    pool: (replay, the graph's outputs, the bytes the capture reserved)."""
    graph = torch.cuda.CUDAGraph()
    # no collection inside the capture (entering it collects): a finaliser
    # that frees another graph or an event there would break it
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode=CAPTURE_ERROR_MODE):
            # read inside: entering the capture empties the allocator's cache
            reserved = torch.cuda.memory_reserved(device)
            out = run()
    finally:
        if collecting:
            gc.enable()
    torch.cuda.synchronize(device)
    return graph.replay, out, torch.cuda.memory_reserved(device) - reserved


class CapturedProgram:
    """`fn(*args)` captured once per input signature and replayed (see the
    module's docstring). `name` goes into the error of a failed capture.
    `capture` (a seam for the tests; by default `cuda_capture`) takes a
    zero-argument run and the device, and returns (replay, outputs, pool
    bytes)."""

    def __init__(self, fn: Callable[..., Any], *, name: str = "",
                 capture: Optional[Callable] = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "program")
        self._capture = capture or cuda_capture
        self.programs: Dict[Any, Capture] = {}

    def eager(self, *args, **kwargs):
        """`fn(*args, **kwargs)`, without the graph."""
        return self.fn(*args, **kwargs)

    def __call__(self, *args, **kwargs):
        leaves: List[torch.Tensor] = []
        sig = _flatten((args, kwargs), leaves)
        devices = {t.device for t in leaves}
        if self._capture is cuda_capture and not any(d.type == "cuda" for d in devices):
            return self.fn(*args, **kwargs)
        prog = self.programs.get(sig)
        if prog is None:
            prog = self.programs[sig] = self._build(sig, leaves, devices)
        for dst, src in zip(prog.inputs, leaves):
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        prog.replay()
        for counter, attr, n in prog.launches:
            setattr(counter, attr, getattr(counter, attr) + n)
        return prog.outputs

    @property
    def capture_seconds(self) -> float:
        return sum(p.seconds for p in self.programs.values())

    @property
    def pool_bytes(self) -> int:
        return sum(p.pool_bytes for p in self.programs.values())

    def _build(self, sig, leaves: List[torch.Tensor], devices) -> Capture:
        if len(devices) != 1:
            raise ValueError(f"{self.name}: a captured program's tensors lie on one "
                             f"device, got {sorted(map(str, devices))}")
        (device,) = devices
        t0 = time.perf_counter()
        inputs = [t.detach().clone() for t in leaves]
        args, kwargs = _rebuild(sig, iter(inputs))
        cuda = device.type == "cuda"
        with (torch.cuda.device(device) if cuda else contextlib.nullcontext()):
            side = torch.cuda.Stream(device) if cuda else None
            if cuda:
                side.wait_stream(torch.cuda.current_stream(device))
            # the phase markers launch in the warm-up runs too, so their
            # library is loaded before the capture (utils/profiling.py:mark)
            with (torch.cuda.stream(side) if cuda else contextlib.nullcontext()), marking():
                for i in range(WARMUP_RUNS):
                    last = i == WARMUP_RUNS - 1
                    with _sync_debug_error() if cuda and last else contextlib.nullcontext():
                        try:
                            self.fn(*args, **kwargs)
                        except RuntimeError as e:
                            if last and cuda and "synchroniz" in str(e):
                                raise RuntimeError(
                                    f"{self.name}: the run before the capture synchronises "
                                    f"with the host, which a CUDA graph cannot hold: {e}") from e
                            raise
            if cuda:
                torch.cuda.current_stream(device).wait_stream(side)
            tally: Dict[Tuple[int, str], list] = {}
            _capturing.append(tally)
            try:
                replay, outputs, pool = self._capture(lambda: self.fn(*args, **kwargs), device)
            except RuntimeError as e:
                raise RuntimeError(f"{self.name}: capturing the program of "
                                   f"{_describe(sig)} failed: {e}") from e
            finally:
                _capturing.pop()
        return Capture(inputs, outputs, replay, tuple(map(tuple, tally.values())),
                       time.perf_counter() - t0, int(pool))


@contextlib.contextmanager
def _sync_debug_error():
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


def _describe(sig) -> str:
    """The tensors of a signature, for an error message."""
    parts: List[str] = []

    def walk(s, path):
        kind, body = s[0], s[1]
        if kind == "tensor":
            parts.append(f"{path or 'arg'} {list(body)} {str(s[2]).replace('torch.', '')}")
        elif kind == "dict":
            for k, v in body:
                walk(v, f"{path}.{k}" if path else str(k))
        elif kind in ("list", "tuple"):
            for i, v in enumerate(body):
                walk(v, f"{path}[{i}]")

    walk(sig, "")
    return ", ".join(parts) or "no tensors"
