"""What the per-layer metrics read of the program's own instrumentation
(egohmr_tpu_torch/utils/profiling.py): its host spans, which it keeps in a
store in memory while a profiler records, and its phase markers, empty
kernels named `egohmr_phase_<phase>` on the device's timeline, one at the
start of each phase of a stage-2 request and one at its end. A program
without them (an older checkout) gives None, and the metric is left out of
the line."""
from __future__ import annotations

from typing import Dict, List, Optional

MARKER_PREFIX = "egohmr_phase_"
PHASES = ("image", "scene", "sampler", "smpl", "end")


def host_ms(r, name: str) -> Optional[float]:
    """Mean host ms per unit (request or step) of the program's span `name`
    in the traced stretch: the last `units` spans of that name in the
    program's store. The program records only while a profiler does, and
    the traced stretch is the run's one profiled stretch, with one such
    span per unit. None without a trace, the store, or that many spans."""
    t = r.trace
    if t is None or not t.units:
        return None
    try:
        from egohmr_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    spans = [s for s in recorded() if s.name == name and s.end_ns is not None]
    if len(spans) < t.units:
        return None
    return sum(s.end_ns - s.start_ns for s in spans[-t.units:]) / t.units / 1e6


def request_phases(trace) -> List[Dict[str, float]]:
    """Per request, the device start (s) of each of its markers: every run
    of the five markers in order on the device's timeline; a run broken
    off counts for nothing."""
    marks = sorted((s, n[len(MARKER_PREFIX):].split("(")[0]) for n, s, _ in trace.ops
                   if n.startswith(MARKER_PREFIX))
    out: List[Dict[str, float]] = []
    cur: Dict[str, float] = {}
    for start, phase in marks:
        if phase == PHASES[0]:
            cur = {phase: start}
        elif cur and phase == PHASES[len(cur)]:
            cur[phase] = start
        else:
            cur = {}
        if len(cur) == len(PHASES):
            out.append(cur)
            cur = {}
    return out


def phase_ms(r, phase: str) -> Optional[float]:
    """Mean device ms per request from `phase`'s marker to the next one,
    over the requests whose five markers the traced stretch holds; None
    where it holds none."""
    if r.trace is None:
        return None
    runs = request_phases(r.trace)
    if not runs:
        return None
    following = PHASES[PHASES.index(phase) + 1]
    return 1e3 * sum(q[following] - q[phase] for q in runs) / len(runs)
