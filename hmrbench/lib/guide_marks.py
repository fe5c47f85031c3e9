"""What the guided cells' per-layer metrics read of the program's marks
around each guided step's guidance (egohmr_tpu_torch/utils/profiling.py:
mark, "guide" and "guide_end"): empty kernels named `egohmr_step_guide`
and `egohmr_step_guide_end` on the device's timeline, inside the replayed
CUDA graph. A program without them gives None."""
from __future__ import annotations

from typing import List, Optional, Tuple

GUIDE, GUIDE_END = "egohmr_step_guide", "egohmr_step_guide_end"


def guide_spans(trace) -> List[Tuple[float, float]]:
    """(start, end) on the device, in seconds, of every guide phase: each
    `guide` mark paired with the next `guide_end`; a mark left unpaired
    counts for nothing."""
    marks = sorted((s, n.split("(")[0]) for n, s, _ in trace.ops
                   if n.startswith(GUIDE))
    out, start = [], None
    for s, name in marks:
        if name == GUIDE:
            start = s
        elif name == GUIDE_END and start is not None:
            out.append((start, s))
            start = None
    return out


def guide_seconds(r) -> Optional[float]:
    """Device seconds per request inside the guide phases of the traced
    stretch; None without a trace or marks."""
    t = r.trace
    if t is None or not t.units:
        return None
    spans = guide_spans(t)
    if not spans:
        return None
    return sum(e - s for s, e in spans) / t.units
