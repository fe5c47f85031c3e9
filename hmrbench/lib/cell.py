"""What `run.py` hands a driver, and what a driver hands back."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .trace import Trace


@dataclass
class Ctx:
    """One run of one cell: the command line, the cell's files (read),
    the device, and the process's start on the host clock
    (`time.perf_counter`)."""

    seed: int
    seconds: float
    trace: bool
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    device: Any
    counts: Any        # the module counts/<config>.py
    reference: Any     # the module reference/<config>.py
    t_start: float


@dataclass
class Reading:
    """What the per-layer metrics read: the measured window's tallies,
    host-clock span durations recorded in it, the configuration's counts
    per request, and the traced sub-window (None in a run without a
    trace)."""

    window: Dict[str, float]
    spans: Dict[str, List[float]]
    counts: Dict[str, float]
    trace: Optional[Trace] = None


@dataclass
class Outcome:
    """A driver's result: end-to-end metrics {name: (value, unit)}, the
    window's attempted and failed units, the checks of `correct`, the
    fullest card's peak memory, and the reading for the per-layer
    metrics. `notes` go on an earlier line of standard error."""

    end_to_end: Dict[str, tuple]
    attempted: int
    failed: int
    checks: List[Dict]
    memory_peak_bytes: int
    reading: Reading
    notes: Dict[str, Any] = field(default_factory=dict)
