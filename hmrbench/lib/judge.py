"""The comparison that decides `correct`: the numbers taken from a
program's outputs against the reference's, each held to its limit."""
from __future__ import annotations

import math
from typing import Dict, List, Mapping

import numpy as np


def gaps(prog: Mapping[str, np.ndarray], ref: Mapping[str, np.ndarray],
         keys, prefix: str = "") -> Dict[str, float]:
    """Per output key: `<prefix><key>.max`, the widest absolute gap, and
    `<prefix><key>.rel`, the norm of the gap over the reference's norm;
    non-finite output reads as infinity."""
    out = {}
    for key in keys:
        k = prefix + key
        a = np.asarray(prog[key], np.float64).reshape(-1)
        b = np.asarray(ref[key], np.float64).reshape(-1)
        if a.shape != b.shape:
            raise ValueError(f"{k}: program {a.shape} against reference {b.shape}")
        if not np.all(np.isfinite(a)):
            out[f"{k}.max"] = out[f"{k}.rel"] = math.inf
            continue
        d = np.abs(a - b)
        out[f"{k}.max"] = float(d.max()) if d.size else 0.0
        out[f"{k}.rel"] = float(np.linalg.norm(d) / max(np.linalg.norm(b), 1e-30))
    return out


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over several compared units."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def held(readings: Mapping[str, float], limits: Mapping[str, float]) -> List[Dict]:
    """One check per limited number: its reading, its limit, and whether the
    reading is within it. A number without a reading fails."""
    checks = []
    for name, limit in limits.items():
        value = readings.get(name, math.inf)
        ok = value is not None and math.isfinite(value) and value <= limit
        checks.append({"name": name, "value": value, "limit": limit, "ok": bool(ok)})
    return checks
