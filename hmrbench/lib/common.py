"""What every cell of the benchmark shares: finding a cell's files by name,
loading a file as a module, the device checks, the guard against JAX in the
process, and the result line."""
from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

BENCH = Path(__file__).resolve().parents[1]  # hmrbench/
ROOT = BENCH.parent                           # the checkout
# top-level module names that no process of the benchmark may hold: JAX and
# the JAX package (a prefix test would also match the port, egohmr_tpu_torch)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "egohmr_tpu")
# the port: the reference may not import it
PROGRAM_MODULE = "egohmr_tpu_torch"


class BenchError(RuntimeError):
    """A run that cannot produce a result: the process exits non-zero."""


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell_files(workload: str, bench: Path = BENCH) -> Dict[str, Any]:
    """The files a cell is made of, found by name: `workloads/<cell>.json`
    names its driver, configuration and traffic mix."""
    wpath = bench / "workloads" / f"{workload}.json"
    if not wpath.exists():
        raise BenchError(f"no workload file {wpath.relative_to(bench.parent)}")
    w = read_json(wpath)
    w.setdefault("name", workload)
    return {
        "workload": w,
        "config": read_json(bench / "configs" / f"{w['config']}.json"),
        "traffic": read_json(bench / "traffic" / f"{w['traffic']}.json"),
        "driver": bench / "drivers" / f"{w['driver']}.py",
        "counts": bench / "counts" / f"{w['config']}.py",
        "reference": bench / "reference" / f"{w['config']}.py",
    }


def apply_overrides(files: Dict[str, Any], overrides: Optional[Dict]) -> Dict[str, Any]:
    """The cell's files with `overrides` merged in (the CPU tests' tiny
    widths): a key naming a group of the configuration or the workload's
    "program" or "check" is merged into it, any other key into the
    traffic."""
    files = dict(files)
    for key, value in (overrides or {}).items():
        if isinstance(files["config"].get(key), dict):
            files["config"] = dict(files["config"], **{key: dict(files["config"][key], **value)})
        elif key in ("program", "check"):
            files["workload"] = dict(files["workload"],
                                     **{key: dict(files["workload"][key], **value)})
        else:
            files["traffic"] = dict(files["traffic"], **{key: value})
    return files


def load_file(path: Path):
    """Import the Python file `path` as a module, once per path (file names
    of the benchmark may hold '-' and '.', which `import` cannot spell)."""
    path = Path(path).resolve()
    name = "hmrbench_file_" + "".join(c if c.isalnum() else "_" for c in str(path))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise BenchError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def forbidden_modules(modules: Optional[Sequence[str]] = None) -> List[str]:
    """Top-level names in `sys.modules` (or `modules`) that are JAX or the
    JAX package, compared whole: the part before the first dot."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(tops & set(FORBIDDEN_MODULES))


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def card_name_and_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for card 0, or '' without it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def quantile(values: Sequence[float], q: float) -> float:
    """The q-quantile of `values` by linear interpolation between order
    statistics (numpy's default), over every value given."""
    xs = sorted(values)
    if not xs:
        raise BenchError("a quantile of no values")
    pos = (len(xs) - 1) * q
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def metric(value: float, unit: str) -> Dict[str, Any]:
    if value is None or not math.isfinite(value):
        raise BenchError(f"metric value {value!r} is not a finite number")
    return {"value": float(value), "unit": unit}


def checks_block(checks: Sequence[Dict]) -> Dict[str, Dict]:
    """The compared numbers, each with its limit, under short names."""
    return {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}


def print_checks(checks: Sequence[Dict]) -> None:
    """The compared numbers beside their limits, as the last lines on
    standard error."""
    for c in checks:
        verdict = "ok" if c["ok"] else "FAIL"
        print(f"check {c['name']}: {c['value']!r} <= {c['limit']!r} {verdict}",
              file=sys.stderr, flush=True)


def host_counters() -> Dict[str, float]:
    """This thread's and this process's CPU seconds: where a host-bound
    window's wall time went."""
    import time

    return {"thread_cpu_s": time.thread_time(), "process_cpu_s": time.process_time()}


def host_counters_since(before: Dict[str, float]) -> Dict[str, float]:
    """What `host_counters` counted since `before`."""
    now = host_counters()
    return {k: now[k] - v for k, v in before.items() if k in now}


def env_caches(root: Path = ROOT) -> None:
    """Keep the caches that PyTorch's extension builder and Triton would
    write inside the checkout, at fixed paths. The port's own kernels build
    into egohmr_tpu_torch/_build/, also inside the checkout."""
    cache = root / ".hmrbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
