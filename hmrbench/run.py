"""The benchmark of egohmr_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 hmrbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port. The cell's files are
found by name: `workloads/<cell>.json` names its driver
(`drivers/<driver>.py`), its configuration (`configs/<config>.json`, with
`counts/<config>.py` and `reference/<config>.py`) and its traffic mix
(`traffic/<traffic>.json`). With `--trace 0` the last line of standard
output holds the cell's end-to-end metrics; with `--trace 1` the
per-layer metrics that the files under `metrics/` read from a traced
stretch of the cell's own loop. Either way the run checks that what the
timed path produced is correct against the plain reference, and prints
each compared number beside its limit as the last lines of standard error
and under `checks` in the result. Without a CUDA device, or with fewer
devices than the cell asks for, it exits 1 and prints no result.
"""
from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()


def _process_start() -> float:
    """The process's start on the `time.perf_counter` clock (Linux: from
    /proc; elsewhere the moment this file began to run)."""
    try:
        import os

        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from hmrbench.lib import common  # noqa: E402
from hmrbench.lib.common import BenchError, log  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(prog="hmrbench/run.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def per_layer(reading, outcome_metrics, bench: Path) -> dict:
    """Every metric under metrics/ whose end-to-end metric this cell
    reports, read from `reading`; a reader that finds nothing to read
    returns None and its metric is left out."""
    out = {}
    for path in sorted((bench / "metrics").glob("*.py")):
        mod = common.load_file(path)
        if mod.MOVES not in outcome_metrics:
            continue
        value = mod.read(reading)
        if value is not None:
            out[path.stem] = common.metric(value, mod.UNIT)
    return out


def run(args, *, device=None, bench: Path = common.BENCH, overrides=None,
        t_start: float = T_START) -> dict:
    """One run of a cell; returns the result line's object. `device`,
    `bench` (another copy of this folder) and `overrides` (merged into the
    cell's files by `common.apply_overrides`) are for the CPU tests; a run
    from the command line finds the card itself."""
    import torch

    from hmrbench.lib.cell import Ctx

    files = common.cell_files(args.workload, bench)
    chips = int(files["workload"].get("chips", 1))
    if device is None:
        if not torch.cuda.is_available():
            raise BenchError("no CUDA device: torch.cuda.is_available() is False")
        if torch.cuda.device_count() < chips:
            raise BenchError(f"the cell asks for {chips} devices, "
                             f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    files = common.apply_overrides(files, overrides)
    ctx = Ctx(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              workload=files["workload"], config=files["config"], traffic=files["traffic"],
              device=device,
              counts=common.load_file(files["counts"]),
              reference=common.load_file(files["reference"]), t_start=t_start)
    driver = common.load_file(files["driver"])
    outcome = driver.run(ctx)

    # the end-to-end metrics the cell reports: those its workload file
    # names, of the driver's
    reported = {k: vu for k, vu in outcome.end_to_end.items()
                if k in files["workload"].get("end_to_end", outcome.end_to_end)}
    if args.trace:
        metrics = per_layer(outcome.reading, set(reported), bench)
    else:
        metrics = {k: common.metric(v, u) for k, (v, u) in reported.items()}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    result = {"correct": all(c["ok"] for c in outcome.checks),
              "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics, "device": dev}
    t = outcome.reading.trace
    if args.trace and t is not None:
        dev.update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = t.breakdown()
    log("notes: " + json.dumps(outcome.notes))
    if device.type == "cuda":
        log("card: " + common.card_name_and_limit())
    result["checks"] = common.checks_block(outcome.checks)
    # last before the result is printed: whatever the run and the metric
    # readers loaded is in sys.modules by now
    found = common.forbidden_modules()
    if found:
        raise BenchError(f"JAX or the JAX package is loaded in this process: {found}")
    common.print_checks(outcome.checks)
    return result


def main(argv=None) -> int:
    args = parse(argv)
    common.env_caches()
    try:
        result = run(args)
    except BenchError as e:
        log(f"error: {e}")
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
