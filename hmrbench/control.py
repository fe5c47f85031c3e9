"""The control of a cell's comparison at the cell's own size: the plain
reference computed one precision below what the configuration states, put
in the program's place and compared as a run compares, on several seeds.
Its readings are the upper ends from which the limits in the cell's
workload file were set; a sound limit lies below every one of them.

    python3 hmrbench/control.py --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line per seed. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from hmrbench.lib import common  # noqa: E402
from hmrbench.lib.cell import Ctx  # noqa: E402


def readings(workload: str, seed: int, device, *, bench: Path = common.BENCH,
             overrides=None) -> dict:
    files = common.apply_overrides(common.cell_files(workload, bench), overrides)
    ctx = Ctx(seed=seed, seconds=0.0, trace=False, workload=files["workload"],
              config=files["config"], traffic=files["traffic"], device=device,
              counts=common.load_file(files["counts"]),
              reference=common.load_file(files["reference"]), t_start=time.perf_counter())
    return common.load_file(files["driver"]).control(ctx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hmrbench/control.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        common.log("error: no CUDA device")
        return 1
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(args.workload, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": r,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    common.log("card: " + common.card_name_and_limit())
    return 0


if __name__ == "__main__":
    sys.exit(main())
