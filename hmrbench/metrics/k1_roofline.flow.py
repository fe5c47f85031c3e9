"""`k1_roofline.serve`'s reading in the stage-1 cell (`prohmr-flow`). That cell
reports its peak memory and set-up end to end, since its host-bound
throughput spreads too widely between runs to hold a bound, so `MOVES`
names the one of them that is not `setup_s`."""
from pathlib import Path

from hmrbench.lib.common import load_file

MOVES = "memory_peak_mib"
UNIT = "%"
read = load_file(Path(__file__).with_name("k1_roofline.serve.py")).read
