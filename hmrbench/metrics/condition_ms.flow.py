"""Mean host ms per batch of the program's `prohmr.condition` span in the
traced stretch (egohmr_tpu_torch/models/prohmr.py:forward,
`conditioning_feats`: ResNet-50, K1, the camera features). The stage-1
cell reports its peak memory and set-up end to end, since its host-bound
throughput spreads too widely between runs to hold a bound, so `MOVES`
names the one of them that is not `setup_s`."""
from hmrbench.lib.program_spans import host_ms

MOVES = "memory_peak_mib"
UNIT = "ms"


def read(r):
    return host_ms(r, "prohmr.condition")
