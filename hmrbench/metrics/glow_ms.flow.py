"""Mean host ms per batch of the program's `prohmr.glow` span in the traced
stretch (egohmr_tpu_torch/models/prohmr.py:forward: z drawn, the Glow
flow's sample and log-probability). `MOVES` as in `condition_ms.flow`."""
from hmrbench.lib.program_spans import host_ms

MOVES = "memory_peak_mib"
UNIT = "ms"


def read(r):
    return host_ms(r, "prohmr.glow")
