"""Mean host ms per batch of the program's `prohmr.bodies` span in the traced
stretch (egohmr_tpu_torch/models/prohmr.py:forward: the fc head, SMPL and
the camera). `MOVES` as in `condition_ms.flow`."""
from hmrbench.lib.program_spans import host_ms

MOVES = "memory_peak_mib"
UNIT = "ms"


def read(r):
    return host_ms(r, "prohmr.bodies")
