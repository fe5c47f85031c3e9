"""Mean device ms per request from the program's `smpl` phase marker to its
`end` marker (egohmr_tpu_torch/utils/profiling.py:mark, inside the replayed
CUDA graph) in the traced stretch: SMPL, the reprojection and the packing of
the outputs."""
from hmrbench.lib.program_spans import phase_ms

MOVES = "bodies_per_s"
UNIT = "ms"


def read(r):
    return phase_ms(r, "smpl")
