"""Mean device ms per request inside the guided steps' guidance: from each
`guide` mark to its `guide_end` (egohmr_tpu_torch/utils/profiling.py:mark,
inside the replayed CUDA graph), summed over a request's guided steps, in
the traced stretch. The mesh SDF's step (SMPL, the caps, kernel K2, the
selected vertices' backward) or the learned field's forward and backward
over the scene."""
from hmrbench.lib.guide_marks import guide_seconds

MOVES = "bodies_per_s"
UNIT = "ms"


def read(r):
    s = guide_seconds(r)
    return None if s is None else 1e3 * s
