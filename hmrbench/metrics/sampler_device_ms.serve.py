"""Mean device ms per request from the program's `sampler` phase marker to its
`smpl` marker (egohmr_tpu_torch/utils/profiling.py:mark, inside the replayed
CUDA graph) in the traced stretch: the DDIM or DDPM loop over the GCN, both
classifier-free passes."""
from hmrbench.lib.program_spans import phase_ms

MOVES = "bodies_per_s"
UNIT = "ms"


def read(r):
    return phase_ms(r, "sampler")
