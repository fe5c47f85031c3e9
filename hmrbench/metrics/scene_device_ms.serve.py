"""Mean device ms per request from the program's `scene` phase marker to its
`sampler` marker (egohmr_tpu_torch/utils/profiling.py:mark, inside the
replayed CUDA graph) in the traced stretch: the visibility and camera
features, K1, the translation encoder, the condition's assembly, the betas
head and the GCN's conditioning half."""
from hmrbench.lib.program_spans import phase_ms

MOVES = "bodies_per_s"
UNIT = "ms"


def read(r):
    return phase_ms(r, "scene")
