"""Mean device ms per request from the program's `image` phase marker to its
`scene` marker (egohmr_tpu_torch/utils/profiling.py:mark, inside the
replayed CUDA graph) in the traced stretch: the image's bf16 cast and
ResNet-50."""
from hmrbench.lib.program_spans import phase_ms

MOVES = "bodies_per_s"
UNIT = "ms"


def read(r):
    return phase_ms(r, "image")
