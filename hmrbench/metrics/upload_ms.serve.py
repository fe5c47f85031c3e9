"""Mean host ms per request of the program's `serve.upload` span in the traced
stretch (egohmr_tpu_torch/serving.py:Predictor._submit): the request's
NumPy batch made tensors, copied into pinned memory, its copy to the card
queued, and the padding of a short batch."""
from hmrbench.lib.program_spans import host_ms

MOVES = "bodies_per_s"
UNIT = "ms"


def read(r):
    return host_ms(r, "serve.upload")
