"""Mean host ms per request of the program's `serve.launch` span in the traced
stretch (egohmr_tpu_torch/serving.py:Predictor._submit, `_run`): x_T and
the steps' noise drawn, the batch copied into the program's static inputs
and the graph launched."""
from hmrbench.lib.program_spans import host_ms

MOVES = "bodies_per_s"
UNIT = "ms"


def read(r):
    return host_ms(r, "serve.launch")
