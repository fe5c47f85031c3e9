"""Mean host ms per request of the program's `serve.wait` span in the traced
stretch (egohmr_tpu_torch/serving.py:Predictor.result): the host blocked
on the request's readback event, waiting for the card."""
from hmrbench.lib.program_spans import host_ms

MOVES = "bodies_per_s"
UNIT = "ms"


def read(r):
    return host_ms(r, "serve.wait")
