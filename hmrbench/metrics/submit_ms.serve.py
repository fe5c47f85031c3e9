"""Mean host time of `Predictor.submit` over the measured window of a
traced run: the request's NumPy batch to the card, x_T drawn, the replay
queued and the readback queued. Read from the benchmark's own span around
each call."""
MOVES = "bodies_per_s"
UNIT = "ms"


def read(r):
    s = r.spans.get("submit")
    return 1e3 * sum(s) / len(s) if s else None
