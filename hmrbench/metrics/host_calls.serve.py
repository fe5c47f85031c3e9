"""The host's launch calls per request in the traced stretch: kernel
launches, graph launches and copies or memsets, as the profiler records
the CUDA runtime and driver calls."""
MOVES = "bodies_per_s"
UNIT = "calls"


def read(r):
    t = r.trace
    if t is None or not t.units:
        return None
    return t.host_calls["total"] / t.units
