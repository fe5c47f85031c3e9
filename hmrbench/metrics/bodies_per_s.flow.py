"""Bodies (image x sample) whose outputs reached host memory in the
measured window, over the window's seconds: the stage-1 cell's throughput.
It is host-bound and spreads 12-19% between runs of one call, too wide
for any bound, so the cell reports its peak memory and set-up end to end
and `MOVES` names the one of them that is not `setup_s`."""
MOVES = "memory_peak_mib"
UNIT = "bodies/s"


def read(r):
    if not r.window.get("seconds"):
        return None
    return r.window["bodies"] / r.window["seconds"]
