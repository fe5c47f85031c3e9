"""The share of the traced stretch in which no kernel, copy or memset ran
on the card."""
MOVES = "bodies_per_s"
UNIT = "%"


def read(r):
    t = r.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
