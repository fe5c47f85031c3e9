"""The whole request's model FLOPs (counts/<config>.py), times the requests
completed in the measured window, over the window's seconds and the bf16
dense peak of one H100 SXM (989 TFLOP/s, at the card's power limit)."""
MOVES = "bodies_per_s"
UNIT = "%"
PEAK = 989e12


def read(r):
    if not r.window.get("units"):
        return None
    return 100.0 * r.counts["flops"] * r.window["units"] / (r.window["seconds"] * PEAK)
