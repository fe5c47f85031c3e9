"""What a stage-1 pass allocates on the card above what stays resident (the
weights and SMPL's tables): the measured window's peak of allocated tensor
memory less what was allocated when the window opened."""
MOVES = "memory_peak_mib"
UNIT = "MiB"


def read(r):
    peak = r.window.get("peak_bytes", 0)
    if peak <= 0:
        return None
    return (peak - r.window["resident_bytes"]) / 2 ** 20
