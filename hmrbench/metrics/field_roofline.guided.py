"""The learned collision field's share of the f32 peak of one H100 SXM (67
TFLOP/s on CUDA cores; the field runs in f32 with TF32 off): its
operations a request (counts/<config>.py, `field_flops`: the decoder's
forward and its input gradient over every row) over the device time of
the guide phases (`guide` to `guide_end`, which hold the field and the
little around it: the skeleton, the part codes, the joint scale). None
where the configuration counts no field or the program marks no guide
phase."""
from hmrbench.lib.guide_marks import guide_seconds

MOVES = "bodies_per_s"
UNIT = "%"
PEAK_F32 = 67e12


def read(r):
    flops = r.counts.get("field_flops")
    s = guide_seconds(r)
    if not flops or s is None or s <= 0:
        return None
    return 100.0 * flops / (s * PEAK_F32)
