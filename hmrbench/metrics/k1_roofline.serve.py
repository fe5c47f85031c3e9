"""Kernel K1's share of its roofline (egohmr_tpu_torch/nn/pointnet_fused.py
to csrc/pointnet_fused.cu, the whole scene PointNet): the least time of its
calls in the traced stretch (counts/<config>.py: the per-point products at
the bf16 peak, or its bytes at the memory rate, whichever is longer) over
the device time of the kernels named in KERNELS."""
MOVES = "bodies_per_s"
UNIT = "%"
KERNELS = ("stage_kernel", "context_kernel")


def read(r):
    t = r.trace
    if t is None:
        return None
    calls = t.counters.get("k1_calls", 0)
    spent = t.device_seconds(KERNELS)
    if not calls or spent <= 0:
        return None
    return 100.0 * r.counts["k1_bound_s"] * calls / spent
