"""Time kernels K1, K2 and K3 of one or several checkouts on the same card.

    python3 egohmr_tpu_torch/tools/time_kernels.py [ROOT ...]

Each ROOT is a directory that holds an `egohmr_tpu_torch` package (default:
the checkout this file is in). Every root runs in a process of its own, in
the order given, so two versions are compared within one run, in turns:

    python3 egohmr_tpu_torch/tools/time_kernels.py old new new old

A run builds the root's kernels, calls the public wrappers
(`pointnet_fused_feature`, `nearest_vertex_idx`) at the shapes the main
paths give them, and prints one JSON line: the card's name and power limit
and, per shape, the median over CUDA-event timings of single calls in ms
(host time of the wrapper included, as a caller sees it) and, under
`*_device_ms`, the time of the call's kernels alone, read from the profiler
(null if it records no device time). Under `k3_us`, per variant of the
matmul-rate probe, the time per product in us from the probe's own
`measure` at its defaults (G=32 chains, R1=32, R2=160, 12 repetitions).
Needs a GPU.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

K1_SHAPES = {"B=64": (64, 20000), "B=16": (16, 20000), "B=8": (8, 20000)}
K2_SHAPES = {"guided": (64, 1024, 6890), "guided DDPM": (16, 1024, 6890),
             "metric": (16, 20000, 6890), "cloud": (16, 6890, 20000),
             "eval metric": (40, 20000, 6890), "eval cloud": (40, 6890, 20000)}


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import numpy as np
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps: int = 5):
    """Kernel time of one call: the profiler's device self time over `reps`
    calls, divided by `reps`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 / reps if total > 0 else None


def run_one(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    from egohmr_tpu_torch.collision import knn as k2
    from egohmr_tpu_torch.models import init_random_
    from egohmr_tpu_torch.nn import ResnetPointnet
    from egohmr_tpu_torch.nn import pointnet_fused as k1
    from egohmr_tpu_torch.tools import probe_int8_mma as k3

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = {"root": root, "card": smi, "k1_ms": {}, "k1_device_ms": {}, "k2_ms": {},
           "k2_device_ms": {}, "k3_us": {}}
    enc = init_random_(ResnetPointnet(512, 256), seed=1).cuda().eval()
    g = torch.Generator().manual_seed(2)
    for name, (B, P) in K1_SHAPES.items():
        pts = torch.randn(B, P, 3, generator=g).cuda()
        out["k1_ms"][name] = time_ms(lambda: k1.pointnet_fused_feature(enc, pts), reps=10)
        out["k1_device_ms"][name] = device_ms(lambda: k1.pointnet_fused_feature(enc, pts))
    for name, (B, P, V) in K2_SHAPES.items():
        verts = torch.randn(B, V, 3, generator=g) * torch.tensor([0.25, 0.5, 0.15])
        pts = verts[:, torch.randint(V, (P,), generator=g)] + 0.05 * torch.randn(B, P, 3, generator=g)
        pts, verts = pts.cuda(), verts.cuda()
        out["k2_ms"][name] = time_ms(lambda: k2.nearest_vertex_idx(pts, verts), reps=20)
        out["k2_device_ms"][name] = device_ms(lambda: k2.nearest_vertex_idx(pts, verts))
    inputs = k3.make_inputs(0, torch.device("cuda"))
    for name in k3.VARIANTS:
        res = k3.measure(name, inputs[name], 32, 32, 160, 12)
        out["k3_us"][name] = res.get("us_per_matmul")
    return out


def main(argv) -> None:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(run_one(argv[1])), flush=True)
        return
    roots = argv or [str(Path(__file__).resolve().parents[2])]
    for root in roots:
        subprocess.run([sys.executable, __file__, "--one", str(Path(root).resolve())], check=True)


if __name__ == "__main__":
    main(sys.argv[1:])
