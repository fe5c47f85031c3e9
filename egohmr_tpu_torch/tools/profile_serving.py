"""Split a serving request's time into its parts: the port of the JAX
package's `tools/profile_serving.py`, with its flags.

    python -m egohmr_tpu_torch.tools.profile_serving [--batch-size 64]
        [--samples 1] [--pack16] [--sweep 1,2,4,8] [--stream 24] [--reps 3]
        [--iters 5] [--quick] [--cpu]

`bench --serving` reports `Predictor.map_batches`'s steady state; this
breaks one request of the same `Predictor` down:

  * submit_ms      host time to upload, pad and queue one request (no wait
                   for the device), p50;
  * d2h_ms         copy of one finished packed output to pinned host
                   memory, p50;
  * blocking_ms    one request from submit to numpy outputs, p50;
  * steady_ms      `map_batches`' steady-state time per request at each
                   `max_inflight` of --sweep, by stream-length differencing;
  * device_ms      the same request's device time: CUDA events around
                   chains of the packed pipeline (the batch already on the
                   card), differenced as `bench` does, beside the host
                   clock's reading of the same chains;
  * from `torch.profiler` over one blocking request (`profile`, on the card
    a replay of the request's captured program) and over the same request
    run eagerly (`profile_eager`, `Predictor.eager`): `kernel_launches`,
    the kernels and copies the device ran (inside a graph too), the sum of
    their device time, the device's busy share of the request's wall time,
    and `host_launches`, the host's CUDA API calls that queued them (graph
    launches, kernel launches, copies): a replayed request is a few graph
    launches and copies for all its kernels.

Prints one JSON line. On the CPU (--cpu, a smoke test) the device columns
read null.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .. import bench


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m egohmr_tpu_torch.tools.profile_serving",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--samples", type=int, default=1)
    ap.add_argument("--pack16", action="store_true")
    ap.add_argument("--sweep", type=str, default="1,2,4,8",
                    help="comma-separated max_inflight values")
    ap.add_argument("--stream", type=int, default=24,
                    help="requests per steady-state stream measurement")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--iters", type=int, default=5,
                    help="chain length n1 of device_ms (n2 = 3 n1)")
    ap.add_argument("--quick", action="store_true", help="tiny widths and shapes (smoke test)")
    ap.add_argument("--cpu", action="store_true")
    return ap


def _p50(xs):
    return sorted(xs)[len(xs) // 2]


def profile_request(request, device: torch.device) -> dict:
    """The device's kernels and copies, their time and busy share, and the
    host's launch calls of one blocking `request()`, from
    `torch.profiler`; nulls on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    from ..utils.profiling import device_kernels, host_launches

    if device.type != "cuda":
        return {"kernel_launches": None, "kernel_ms": None, "busy_share": None,
                "wall_ms": None, "host_launches": None}
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    return {"kernel_launches": kernels["count"], "kernel_ms": kernels["ms"],
            "busy_share": kernels["ms"] / wall_ms, "wall_ms": wall_ms,
            "host_launches": host_launches(prof)}


def main(argv=None, *, request_hook: bench.RequestHook = None) -> int:
    args = parser().parse_args(argv)
    dev = bench.resolve_device(args)
    if dev is None:
        return bench.fail_no_device("serving_profile", "ms")

    from ..data import synthetic_batch, to_torch
    from ..diffusion import make_schedule
    from ..serving import Predictor
    from ..smpl import make_synthetic_model

    cpu = torch.device("cpu")
    B, S = args.batch_size, args.samples
    P, V, img = bench.FULL_P, bench.FULL_V, bench.FULL_IMG
    if args.quick:
        B, P, V, img = bench.QUICK_SHAPES
    cfg = bench.model_config(args.quick)
    pred = Predictor(
        bench.random_model(cfg, cpu), cfg, make_synthetic_model(num_vertices=V),
        bench.unit_stats(cpu), make_schedule(50, "cosine", "ddim5"), device=dev,
        batch_size=B, num_samples=S,
        pack_dtype=torch.float16 if args.pack16 else torch.float32)
    batch = synthetic_batch(B, num_scene_points=P, img_size=img)

    t0 = time.perf_counter()
    pred.warmup(batch)
    first_s = time.perf_counter() - t0
    bench._log(f"warm-up {first_s:.1f}s")
    if request_hook is not None:
        request_hook("serving", bench.Request(lambda: pred.eager(batch, seed=10 ** 6),
                                              lambda: pred(batch, seed=10 ** 6)))

    # --- submit: host time to queue one request
    ts, pending = [], None
    for i in range(8):
        t0 = time.perf_counter()
        pending = pred.submit(batch, seed=1000 + i)
        ts.append(time.perf_counter() - t0)
    pred.result(pending)
    submit_ms = _p50(ts) * 1e3

    # --- D2H of a finished packed output, into pinned memory as `submit` does
    dev_batch = to_torch(batch, dev)
    ts = []
    for i in range(6):
        packed = pred._run(dev_batch, bench.generator(dev, 50 + i))
        bench._sync(dev)
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=dev.type == "cuda")
        t0 = time.perf_counter()
        host.copy_(packed)
        ts.append(time.perf_counter() - t0)
    d2h_ms = _p50(ts) * 1e3
    bytes_per_batch = host.numel() * host.element_size()

    # --- blocking round trip
    ts = []
    for i in range(args.reps * 2):
        t0 = time.perf_counter()
        pred(batch, seed=2000 + i)
        ts.append(time.perf_counter() - t0)
    blocking_ms = _p50(ts) * 1e3

    # --- device time of the same packed program, chained as the bench chains
    ch = bench._chain_throughput(lambda i: pred._run(dev_batch, bench.generator(dev, i)),
                                 args.iters, dev, min_chain=bench.min_chain(args))
    device_ms = ch.readings.get("event_ms_per_call")
    prof = profile_request(lambda: pred(batch, seed=7), dev)
    prof_eager = profile_request(lambda: pred.eager(batch, seed=7), dev)

    # --- steady-state map_batches at each max_inflight: (t(3n) - t(n)) / 2n
    # cancels the stream's fill and drain
    def run_stream(n):
        t0 = time.perf_counter()
        cnt = sum(1 for _ in pred.map_batches(dict(batch) for _ in range(n)))
        assert cnt == n
        return time.perf_counter() - t0

    sweep, raw = {}, {}
    n1 = max(args.stream // 3, bench.min_chain(args))
    for infl in [int(x) for x in args.sweep.split(",") if x]:
        pred.max_inflight = infl
        run_stream(2)  # warm
        r1 = [run_stream(n1) for _ in range(args.reps)]
        r2 = [run_stream(3 * n1) for _ in range(args.reps)]
        best = max(min(r2) - min(r1), 1e-9) / (2 * n1)
        sweep[str(infl)], raw[str(infl)] = best * 1e3, {"host_s_n1": r1, "host_s_n2": r2}
        bench._log(f"max_inflight={infl}: {best * 1e3:.2f} ms/batch -> "
                   f"{B * S / best:.1f} bodies/s")

    best_infl = min(sweep, key=lambda k: sweep[k])
    steady_ms = sweep[best_infl]
    print(json.dumps({
        "metric": "serving_profile",
        "batch_size": B,
        "num_samples": S,
        "pack_dtype": "float16" if args.pack16 else "float32",
        "packed_bytes_per_batch": int(bytes_per_batch),
        "first_call_s": first_s,
        "submit_ms": submit_ms,
        "d2h_ms": d2h_ms,
        "blocking_ms": blocking_ms,
        "device_ms": device_ms,
        "device_ms_host_clock": ch.dt * 1e3,
        "steady_ms_by_inflight": sweep,
        "best": {"max_inflight": int(best_infl), "steady_ms": steady_ms,
                 "bodies_per_s": B * S / (steady_ms / 1e3)},
        "profile": prof,
        "profile_eager": prof_eager,
        "captured": pred.captured,
        "capture": bench.capture_extra(pred._programs),
        "launches_per_request": ch.readings["launches_per_call"],
        "readings": {"device": ch.readings, "steady": raw, "n1": n1},
        "platform": dev.type,
        "device": bench.device_name(dev),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
