"""What the guided step's backward costs in a whole guided request: the
port of the JAX package's `tools/probe_guided_backward.py`, with its flags.

    python -m egohmr_tpu_torch.tools.probe_guided_backward [--batch 16]
        [--iters 5] [--all] [--quick] [--cpu]

Times guided DDPM-50 through `eval.pipeline.sample_bodies` (bf16
conditioning and denoiser, f32 guidance) with the exact gradient against
the same request with `guidance_grad_mode="forward-only"` (the
differentiable selective pass runs forward, its backward is skipped, the
applied guidance is numerically nil): the difference is the backward's
cost per request across the 11 guided steps, measured inside the real
sampling loop. Both by `bench`'s method (chained requests, a synchronize
at the end, chain-length differencing, CUDA events beside the host clock).

  exact-r3, fwd-r3   selection refreshed every 3rd guided step
  exact-r1, fwd-r1   (--all) the default, refreshed at every guided step

Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys

from .. import bench


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m egohmr_tpu_torch.tools.probe_guided_backward",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--all", action="store_true", help="also measure the refresh=1 pair")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--quick", action="store_true", help="tiny widths and shapes (smoke test)")
    return ap


def main(argv=None, *, request_hook: bench.RequestHook = None) -> int:
    args = parser().parse_args(argv)
    dev = bench.resolve_device(args)
    if dev is None:
        return bench.fail_no_device("guided_ddpm50_backward_decomposition", "ms")

    from ..data import synthetic_batch
    from ..diffusion import GuidanceConfig, make_schedule
    from ..eval.pipeline import sample_bodies
    from ..nn import cast_params_bf16
    from ..smpl import make_synthetic_model

    cfg = bench.model_config(args.quick, pointnet_impl="fused")
    B, P, V, img = (bench.QUICK_SHAPES if args.quick
                    else (args.batch, bench.FULL_P, bench.FULL_V, bench.FULL_IMG))
    model = cast_params_bf16(bench.random_model(cfg, dev))
    smpl = make_synthetic_model(num_vertices=V, device=dev)
    stats = bench.unit_stats(dev)
    schedule = make_schedule(50, "cosine", "").to(dev)
    batch = synthetic_batch(B, num_scene_points=P, img_size=img, device=dev)
    gcfg = GuidanceConfig(cond_grad_weight=2.0)

    def run(refresh, grad_mode):
        name = f"{'fwd' if grad_mode != 'exact' else 'exact'}-r{refresh}"

        def guided(i):
            outs, _ = sample_bodies(
                model, cfg, smpl, stats, schedule, batch, bench.generator(dev, i), 1,
                sampler="ddpm", with_guidance=True, guidance=gcfg, bf16=True,
                params_precast=True, guidance_refresh_every=refresh,
                guidance_grad_mode=grad_mode)
            return outs["pred_keypoints_3d"]

        if request_hook is not None:
            request_hook(name, bench.Request(lambda: guided(10 ** 6)))
        ch = bench._chain_throughput(guided, args.iters, dev, min_chain=bench.min_chain(args))
        bench._log(f"{name}: {ch.dt * 1e3:.2f} ms/batch -> {B / ch.dt:.1f} bodies/s "
                   f"(first call {ch.first_s:.1f}s)")
        return {"ms_per_batch": ch.dt * 1e3, "bodies_per_s": B / ch.dt,
                "event_ms_per_batch": ch.readings.get("event_ms_per_call"),
                "launches_per_request": ch.readings["launches_per_call"],
                "readings": ch.readings}

    results = {"exact-r3": run(3, "exact"), "fwd-r3": run(3, "forward-only")}
    if args.all:
        results["exact-r1"] = run(1, "exact")
        results["fwd-r1"] = run(1, "forward-only")

    def cost(key):
        a, b = results[f"exact-{key}"], results[f"fwd-{key}"]
        ev = (a["event_ms_per_batch"] - b["event_ms_per_batch"]
              if a["event_ms_per_batch"] is not None else None)
        return a["ms_per_batch"] - b["ms_per_batch"], ev

    host_ms, event_ms = cost("r3")
    print(json.dumps({
        "metric": "guided_ddpm50_backward_decomposition",
        "batch_size": B,
        "results": results,
        "backward_cost_ms_per_batch": host_ms,
        "backward_cost_event_ms_per_batch": event_ms,
        "backward_cost_ms_per_batch_r1": cost("r1")[0] if args.all else None,
        "note": "exact minus forward-only = the cost of the selective re-pose's "
                "backward across the 11 guided steps of one request",
        "platform": dev.type,
        "device": bench.device_name(dev),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
