"""How far the bodies move when the guided step's selection is reused: the
port of the JAX package's `tools/measure_guidance_reuse_deviation.py`, with
its flags and printed JSON.

    python -m egohmr_tpu_torch.tools.measure_guidance_reuse_deviation
        [--batch 2] [--points 20000] [--refresh 2,4] [--device cuda | --cpu]

Runs the full-width stage-2 pipeline (`EgoHMRConfig()`, random weights
from seed 0, bf16 conditioning and denoiser, `GuidanceConfig(
cond_grad_weight=2.0)`) through `eval.pipeline.sample_bodies`, for DDIM-5
and DDPM-50: unguided, guided exact (the selection pass at every guided
step) and guided with the selection refreshed every r-th guided step for
each r of --refresh. Every run of a mode starts from a fresh
`torch.Generator` seeded 7, so x_T and the step noise are the same across
its runs. Reports the final bodies' deviation from the exact run in mm
(max and mean over vertices) beside the guidance's own effect (exact
against unguided). This is the quality half of `--guidance-refresh`; its
speed half is `python -m egohmr_tpu_torch.bench --guided[-ddim]
--guidance-refresh N`.

Prints one JSON line, the JAX tool's, with `extra`: the device (the card's
name and power limit as `nvidia-smi` prints them, or "cpu") and kernel K2's
launches in each run (K2 runs in the selection pass only: g guided steps,
4 in DDIM-5 and 11 in DDPM-50, give g launches exact and ceil(g / r) with
reuse r; zeros on the CPU, where the plain version runs).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..collision import knn
from ..data import synthetic_batch
from ..diffusion import GuidanceConfig, make_schedule
from ..eval.pipeline import sample_bodies
from ..models import BodyRepStats, EgoHMR, EgoHMRConfig, init_random_
from ..nn import cast_params_bf16
from ..smpl import make_synthetic_model
from ..utils.device import resolve_device

MODES = (("ddim5", "ddim", "ddim5"), ("ddpm50", "ddpm", ""))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m egohmr_tpu_torch.tools.measure_guidance_reuse_deviation",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--points", type=int, default=20000)
    ap.add_argument("--refresh", type=str, default="2,4")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (fails without a card) or 'cpu'")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    return ap


def random_model(cfg: EgoHMRConfig) -> EgoHMR:
    """Stage 2 with random weights from seed 0."""
    return init_random_(EgoHMR(cfg), seed=0)


def _mm(d: np.ndarray) -> dict:
    return {"max": round(float(d.max() * 1000), 3), "mean": round(float(d.mean() * 1000), 3)}


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else args.device)
    from ..bench import device_name

    cfg = EgoHMRConfig()
    model = cast_params_bf16(random_model(cfg).eval()).to(dev, memory_format=torch.channels_last)
    stats = BodyRepStats(torch.zeros(144, device=dev), torch.ones(144, device=dev))
    smpl = make_synthetic_model(num_vertices=6890, device=dev)
    batch = synthetic_batch(args.batch, num_scene_points=args.points, device=dev)
    gcfg = GuidanceConfig(cond_grad_weight=2.0)
    launches = {}

    def verts(name, sampler, respacing, with_guidance, refresh):
        schedule = make_schedule(50, "cosine", respacing).to(dev)
        k2_0 = knn.launches
        outs, _ = sample_bodies(
            model, cfg, smpl, stats, schedule, batch, torch.Generator(device=dev).manual_seed(7),
            1, sampler=sampler, with_guidance=with_guidance, guidance=gcfg,
            guidance_refresh_every=refresh)
        launches[name] = knn.launches - k2_0
        return outs["pred_vertices"][:, 0].float().cpu().numpy()

    refreshes = [int(x) for x in args.refresh.split(",") if x]
    out = {}
    for mode, sampler, respacing in MODES:
        v_un = verts(f"{mode}_unguided", sampler, respacing, False, 1)
        v_exact = verts(f"{mode}_exact", sampler, respacing, True, 1)
        entry = {"guidance_effect_mm": _mm(np.linalg.norm(v_exact - v_un, axis=-1))}
        for r in refreshes:
            v_r = verts(f"{mode}_reuse{r}", sampler, respacing, True, r)
            entry[f"reuse{r}_deviation_mm"] = _mm(np.linalg.norm(v_r - v_exact, axis=-1))
        out[mode] = entry
        print(f"# {mode}: effect max {entry['guidance_effect_mm']['max']} mm; "
              + "; ".join(f"reuse{r} dev max {entry[f'reuse{r}_deviation_mm']['max']} mm"
                          for r in refreshes), file=sys.stderr)

    print(json.dumps({"metric": "guidance_reuse_final_body_deviation",
                      "batch": args.batch, "scene_points": args.points,
                      "modes": out,
                      "extra": {"device": device_name(dev), "k2_launches": launches}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
