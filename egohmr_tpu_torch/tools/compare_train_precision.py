"""Convergence evidence for bf16 mixed-precision training on the card: the
port of the JAX package's `tools/compare_train_precision.py`, with its
flags, summary keys, gates and exit code.

    python -m egohmr_tpu_torch.tools.compare_train_precision [--steps 1500]
        [--eval_every 250] [--tol 0.05] [--val_tol 0.05] [--quick]
        [--device cuda | --cpu] [--out PATH]

Runs N training steps twice, f32 (TF32 off in matmuls and cuDNN, as `bench
--train --f32`) and `TrainConfig.mixed_precision` bf16 (PyTorch's TF32
defaults, as `bench --train`), from the SAME weights (random from seed 0),
on the SAME sequence of 8 cycled synthetic batches and the SAME per-step
draws (t, noise and the condition-drop mask from a `torch.Generator`
seeded with the step index), and compares:

  * the per-step training-loss curves (`smooth`ed, the mean relative gap
    over the last quarter: gated by --tol), and
  * the reference's model-selection metric `loss_keypoints_3d_vis`, probed
    every --eval_every steps by an f32 DDIM-5 sampling pass (generator
    seeded 7) on (a) a TRAINING batch, the signal synthetic data can carry
    (memorisation), gated by --val_tol, and (b) a held-out batch (seed
    999), which is chance level on synthetic data (the image-to-pose map is
    random) and is reported with the spread of 4 sampling seeds, not gated.

The configuration is `bench --train`'s: batch 16, 20,000 scene points,
6890-vertex synthetic SMPL, the collision loss on (kernel K2 once per
step), full width. `--quick` runs the port's tiny test widths (ResNet-18
and narrow heads; batch 4, 2,048 points, 512 vertices): the JAX tool's
`--quick` uses a stub backbone, which the port does not have, so a quick
run here is not the JAX quick run.

The overlay (curves, validation series, spread, configuration with the
card's name and power limit) is written to --out, by default
`artifacts/h100_train_precision_overlay.json` ('' writes nothing). Prints
the summary as one JSON line; exits 1 when a gate fails.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import torch

from .. import bench
from ..utils.device import resolve_device

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (batch, scene_points, vertices) per mode, for both runs and the overlay's
# config block
_DIMS = {"quick": (4, 2048, 512), "full": (16, 20000, 6890)}


def _build(quick: bool, device: torch.device):
    """What both precision runs share: (config, the initial model, stats,
    SMPL, batch, points)."""
    from ..smpl import make_synthetic_model

    B, P, V = _DIMS["quick" if quick else "full"]
    cfg = bench.model_config(quick)
    model0 = bench.random_model(cfg, device, training=True)
    smpl = make_synthetic_model(num_vertices=V, device=device)
    return cfg, model0, bench.unit_stats(device), smpl, B, P


def make_val_fn(cfg, stats, smpl):
    """The validation probe: f32 DDIM-5 sampling of one body per image,
    then `loss_keypoints_3d_vis` (per-joint mean, metres), the reference's
    best-model metric."""
    from ..diffusion import make_schedule
    from ..eval.pipeline import sample_bodies
    from ..models import LossWeights, compute_loss

    schedule_eval = None

    @torch.no_grad()
    def val_metric(model, batch, seed: int):
        nonlocal schedule_eval
        dev = batch["img"].device
        if schedule_eval is None:
            schedule_eval = make_schedule(50, "cosine", "ddim5").to(dev)
        out, cond = sample_bodies(model, cfg, smpl, stats, schedule_eval, batch,
                                  torch.Generator(device=dev).manual_seed(seed), 1,
                                  sampler="ddim", with_guidance=False)
        out1 = {k: v[:, 0] for k, v in out.items()}
        _, losses = compute_loss(cfg, LossWeights(), smpl, smpl, smpl, batch, cond, out1,
                                 train=False, use_collision=False)
        return losses["loss_keypoints_3d_vis_batch_sum"] / losses["joint_vis_num_batch"]

    return val_metric


def step_draws(i: int, device: torch.device) -> dict:
    """The draws of step i: a generator seeded with the step index, the
    same in both runs."""
    return {"generator": torch.Generator(device=device).manual_seed(i)}


def run(built, val_fn, steps: int, mixed_precision: bool, eval_every: int):
    """One precision run from a copy of `built`'s initial model. Returns
    (losses, validation steps, train-batch and held-out metrics, the final
    model's sampling spread on each, seconds)."""
    from ..data import synthetic_batch
    from ..diffusion import make_schedule
    from ..models import LossWeights
    from ..train import TrainConfig, make_optimizer, make_train_step

    cfg, model0, stats, smpl, B, P = built
    dev = stats.mean.device
    model = copy.deepcopy(model0)
    schedule = make_schedule(50, "cosine", "").to(dev)
    tcfg = TrainConfig(use_collision_loss=True, mixed_precision=mixed_precision)
    step = make_train_step(cfg, tcfg, LossWeights(), schedule, stats, smpl, smpl, smpl,
                           make_optimizer(model, tcfg))

    # 8 distinct synthetic batches cycled, the same sequence for both runs,
    # and a held-out batch never trained on
    batches = [synthetic_batch(B, num_scene_points=P, seed=s, device=dev) for s in range(8)]
    val_batch = synthetic_batch(B, num_scene_points=P, seed=999, device=dev)

    losses, val_steps, val_train, val_held = [], [], [], []
    t0 = time.time()
    for i in range(steps):
        metrics = step(model, batches[i % len(batches)], **step_draws(i, dev))
        losses.append(metrics["loss"].detach())  # on the device: no sync per step
        if eval_every and ((i + 1) % eval_every == 0 or i == steps - 1):
            # the f32 probe on the f32 master weights, the same program in
            # both runs
            val_steps.append(i + 1)
            val_train.append(val_fn(model, batches[0], 7))
            val_held.append(val_fn(model, val_batch, 7))
    spread_train, spread_held = [], []
    if eval_every:
        spread_train = [val_fn(model, batches[0], 100 + j) for j in range(4)]
        spread_held = [val_fn(model, val_batch, 100 + j) for j in range(4)]

    def host(xs):
        return torch.stack(xs).float().cpu().tolist() if xs else []

    out, vt, vh, st, sh = (host(x) for x in (losses, val_train, val_held, spread_train,
                                              spread_held))
    dt = time.time() - t0
    tag = "bf16_mixed" if mixed_precision else "f32"
    msg = f"# {tag}: {steps} steps in {dt:.1f}s (loss {out[0]:.3f} -> {out[-1]:.3f}"
    if vt:
        msg += f"; kp3d_vis train {vt[-1]*1000:.1f} mm, held-out {vh[-1]*1000:.1f} mm)"
    else:
        msg += ")"
    print(msg, file=sys.stderr)
    return out, val_steps, vt, vh, st, sh, dt


def smooth(xs, w=25):
    return [sum(xs[max(0, i - w + 1):i + 1]) / len(xs[max(0, i - w + 1):i + 1])
            for i in range(len(xs))]


def summarize(steps: int, tol: float, val_tol: float, r32, r16) -> dict:
    """The JAX tool's summary and gates, from the two runs' results."""
    l32, _, vt32, vh32, _, sh32, _ = r32
    l16, _, vt16, vh16, _, sh16, _ = r16
    s32, s16 = smooth(l32), smooth(l16)
    q = steps * 3 // 4
    tail_rel = [abs(a - b) / max(abs(a), 1e-9) for a, b in zip(s32[q:], s16[q:])]
    mean_tail_rel = sum(tail_rel) / len(tail_rel)
    val_rel = (abs(vt32[-1] - vt16[-1]) / max(abs(vt32[-1]), 1e-9)
               if vt32 and vt16 else None)
    held_rel = (abs(vh32[-1] - vh16[-1]) / max(abs(vh32[-1]), 1e-9)
                if vh32 and vh16 else None)

    def _stats(xs):
        m = sum(xs) / len(xs)
        sd = (sum((x - m) ** 2 for x in xs) / len(xs)) ** 0.5
        return {"mean": round(m, 6), "std": round(sd, 6)}

    return {
        "steps": steps,
        "f32_first_last": [round(l32[0], 4), round(l32[-1], 4)],
        "bf16_first_last": [round(l16[0], 4), round(l16[-1], 4)],
        "smoothed_final_f32": round(s32[-1], 4),
        "smoothed_final_bf16": round(s16[-1], 4),
        "mean_tail_rel_diff": round(mean_tail_rel, 5),
        "val_kp3d_vis_train_final_f32": round(vt32[-1], 6) if vt32 else None,
        "val_kp3d_vis_train_final_bf16": round(vt16[-1], 6) if vt16 else None,
        "val_train_rel_diff": round(val_rel, 5) if val_rel is not None else None,
        # held-out: chance level on synthetic data (the image-to-pose map is
        # random), reported with its sampling spread, not gated
        "val_kp3d_vis_heldout_final_f32": round(vh32[-1], 6) if vh32 else None,
        "val_kp3d_vis_heldout_final_bf16": round(vh16[-1], 6) if vh16 else None,
        "heldout_rel_diff": round(held_rel, 5) if held_rel is not None else None,
        "heldout_sampling_spread_f32": _stats(sh32) if sh32 else None,
        "heldout_sampling_spread_bf16": _stats(sh16) if sh16 else None,
        "tol": tol,
        "val_tol": val_tol,
        "ok": mean_tail_rel <= tol and (val_rel is None or val_rel <= val_tol),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m egohmr_tpu_torch.tools.compare_train_precision",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--eval_every", type=int, default=250,
                    help="probe loss_keypoints_3d_vis (ddim5 sampling on a "
                         "held-out batch) every N steps; 0 disables")
    ap.add_argument("--tol", type=float, default=0.05,
                    help="max allowed mean |rel diff| of the smoothed loss "
                         "curves over the last quarter of training")
    ap.add_argument("--val_tol", type=float, default=0.05,
                    help="max allowed |rel diff| of the final "
                         "loss_keypoints_3d_vis metric on the TRAIN batch "
                         "(the learnable signal on synthetic data)")
    ap.add_argument("--quick", action="store_true",
                    help="the port's tiny test widths (a CPU-friendly smoke)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (fails without a card) or 'cpu'")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--out", default=os.path.join(
        _REPO, "artifacts", "h100_train_precision_overlay.json"),
        help="persist the full overlay (curves + val series) here; '' disables")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else args.device)

    built = _build(args.quick, dev)
    val_fn = make_val_fn(built[0], built[2], built[3]) if args.eval_every else None
    defaults = bench.tf32_state()
    bench.set_f32(True)
    try:
        r32 = run(built, val_fn, args.steps, False, args.eval_every)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = defaults["matmul"]
        torch.backends.cudnn.allow_tf32 = defaults["cudnn"]
    r16 = run(built, val_fn, args.steps, True, args.eval_every)
    summary = summarize(args.steps, args.tol, args.val_tol, r32, r16)

    if args.out:
        (l32, vs32, vt32, vh32, st32, sh32, dt32), (l16, _, vt16, vh16, st16, sh16, dt16) = r32, r16
        dims = _DIMS["quick" if args.quick else "full"]
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({
                "summary": summary,
                "config": {
                    "quick": args.quick, "eval_every": args.eval_every,
                    "batch": dims[0], "scene_points": dims[1],
                    "collision_loss": True,
                    "device": bench.device_name(dev),
                    "platform": dev.type,
                    "tf32": {"f32": {"matmul": False, "cudnn": False}, "bf16": defaults},
                    "git_rev": bench.git_rev() or "unknown",
                    "wall_s": {"f32": round(dt32, 1), "bf16": round(dt16, 1)},
                },
                "train_loss": {"f32": [round(x, 5) for x in l32],
                               "bf16": [round(x, 5) for x in l16]},
                "val_kp3d_vis_train_batch": {
                    "steps": vs32,
                    "f32": [round(x, 6) for x in vt32],
                    "bf16": [round(x, 6) for x in vt16]},
                "val_kp3d_vis_heldout": {
                    "steps": vs32,
                    "f32": [round(x, 6) for x in vh32],
                    "bf16": [round(x, 6) for x in vh16],
                    "note": "chance-level on synthetic data (the img->pose "
                            "mapping is random noise, so held-out error "
                            "cannot improve with training; curves are flat)"},
                "final_sampling_spread": {
                    "train_f32": [round(x, 6) for x in st32],
                    "train_bf16": [round(x, 6) for x in st16],
                    "heldout_f32": [round(x, 6) for x in sh32],
                    "heldout_bf16": [round(x, 6) for x in sh16]},
            }, f)
        print(f"# overlay persisted to {args.out}", file=sys.stderr)
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
