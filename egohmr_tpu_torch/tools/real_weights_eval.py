"""Two-stage evaluation from reference-layout checkpoints in one command:
the port of the JAX package's `tools/real_weights_eval.py`, with its flags.

The reference's published evaluation runs the stage-1 ProHMR-scene model
(`53618.pt`), which writes one camera translation per image, and then the
stage-2 EgoHMR model (`91453.pt`) conditioned on those translations. This
is that flow through the port's two CLIs:

  1. `eval.test_prohmr` on the stage-1 checkpoint, whole-scene clouds,
     `--save_results true`: its summary (mm) and `<save_root>/stage1/
     results.pkl`;
  2. `eval.test_egohmr` on the stage-2 checkpoint with `--two_stage true
     --stage1_result_path <save_root>/stage1/results.pkl`;
  3. one report, printed and written to `<save_root>/report.json`:
     `stage1_checkpoint`, `stage2_checkpoint`, `stage1_metrics_mm`,
     `stage2_metrics`.

Both CLIs load a reference `.pt` as it is (the port's modules carry the
reference's keys), a checkpoint of the port's training CLIs, or a `.npz`
tree of the JAX package. `--device` (default `cuda`, failing without a
card) takes the place of `--platform`. At the defaults (batch 10, 5
samples, guided DDPM-50, bf16, the CLIs' `--pointnet_impl fused`) stage 1
launches kernel K1 once a batch, and stage 2 K1 once a batch and K2 twice
a batch plus once per guided step.

Usage:
  python -m egohmr_tpu_torch.tools.real_weights_eval \\
      --stage1_checkpoint checkpoints/53618.pt \\
      --stage2_checkpoint checkpoints/91453.pt \\
      --smpl_model_path data/smpl \\
      --dataset_root /mnt/ssd/egobody_release \\
      --body_rep_stats data/preprocess_stats/preprocess_stats.npz \\
      --save_root output_results/real_weights
"""
from __future__ import annotations

import argparse
import json
import os

from ..eval import test_egohmr, test_prohmr
from ..utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m egohmr_tpu_torch.tools.real_weights_eval",
        description="Two-stage eval from reference-layout checkpoints")
    b = lambda x: str(x).lower() in ["true", "1"]  # noqa: E731
    p.add_argument("--stage1_checkpoint", type=str, required=True,
                   help="reference-layout stage-1 .pt (53618.pt), a checkpoint of "
                        "the port's training CLI, or a JAX .npz tree")
    p.add_argument("--stage2_checkpoint", type=str, required=True,
                   help="reference-layout stage-2 .pt (91453.pt), a checkpoint of "
                        "the port's training CLI, or a JAX .npz tree")
    p.add_argument("--smpl_model_path", type=str, default="data/smpl")
    p.add_argument("--dataset_root", type=str, default="/mnt/ssd/egobody_release")
    p.add_argument("--dataset_file", type=str, default="",
                   help="test-split npz (defaults to the EgoBody release "
                        "layout under --dataset_root)")
    p.add_argument("--body_rep_stats", type=str, default="",
                   help="preprocess_stats.npz (stage-2 body-rep whitening)")
    p.add_argument("--save_root", type=str, default="output_results/real_weights")
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--num_samples", type=int, default=5,
                   help="diverse samples per image for both stages "
                        "(reference paper setting)")
    p.add_argument("--num_batches", type=int, default=0,
                   help="limit evaluated batches (0 = full test split)")
    p.add_argument("--eval_spacing", type=int, default=1)
    p.add_argument("--timestep_respacing_eval", type=str, default="ddpm",
                   choices=["ddim5", "ddpm"])
    p.add_argument("--with_coap_grad", type=b, default=True)
    p.add_argument("--collision_backend", type=str, default="sdf",
                   choices=["sdf", "occupancy", "volsdf"])
    p.add_argument("--occupancy_ckpt", type=str, default="")
    p.add_argument("--sdfnet_ckpt", type=str, default="")
    p.add_argument("--bf16", type=b, default=True)
    p.add_argument("--data_parallel", type=b, default=True)
    p.add_argument("--scene_crop_by_stage1_transl", type=b, default=True,
                   help="re-crop the scene cube around the stage-1 "
                        "translation (the reference two-stage behavior); "
                        "false when the dataset ships pre-cropped cubes")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (fails without a card) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    resolve_device(args.device)  # before stage 1: no card, no run
    os.makedirs(args.save_root, exist_ok=True)
    s1_root = os.path.join(args.save_root, "stage1")
    common = ["--device", args.device]
    if args.dataset_file:
        common += ["--dataset_file", args.dataset_file]
    shared = ["--smpl_model_path", args.smpl_model_path,
              "--dataset_root", args.dataset_root,
              "--batch_size", str(args.batch_size),
              "--num_samples", str(args.num_samples),
              "--num_batches", str(args.num_batches),
              "--eval_spacing", str(args.eval_spacing)]

    def flag(x: bool) -> str:
        return "true" if x else "false"

    print(f"[1/2] stage-1 eval: {args.stage1_checkpoint}", flush=True)
    s1 = test_prohmr.main(common + shared + [
        "--checkpoint", args.stage1_checkpoint,
        "--scene_type", "whole_scene",
        "--save_results", "true",
        "--save_root", s1_root,
    ])

    pkl = os.path.join(s1_root, "results.pkl")
    print(f"[2/2] stage-2 eval: {args.stage2_checkpoint} "
          f"(two-stage, transl from {pkl})", flush=True)
    s2_args = common + shared + [
        "--checkpoint", args.stage2_checkpoint,
        "--timestep_respacing_eval", args.timestep_respacing_eval,
        "--with_coap_grad", flag(args.with_coap_grad),
        "--collision_backend", args.collision_backend,
        "--bf16", flag(args.bf16),
        "--data_parallel", flag(args.data_parallel),
        "--two_stage", "true",
        "--stage1_result_path", pkl,
        "--scene_crop_by_stage1_transl", flag(args.scene_crop_by_stage1_transl),
    ]
    if args.body_rep_stats:
        s2_args += ["--body_rep_stats", args.body_rep_stats]
    if args.occupancy_ckpt:
        s2_args += ["--occupancy_ckpt", args.occupancy_ckpt]
    if args.sdfnet_ckpt:
        s2_args += ["--sdfnet_ckpt", args.sdfnet_ckpt]
    s2 = test_egohmr.main(s2_args)

    report = {
        "stage1_checkpoint": args.stage1_checkpoint,
        "stage2_checkpoint": args.stage2_checkpoint,
        "stage1_metrics_mm": s1,
        "stage2_metrics": s2,
    }
    out = os.path.join(args.save_root, "report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    print(f"report written to {out}")
    return report


if __name__ == "__main__":
    main()
