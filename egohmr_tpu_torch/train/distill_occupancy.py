"""Distil the exact mesh SDF into the learned part-wise occupancy net (port
of egohmr_tpu/train/distill_occupancy.py).

The same flags and defaults, with `--device` (default `cuda`) in place of
`--platform`, and the same artifact: a `.npz` in the JAX package's layout
with a `.json` sidecar, which either package's `load_occupancy` reads; a
run that misses `--accuracy_bar` writes `<save_path>.failed.npz` instead.
Training draws come from a `torch.Generator` seeded with `--seed` on the
device, the held-out draws from one seeded with `--seed` + 1. On the card
the labels' nearest vertex is kernel K2.

Usage:
  python -m egohmr_tpu_torch.train.distill_occupancy --synthetic_watertight \\
      --label_mode winding --part_embed_dim 32 --hidden_dim 192 --num_layers 5 \\
      --steps 6000 --save_path artifacts/occupancy_synthetic_signed.npz
"""
from __future__ import annotations

import argparse
import json
import os

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Distill mesh SDF -> learned occupancy (collision backend)")
    p.add_argument("--save_path", type=str, default="artifacts/occupancy.npz")
    p.add_argument("--smpl_model_path", type=str, default="data/smpl")
    p.add_argument("--gender", type=str, default="neutral")
    p.add_argument("--synthetic", action="store_true",
                   help="distill against the synthetic SMPL body (no SMPL "
                        ".pkl release needed)")
    p.add_argument("--synthetic_watertight", action="store_true",
                   help="use the watertight synthetic body (outward normals): "
                        "the target for signed and winding labels")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch_bodies", type=int, default=8)
    p.add_argument("--points_per_body", type=int, default=1024)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--latent_dim", type=int, default=64)
    p.add_argument("--hidden_dim", type=int, default=128)
    p.add_argument("--num_layers", type=int, default=4)
    p.add_argument("--part_embed_dim", type=int, default=0,
                   help="learned per-part identity code size (0: none)")
    p.add_argument("--label_mode", type=str, default="signed",
                   choices=["signed", "winding", "proximity"])
    p.add_argument("--sign_k", type=int, default=4,
                   help="k-NN normal vote for the SDF training labels")
    p.add_argument("--accuracy_bar", type=float, default=0.95,
                   help="required held-out inside/outside agreement vs the "
                        "mesh SDF")
    p.add_argument("--eval_bodies", type=int, default=16)
    p.add_argument("--eval_points_per_body", type=int, default=1024)
    p.add_argument("--log_every", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (fails without a card) or 'cpu'")
    return p.parse_args(argv)


def distill_body(args, device):
    """(the SMPL tables to distil against, the sidecar's name of them)."""
    from ..smpl import create as smpl_create
    from ..smpl import make_synthetic_model, make_synthetic_watertight_model

    if args.synthetic_watertight:
        return make_synthetic_watertight_model(device=device), "synthetic_watertight"
    if args.synthetic:
        return make_synthetic_model(num_vertices=6890, device=device), "synthetic"
    return smpl_create(args.smpl_model_path, args.gender, device=device), args.gender


def save_artifact(save_path: str, net, meta: dict) -> str:
    """Write the net (JAX layout) and its sidecar; a run that missed its bar
    goes to `<path>.failed.npz`, never over a passing artifact. Returns the
    path written."""
    from ..interop import collision_net_to_jax
    from ..utils.checkpoint import save_npz

    if not save_path.endswith(".npz"):
        # np.savez appends ".npz": normalise first so that the sidecar lands
        # beside the file
        save_path += ".npz"
    if not meta["passed"]:
        save_path += ".failed.npz"
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    save_npz(save_path, collision_net_to_jax(net))
    with open(save_path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    print(json.dumps(meta))
    return save_path


def main(argv=None):
    args = parse_args(argv)
    from ..collision.neural_occupancy import (
        OccupancyConfig,
        distill_occupancy,
        occupancy_agreement,
    )
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    model, body = distill_body(args, device)
    cfg = OccupancyConfig(latent_dim=args.latent_dim, hidden_dim=args.hidden_dim,
                          num_layers=args.num_layers, part_embed_dim=args.part_embed_dim)
    net = distill_occupancy(
        torch.Generator(device).manual_seed(args.seed), model, cfg,
        steps=args.steps, batch_bodies=args.batch_bodies,
        points_per_body=args.points_per_body, lr=args.lr,
        label_mode=args.label_mode, sign_k=args.sign_k, log_every=args.log_every)

    # held-out agreement on fresh poses and points (the same draws for each
    # mode), under the trained label mode (which the bar applies to) and the
    # others, so that no agreement is quoted without its label mode
    acc_by_mode = {
        mode: occupancy_agreement(
            net, model, torch.Generator(device).manual_seed(args.seed + 1),
            n_bodies=args.eval_bodies, points_per_body=args.eval_points_per_body,
            label_mode=mode, sign_k=args.sign_k)
        for mode in dict.fromkeys((args.label_mode, "signed", "proximity"))
    }
    acc = acc_by_mode[args.label_mode]
    meta = {
        "accuracy": acc,
        "accuracy_by_label_mode": acc_by_mode,
        "accuracy_bar": args.accuracy_bar,
        "passed": bool(acc >= args.accuracy_bar),
        "body": body,
        "label_mode": args.label_mode,
        "sign_k": args.sign_k,
        "steps": args.steps,
        "occupancy_config": {"latent_dim": cfg.latent_dim, "hidden_dim": cfg.hidden_dim,
                             "num_layers": cfg.num_layers,
                             "part_embed_dim": cfg.part_embed_dim},
    }
    save_artifact(args.save_path, net, meta)
    if not meta["passed"]:
        print(f"WARNING: agreement {acc:.4f} below bar {args.accuracy_bar}")
    return meta


if __name__ == "__main__":
    main()
