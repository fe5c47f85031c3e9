"""Distil the exact mesh SDF into the learned signed-distance net (port of
egohmr_tpu/train/distill_sdf.py).

The same flags and defaults, with `--device` (default `cuda`) in place of
`--platform`, and the same artifact: a `.npz` in the JAX package's layout
with a `.json` sidecar, which either package's `load_sdfnet` reads; a run
that misses `--agreement_bar` writes `<save_path>.failed.npz` instead.
Training draws come from a `torch.Generator` seeded with `--seed` on the
device, the held-out draws from one seeded with `--seed` + 1. On the card
the labels' nearest vertex is kernel K2.

Usage:
  python -m egohmr_tpu_torch.train.distill_sdf --synthetic_watertight \\
      --steps 6000 --save_path artifacts/volsdf_synthetic.npz
"""
from __future__ import annotations

import argparse

import torch

from .distill_occupancy import distill_body, save_artifact


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Distill mesh SDF -> learned signed-distance net "
                    "(volsdf collision backend)")
    p.add_argument("--save_path", type=str, default="artifacts/volsdf.npz")
    p.add_argument("--smpl_model_path", type=str, default="data/smpl")
    p.add_argument("--gender", type=str, default="neutral")
    p.add_argument("--synthetic", action="store_true",
                   help="distill against the synthetic SMPL body (no SMPL "
                        ".pkl release needed)")
    p.add_argument("--synthetic_watertight", action="store_true",
                   help="use the watertight synthetic body, on which the "
                        "winding-number sign is exact")
    p.add_argument("--steps", type=int, default=6000)
    p.add_argument("--batch_bodies", type=int, default=8)
    p.add_argument("--points_per_body", type=int, default=1024)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--latent_dim", type=int, default=64)
    p.add_argument("--hidden_dim", type=int, default=192)
    p.add_argument("--num_layers", type=int, default=5)
    p.add_argument("--part_embed_dim", type=int, default=32)
    p.add_argument("--trunc", type=float, default=0.15,
                   help="SDF truncation radius in meters (DeepSDF-style)")
    p.add_argument("--label_mode", type=str, default="winding",
                   choices=["signed", "winding"],
                   help="'winding': exact generalized-winding-number sign "
                        "(ground truth on a watertight body); 'signed': "
                        "normal-vote sign")
    p.add_argument("--sign_k", type=int, default=4)
    p.add_argument("--agreement_bar", type=float, default=0.95,
                   help="required held-out inside/outside sign agreement vs "
                        "the exact mesh SDF")
    p.add_argument("--eval_bodies", type=int, default=16)
    p.add_argument("--eval_points_per_body", type=int, default=1024)
    p.add_argument("--log_every", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (fails without a card) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..collision.neural_sdf import SDFNetConfig, distill_sdf, sdf_agreement
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    model, body = distill_body(args, device)
    cfg = SDFNetConfig(latent_dim=args.latent_dim, hidden_dim=args.hidden_dim,
                       num_layers=args.num_layers, part_embed_dim=args.part_embed_dim,
                       trunc=args.trunc)
    net = distill_sdf(
        torch.Generator(device).manual_seed(args.seed), model, cfg,
        steps=args.steps, batch_bodies=args.batch_bodies,
        points_per_body=args.points_per_body, lr=args.lr,
        label_mode=args.label_mode, sign_k=args.sign_k, log_every=args.log_every)

    # held-out quality on fresh poses and points: the bar applies to the
    # sign agreement under the trained label mode; the MAEs ride along
    quality = sdf_agreement(
        net, model, torch.Generator(device).manual_seed(args.seed + 1),
        n_bodies=args.eval_bodies, points_per_body=args.eval_points_per_body,
        label_mode=args.label_mode, sign_k=args.sign_k)
    acc = quality["sign_agreement"]
    meta = {
        "sign_agreement": acc,
        "mae_truncated_m": quality["mae_truncated_m"],
        "mae_near_surface_m": quality["mae_near_surface_m"],
        "agreement_bar": args.agreement_bar,
        "passed": bool(acc >= args.agreement_bar),
        "body": body,
        "label_mode": args.label_mode,
        "sign_k": args.sign_k,
        "steps": args.steps,
        "sdf_config": {"latent_dim": cfg.latent_dim, "hidden_dim": cfg.hidden_dim,
                       "num_layers": cfg.num_layers, "part_embed_dim": cfg.part_embed_dim,
                       "trunc": cfg.trunc},
    }
    save_artifact(args.save_path, net, meta)
    if not meta["passed"]:
        print(f"WARNING: sign agreement {acc:.4f} below bar {args.agreement_bar}")
    return meta


if __name__ == "__main__":
    main()
