"""Stage-1 ProHMR-scene evaluation CLI (port of
egohmr_tpu/eval/test_prohmr.py).

The mode-only metrics (`g_mpjpe`, `mpjpe`, `pa_mpjpe`, `v2v`, in mm) of the
z = 0 sample, and `results.pkl` with `pred_cam_full_list`, the mode's
full-image translation per image, which the stage-2 CLI reads with
`--two_stage true --stage1_result_path`. The same flags with the same
defaults; `--device` (default `cuda`) takes the place of `--platform` and
fails without a card. `--pointnet_impl fused` means kernel K1 on the card;
on the CPU the scene encoder is the plain f32 one either way, as in the JAX
package off the TPU. Samples 1.. of each batch are drawn from a
`torch.Generator` seeded from `--seed` and the batch index. A short last
batch is padded to the batch size and trimmed from the results.

Usage:
  python -m egohmr_tpu_torch.eval.test_prohmr --synthetic
"""
from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np
import torch

from ..data import pad_batch, synthetic_batch, to_device_batch
from ..models.prohmr import ProHMR, ProHMRConfig, forward, init_random_
from ..smpl import create as smpl_create
from ..smpl import lbs, make_synthetic_model
from ..utils.device import resolve_device
from .metrics import mpjpe, pa_mpjpe, v2v

# the reference's ProHMR-scene module holds its discriminator: evaluation
# leaves its keys in a released checkpoint out
DISCRIMINATOR_PREFIX = "discriminator."


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ProHMR-scene (stage 1) evaluation")
    b = lambda x: str(x).lower() in ["true", "1"]  # noqa: E731
    p.add_argument("--dataset_root", type=str, default="/mnt/ssd/egobody_release")
    p.add_argument("--dataset_file", type=str, default="")
    p.add_argument("--checkpoint", type=str, default="",
                   help="reference torch .pt/.pth/.ckpt, a checkpoint of the "
                        "port's training CLI, or a .npz param tree written by "
                        "the JAX package's save_npz")
    p.add_argument("--smpl_model_path", type=str, default="data/smpl")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--pointnet_impl", type=str, default="fused", choices=["xla", "fused"],
                   help="scene encoder: 'fused' = the whole-network CUDA kernel "
                        "on the card; 'xla' = the plain f32 encoder")
    p.add_argument("--num_samples", type=int, default=5,
                   help="the mode + (n-1) random samples")
    p.add_argument("--eval_spacing", type=int, default=1)
    p.add_argument("--num_batches", type=int, default=0)
    p.add_argument("--scene_cano", type=b, default=False)
    p.add_argument("--scene_type", type=str, default="whole_scene")
    p.add_argument("--with_focal_length", type=b, default=True)
    p.add_argument("--with_cam_center", type=b, default=True)
    p.add_argument("--with_bbox_info", type=b, default=True)
    p.add_argument("--add_bbox_scale", type=float, default=1.2)
    p.add_argument("--save_results", type=b, default=True)
    p.add_argument("--save_root", type=str, default="output_results/prohmr_scene")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (fails without a card) or 'cpu'")
    return p.parse_args(argv)


def _synthetic_model(cfg: ProHMRConfig) -> ProHMR:
    """The random weights of a `--synthetic` run, from seed 0."""
    return init_random_(ProHMR(cfg), seed=0)


def _load_model(checkpoint: str, cfg: ProHMRConfig) -> ProHMR:
    """A reference `.pt`/`.pth`/`.ckpt` loads as it is, but for the
    discriminator's keys (nflows' own state is taken by `flow.Glow`);
    so does the generator of a checkpoint of the port's training CLI; a
    `.npz` param tree of the JAX package goes through
    `interop.prohmr_state_dict_from_jax`. Every load is strict."""
    if checkpoint.endswith((".pt", ".pth", ".ckpt")):
        obj = torch.load(checkpoint, map_location="cpu", weights_only=True)
        if isinstance(obj, dict) and "model" in obj:  # the training CLI's
            obj = obj["model"]
        elif isinstance(obj, dict) and "state_dict" in obj:
            obj = obj["state_dict"]
        sd = {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)
              and not k.startswith(DISCRIMINATOR_PREFIX)}
    elif checkpoint.endswith(".npz"):
        from ..interop import prohmr_state_dict_from_jax
        from ..utils.checkpoint import load_npz_tree

        tree = load_npz_tree(checkpoint)
        sd = prohmr_state_dict_from_jax(tree["params"] if "params" in tree else tree)
    else:
        raise ValueError(
            f"--checkpoint {checkpoint!r}: the port reads a reference torch "
            ".pt/.pth/.ckpt, a checkpoint of its training CLI or a .npz param "
            "tree. An orbax directory needs the JAX stack: export it there with "
            "egohmr_tpu.utils.checkpoint.save_npz and pass the .npz")
    model = ProHMR(cfg)
    model.load_state_dict(sd, strict=True)
    return model


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = ProHMRConfig(with_focal_length=args.with_focal_length,
                       with_cam_center=args.with_cam_center,
                       with_bbox_info=args.with_bbox_info, pointnet_impl=args.pointnet_impl)

    if args.synthetic:
        smpl_n = smpl_m = smpl_f = make_synthetic_model(num_vertices=6890, device=device)
        model = _synthetic_model(cfg)

        def batches():
            for i in range(args.num_batches or 2):
                yield synthetic_batch(args.batch_size, seed=200 + i, device=device), \
                    args.batch_size
    else:
        smpl_n = smpl_create(args.smpl_model_path, "neutral", device=device)
        smpl_m = smpl_create(args.smpl_model_path, "male", device=device)
        smpl_f = smpl_create(args.smpl_model_path, "female", device=device)
        model = _load_model(args.checkpoint, cfg)
        from ..data.egobody import EgoBodyDataset

        test_file = args.dataset_file or os.path.join(
            args.dataset_root, "annotation_egocentric_smpl_npz", "egocapture_test_smpl.npz")
        ds = EgoBodyDataset(
            dataset_file=test_file, data_root=args.dataset_root, split="test", train=False,
            spacing=args.eval_spacing, scene_type=args.scene_type, scene_cano=args.scene_cano,
            add_scale=args.add_bbox_scale)

        def batches():
            it = ds.iter_batches(args.batch_size, shuffle=False, drop_last=False)
            for i, bt in enumerate(it):
                if args.num_batches and i >= args.num_batches:
                    break
                n = bt["img"].shape[0]
                if n < args.batch_size:
                    bt = pad_batch(bt, args.batch_size)
                yield to_device_batch(bt, device), n
    model = model.to(device, memory_format=torch.channels_last).eval()

    def run_batch(batch, generator):
        out = forward(model, cfg, smpl_n, batch, args.num_samples, generator=generator,
                      scene_cano=args.scene_cano)
        gtp = batch["smpl_params"]
        gt_m = lbs(smpl_m, gtp["betas"], gtp["global_orient"], gtp["body_pose"],
                   transl=gtp["transl"], pose2rot=True)
        gt_f = lbs(smpl_f, gtp["betas"], gtp["global_orient"], gtp["body_pose"],
                   transl=gtp["transl"], pose2rot=True)
        is_f = (batch["gender"] == 1)[:, None, None]
        gt_joints = torch.where(is_f, gt_f.joints, gt_m.joints)[:, :24]
        gt_verts = torch.where(is_f, gt_f.vertices, gt_m.vertices)
        # the mode's metrics; its local joints share the vertices' frame
        pred_full = out.pred_keypoints_3d_full[:, 0, :24]
        pred_local = out.pred_keypoints_3d[:, 0, :24]
        return {"g_mpjpe": mpjpe(pred_full, gt_joints),
                "mpjpe": mpjpe(pred_full, gt_joints, pelvis_align=True),
                "pa_mpjpe": pa_mpjpe(pred_full, gt_joints),
                "v2v": v2v(out.pred_vertices[:, 0], gt_verts, pred_local[:, 0], gt_joints[:, 0]),
                "pred_cam_full": out.pred_cam_t_full[:, 0]}

    acc: dict = {}
    cam_full = []
    for i, (batch, n_valid) in enumerate(batches()):
        generator = torch.Generator(device=device).manual_seed(
            (args.seed * 1_000_003 + i) % (2 ** 63))
        with torch.no_grad():
            res = run_batch(batch, generator)
        res = {k: v.detach().float().cpu().numpy()[:n_valid] for k, v in res.items()}
        cam_full.append(res.pop("pred_cam_full"))
        for k, v in res.items():
            acc.setdefault(k, []).append(v)

    summary = {k: float(np.concatenate(v).mean() * 1000.0) for k, v in acc.items()}
    print(json.dumps(summary, indent=2))
    if args.save_results:
        os.makedirs(args.save_root, exist_ok=True)
        with open(os.path.join(args.save_root, "results.pkl"), "wb") as f:
            pickle.dump({"pred_cam_full_list": np.concatenate(cam_full, axis=0)}, f)
        print(f"saved stage-1 translations to {args.save_root}/results.pkl")
    return summary


if __name__ == "__main__":
    main()
