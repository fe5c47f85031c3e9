"""Stage-2 EgoHMR training CLI (port of egohmr_tpu/train/train_egohmr.py).

The same flags with the same defaults; `--device` (default `cuda`) takes
the place of `--platform`, and fails without a card: the CLI does not
carry on on the CPU. One eager step per batch (`train/loop.py`) on one
device; `--data_parallel` is accepted and must be false when the process
sees several devices. Checkpoints are the port's own `.pt` files (see
`utils/checkpoint.py`): `<save_dir>/checkpoints/step_<N>.pt` every
`--save_step` steps and at the end, `best_model_vis.pt` at the best
validation error. With `--resume` (default) a run continues from the newest
`step_<N>.pt` at step N+1, with the model, AdamW and the draws' generator as
they were. Metrics go to `metrics.jsonl`, flags to `params.json`.

Runs on the EgoBody release under `--dataset_root`, or `--synthetic` on
generated data.

Usage:
  python -m egohmr_tpu_torch.train.train_egohmr --synthetic --num_steps 20
"""
from __future__ import annotations

import argparse
import os
import time
from dataclasses import replace

import numpy as np
import torch

from ..data import (
    EgoBodyDataset,
    compute_body_rep_stats,
    finalize_batch,
    pad_batch,
    save_stats,
    synthetic_batch,
    to_device_batch,
)
from ..data.prefetch import prefetch_to_device
from ..diffusion import make_schedule, sample_loop
from ..models import (
    BodyRepStats,
    EgoHMR,
    EgoHMRConfig,
    LossWeights,
    compute_condition,
    compute_loss,
    init_random_,
    make_denoise_fn,
    model_outputs,
)
from ..smpl import create as smpl_create
from ..smpl import make_synthetic_model
from ..utils.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from ..utils.device import resolve_device
from ..utils.logging import MetricsWriter, get_logger, save_config
from .loop import TRAINED_BUFFERS, TrainConfig, make_optimizer, make_train_step


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="EgoHMR (stage 2) training")
    b = lambda x: str(x).lower() in ["true", "1"]  # noqa: E731
    p.add_argument("--save_dir", type=str, default="runs_egohmr")
    p.add_argument("--dataset_root", type=str, default="/mnt/ssd/egobody_release")
    p.add_argument("--dataset_file_train", type=str, default="")
    p.add_argument("--dataset_file_val", type=str, default="")
    p.add_argument("--smpl_model_path", type=str, default="data/smpl")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic data (smoke/perf runs)")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_steps", type=int, default=100000)
    p.add_argument("--log_step", type=int, default=1000)
    p.add_argument("--val_step", type=int, default=1000)
    p.add_argument("--save_step", type=int, default=2000)
    p.add_argument("--resume", type=b, default=True)
    p.add_argument("--data_parallel", type=b, default=True,
                   help="accepted for the original's command lines; must be "
                        "false when the process sees several devices")
    p.add_argument("--scene_cano", type=b, default=True)
    p.add_argument("--scene_type", type=str, default="cube",
                   choices=["whole_scene", "cube"])
    p.add_argument("--weight_loss_v2v", type=float, default=0.5)
    p.add_argument("--weight_loss_keypoints_3d", type=float, default=0.05)
    p.add_argument("--weight_loss_keypoints_3d_full", type=float, default=0.02)
    p.add_argument("--weight_loss_keypoints_2d_full", type=float, default=0.01)
    p.add_argument("--weight_loss_betas", type=float, default=0.0005)
    p.add_argument("--weight_loss_body_pose", type=float, default=0.001)
    p.add_argument("--weight_loss_global_orient", type=float, default=0.001)
    p.add_argument("--weight_loss_pose_6d_ortho", type=float, default=0.1)
    p.add_argument("--weight_coap_penetration", type=float, default=0.0002)
    p.add_argument("--start_coap_step", type=int, default=30000,
                   help="step to enable the collision loss")
    p.add_argument("--num_diffusion_timesteps", type=int, default=50)
    p.add_argument("--timestep_respacing_eval", type=str, default="ddim5",
                   choices=["ddim5", "ddpm"])
    p.add_argument("--cond_mask_prob", type=float, default=0.01)
    p.add_argument("--only_mask_img_cond", type=b, default=True)
    p.add_argument("--pelvis_vis_loosen", type=b, default=False)
    p.add_argument("--gcn_nonlocal_layer", type=b, default=False)
    p.add_argument("--with_focal_length", type=b, default=True)
    p.add_argument("--with_cam_center", type=b, default=True)
    p.add_argument("--with_bbox_info", type=b, default=True)
    p.add_argument("--add_bbox_scale", type=float, default=1.2)
    p.add_argument("--do_augment", type=b, default=True)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--mixed_precision", type=b, default=True,
                   help="bf16 forward/backward for the encoders and the "
                        "denoiser; f32 master weights, AdamW state, BatchNorm "
                        "statistics, SMPL and losses, no loss scaling. Pass "
                        "'--mixed_precision false' for f32")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--load_pretrained_ckpt", type=str, default="",
                   help="a reference torch .pt checkpoint whose `backbone.*` "
                        "weights warm-start the backbone")
    p.add_argument("--export_torch", type=str, default="",
                   help="after training, also write the final weights in the "
                        "reference checkpoint layout ({'state_dict': ...} as "
                        ".pt, or a flat .npz)")
    p.add_argument("--load_imagenet_ckpt", type=str, default="",
                   help="torchvision ImageNet resnet state_dict (.pt/.pth or "
                        "flat .npz) for a backbone warm start")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (fails without a card) or 'cpu'")
    return p.parse_args(argv)


def _read_state_dict(path: str) -> dict:
    """A flat {key: tensor} from a torch file (unwrapping {'state_dict':
    ...}) or a flat .npz."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.tensor(z[k]) for k in z.files}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def _load_backbone(model, sd: dict, prefix: str) -> None:
    """Every backbone weight from `sd`'s `prefix`-ed keys, strictly (the
    classifier `fc.*` of an ImageNet file is left out)."""
    sub = {k[len(prefix):]: v for k, v in sd.items()
           if k.startswith(prefix) and not k[len(prefix):].startswith("fc.")}
    model.backbone.load_state_dict(sub, strict=True)


def _export(model, path: str, total_steps: int) -> str:
    """The reference checkpoint layout: {'state_dict': ..., 'total_steps'}
    as .pt, or the state_dict's arrays as a flat .npz."""
    sd = {k: v.detach().cpu().contiguous() for k, v in model.state_dict().items()}
    if path.endswith(".pt"):
        torch.save({"state_dict": sd, "total_steps": total_steps}, path)
        return path
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    return path


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device, args.data_parallel)
    os.makedirs(args.save_dir, exist_ok=True)
    logger = get_logger(args.save_dir)
    save_config(args.save_dir, vars(args))

    cfg = EgoHMRConfig(
        cond_mask_prob=args.cond_mask_prob,
        only_mask_img_cond=args.only_mask_img_cond,
        pelvis_vis_loosen=args.pelvis_vis_loosen,
        gcn_nonlocal_layer=args.gcn_nonlocal_layer,
        with_focal_length=args.with_focal_length,
        with_cam_center=args.with_cam_center,
        with_bbox_info=args.with_bbox_info,
    )
    weights = LossWeights(
        v2v=args.weight_loss_v2v,
        keypoints_3d=args.weight_loss_keypoints_3d,
        keypoints_3d_full=args.weight_loss_keypoints_3d_full,
        keypoints_2d_full=args.weight_loss_keypoints_2d_full,
        betas=args.weight_loss_betas,
        body_pose=args.weight_loss_body_pose,
        global_orient=args.weight_loss_global_orient,
        pose_6d_ortho=args.weight_loss_pose_6d_ortho,
        coap_penetration=args.weight_coap_penetration,
    )
    schedule = make_schedule(args.num_diffusion_timesteps, "cosine", "").to(device)

    # ---------------- data
    if args.synthetic:
        smpl_n = smpl_m = smpl_f = make_synthetic_model(num_vertices=6890, device=device)
        stats = BodyRepStats(torch.zeros(144, device=device), torch.ones(144, device=device))

        def host_batches(start):
            # one batch per step, seeded by the step, so a resumed run
            # continues the stream
            step = start
            while True:
                yield synthetic_batch(args.batch_size, seed=step)
                step += 1
    else:
        smpl_n = smpl_create(args.smpl_model_path, "neutral", device=device)
        smpl_m = smpl_create(args.smpl_model_path, "male", device=device)
        smpl_f = smpl_create(args.smpl_model_path, "female", device=device)
        train_file = args.dataset_file_train or os.path.join(
            args.dataset_root, "annotation_egocentric_smpl_npz", "egocapture_train_smpl.npz")
        ds = EgoBodyDataset(
            dataset_file=train_file, data_root=args.dataset_root, split="train", train=True,
            do_augment=args.do_augment, scene_type=args.scene_type,
            scene_cano=args.scene_cano, add_scale=args.add_bbox_scale)
        mean, std = compute_body_rep_stats(ds.global_orient, ds.body_pose)
        save_stats(os.path.join(args.save_dir, "preprocess_stats", "preprocess_stats.npz"),
                   mean, std)
        stats = BodyRepStats(torch.tensor(mean, device=device), torch.tensor(std, device=device))

        def host_batches(start):  # a resumed run starts a new epoch, as in JAX
            epoch = 0
            while True:
                for b in ds.iter_batches(args.batch_size, seed=epoch):
                    yield finalize_batch(b, smpl_m, smpl_f)
                epoch += 1

    # ---------------- model and optimizer
    model = init_random_(EgoHMR(cfg), seed=args.seed, training=True)
    if args.load_imagenet_ckpt:
        _load_backbone(model, _read_state_dict(args.load_imagenet_ckpt), prefix="")
        logger.info("warm-started backbone from ImageNet ckpt %s", args.load_imagenet_ckpt)
    if args.load_pretrained_ckpt.endswith(".pt"):
        _load_backbone(model, _read_state_dict(args.load_pretrained_ckpt), prefix="backbone.")
        logger.info("warm-started backbone from %s", args.load_pretrained_ckpt)
    model = model.to(device, memory_format=torch.channels_last)
    tcfg = TrainConfig(lr=args.lr, weight_decay=args.weight_decay,
                       mixed_precision=args.mixed_precision)
    optimizer = make_optimizer(model, tcfg)
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)

    start_step = 0
    ckpt_dir = os.path.join(args.save_dir, "checkpoints")
    if args.resume:
        latest = latest_checkpoint(ckpt_dir)
        if latest:
            state = restore_checkpoint(latest)
            model.load_state_dict(state["model"], strict=True)
            with torch.no_grad():
                for name, t in state["trained_buffers"].items():
                    model.get_buffer(name).copy_(t)
            optimizer.load_state_dict(state["optimizer"])
            generator.set_state(state["generator"])
            start_step = int(state["step"]) + 1
            logger.info("resumed from %s at step %d", latest, start_step)

    def checkpoint(name: str, step: int) -> None:
        save_checkpoint(os.path.join(ckpt_dir, name), {
            "model": model.state_dict(),
            "trained_buffers": {n: model.get_buffer(n).detach() for n in TRAINED_BUFFERS},
            "optimizer": optimizer.state_dict(),
            "generator": generator.get_state(),
            "step": step,
        })

    steps = {use: make_train_step(cfg, replace(tcfg, use_collision_loss=use), weights, schedule,
                                  stats, smpl_n, smpl_m, smpl_f, optimizer)
             for use in (False, True)}
    writer = MetricsWriter(args.save_dir)

    # ---------------- validation: the visible-3D-joint error, on which the
    # best model is kept
    eval_respacing = "" if args.timestep_respacing_eval == "ddpm" else args.timestep_respacing_eval
    eval_schedule = make_schedule(args.num_diffusion_timesteps, "cosine", eval_respacing).to(device)
    if args.synthetic:
        val_batches = [(to_device_batch(synthetic_batch(args.batch_size, seed=10_000), device),
                        args.batch_size)]
    else:
        val_file = args.dataset_file_val or os.path.join(
            args.dataset_root, "annotation_egocentric_smpl_npz", "egocapture_val_smpl.npz")
        try:
            val_ds = EgoBodyDataset(
                dataset_file=val_file, data_root=args.dataset_root, split="val", train=False,
                spacing=20, scene_type=args.scene_type, scene_cano=args.scene_cano,
                add_scale=args.add_bbox_scale)
            val_batches = []
            for vb in val_ds.iter_batches(args.batch_size, shuffle=False, drop_last=False):
                n = vb["img"].shape[0]
                val_batches.append((to_device_batch(pad_batch(vb, args.batch_size), device), n))
        except (FileNotFoundError, KeyError) as e:
            logger.warning("no val split (%s); skipping validation", e)
            val_batches = []

    @torch.no_grad()
    def run_validation(val_generator) -> float:
        err_sum, vis_num = 0.0, 0.0
        for vb, n_valid in val_batches:
            cond = compute_condition(model, cfg, vb)
            _, x0 = sample_loop(eval_schedule, make_denoise_fn(model, cfg, cond), val_generator,
                                (vb["img"].shape[0], 144),
                                sampler="ddpm" if eval_respacing == "" else "ddim")
            outputs = model_outputs(cfg, smpl_n, cond, x0, stats)
            _, losses = compute_loss(cfg, weights, smpl_n, smpl_m, smpl_f, vb, cond, outputs,
                                     train=False)
            err_sum += float(losses["loss_keypoints_3d_vis_per_sample"][:n_valid].sum())
            vis_num += float(losses["joint_vis_num_per_sample"][:n_valid].sum())
        return err_sum / max(vis_num, 1.0)

    best_val = float("inf")
    batch_iter = prefetch_to_device(host_batches(start_step), size=2, device=device)
    t0 = time.time()
    for step in range(start_step, args.num_steps):
        batch = next(batch_iter)
        use_coll = args.weight_coap_penetration > 0 and step >= args.start_coap_step
        metrics = steps[use_coll](model, batch, generator)
        if step % args.log_step == 0 or step == args.num_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            writer.write(step, m)
            logger.info("step %d loss %.4f (%.2f s/step)", step, m["loss"],
                        (time.time() - t0) / max(step - start_step + 1, 1))
        if val_batches and step % args.val_step == 0 and step > start_step:
            val_err = run_validation(
                torch.Generator(device=device).manual_seed(args.seed * 1_000_003 + step))
            writer.write(step, {"val_keypoints_3d_vis": val_err})
            logger.info("step %d val vis-3d-joint err %.4f (best %.4f)", step, val_err, best_val)
            if val_err < best_val:
                best_val = val_err
                checkpoint("best_model_vis", step)
        if step % args.save_step == 0 and step > start_step:
            checkpoint(f"step_{step}", step)
    if start_step < args.num_steps:
        checkpoint(f"step_{args.num_steps - 1}", args.num_steps - 1)
    if args.export_torch:
        written = _export(model, args.export_torch, args.num_steps)
        logger.info("exported torch-layout checkpoint to %s", written)
    writer.close()
    logger.info("done")


if __name__ == "__main__":
    main()
