"""Stage-1 ProHMR-scene training CLI (port of
egohmr_tpu/train/train_prohmr.py).

EgoBody batches for the generator and CMU-mocap batches for the
discriminator, one eager G+D step each (`train/prohmr_loop.py`), in
float32. The same flags with the same defaults; `--device` (default
`cuda`) takes the place of `--platform` and fails without a card.

Data parallelism runs one process per card under torchrun, as the stage-2
CLI does: `torchrun --nproc_per_node=N -m
egohmr_tpu_torch.train.train_prohmr ...` with `--data_parallel true` (the
default) and a `--batch_size` (global) that divides by N. Every rank runs
the ActNorm init on the same global batch, so the replicas start equal,
and then keeps its rows of each generator and mocap batch; only rank 0
writes checkpoints, metrics and logs, and on resume every rank loads the
checkpoint, the mocap stream's state included.

As in the JAX package, the first batch sets the flow's ActNorms
(`models.prohmr.initialize`) and training starts on the next one, and the
`--synthetic` mocap stream is `np.random.RandomState(seed)`'s: pose x 0.3,
then betas x 0.5, per step. Checkpoints are the port's own `.pt` files
(`utils/checkpoint.py`): `<save_dir>/checkpoints/step_<N>.pt` every
`--save_step` steps and at the end, with the generator's `state_dict`
(reference layout; its trained `init_betas` and `init_cam` are buffers
there), the discriminator's, both AdamW states, the draws' generator and
the mocap stream's state. With `--resume` (default) a run continues from the
newest one at step N+1, where the JAX CLI restarts its data streams. Step i
takes batch i + 1 of the stream: a synthetic run draws it with `seed = i +
1`, so a resumed synthetic run equals an uninterrupted one bit for bit; a
real-data run takes the same images in the same order, but its augmentation
draws start again from the dataset's seed. Metrics go to `metrics.jsonl`,
flags to `params.json`.

Usage:
  python -m egohmr_tpu_torch.train.train_prohmr --synthetic --num_steps 20
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data import MoCapDataset, finalize_batch, synthetic_batch, to_device_batch, to_torch
from ..data.prefetch import prefetch_to_device
from ..models import Discriminator, init_discriminator_
from ..models.prohmr import ProHMR, ProHMRConfig, ProHMRLossWeights, init_random_, initialize
from ..parallel import barrier, is_main, replicate, rows, shard_batch, shutdown
from ..smpl import create as smpl_create
from ..smpl import make_synthetic_model
from ..utils.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from ..utils.device import resolve_data_parallel
from ..utils.logging import MetricsWriter, NullWriter, get_logger, null_logger, save_config
from .prohmr_loop import make_optimizers, make_prohmr_train_step
from .train_egohmr import _load_backbone, _read_state_dict


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ProHMR-scene (stage 1) training")
    b = lambda x: str(x).lower() in ["true", "1"]  # noqa: E731
    p.add_argument("--save_dir", type=str, default="runs_prohmr")
    p.add_argument("--dataset_root", type=str, default="/mnt/ssd/egobody_release")
    p.add_argument("--dataset_file_train", type=str, default="")
    p.add_argument("--cmu_mocap_file", type=str, default="data/datasets/cmu_mocap.npz")
    p.add_argument("--smpl_model_path", type=str, default="data/smpl")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_steps", type=int, default=100000)
    p.add_argument("--log_step", type=int, default=1000)
    p.add_argument("--save_step", type=int, default=2000)
    p.add_argument("--resume", type=b, default=True)
    p.add_argument("--data_parallel", type=b, default=True,
                   help="data parallelism under torchrun (one process per "
                        "card; --batch_size is the global batch); a no-op in "
                        "one process on one device")
    p.add_argument("--scene_cano", type=b, default=False,
                   help="the whole scene without canonicalisation, as the "
                        "original trains by default")
    p.add_argument("--scene_type", type=str, default="whole_scene")
    p.add_argument("--with_focal_length", type=b, default=True)
    p.add_argument("--with_cam_center", type=b, default=True)
    p.add_argument("--with_bbox_info", type=b, default=True)
    p.add_argument("--with_full_2d_loss", type=b, default=True)
    p.add_argument("--with_global_3d_loss", type=b, default=True)
    p.add_argument("--add_bbox_scale", type=float, default=1.2)
    p.add_argument("--do_augment", type=b, default=True)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--load_imagenet_ckpt", type=str, default="",
                   help="torchvision ImageNet resnet50 state_dict (.pt/.pth or "
                        "flat .npz) for a backbone warm start")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (fails without a card) or 'cpu'")
    return p.parse_args(argv)


def _rng_state(rng: np.random.RandomState) -> dict:
    """A NumPy RandomState's state as tensors and numbers, which
    `torch.load(weights_only=True)` reads back."""
    name, keys, pos, has_gauss, cached = rng.get_state()
    return {"keys": torch.tensor(keys.astype(np.int64)), "pos": int(pos),
            "has_gauss": int(has_gauss), "cached_gaussian": float(cached)}


def _set_rng_state(rng: np.random.RandomState, state: dict) -> None:
    rng.set_state(("MT19937", state["keys"].numpy().astype(np.uint32), state["pos"],
                   state["has_gauss"], state["cached_gaussian"]))


def egobody_batches(ds, batch_size: int, first: int):
    """The EgoBody stream from its batch `first` on: epoch e shuffles by
    seed e, and batch i is batch i mod n of epoch i // n (n batches an
    epoch), so a resumed run takes the images an uninterrupted run would."""
    n = len(ds) // batch_size
    if n == 0:
        raise ValueError(f"{len(ds)} items make no batch of {batch_size}")
    epoch, skip = divmod(first, n)
    while True:
        yield from ds.iter_batches(batch_size, seed=epoch, skip_batches=skip)
        epoch, skip = epoch + 1, 0


def main(argv=None):
    args = parse_args(argv)
    device, dp = resolve_data_parallel(args.device, args.data_parallel,
                                       "egohmr_tpu_torch.train.train_prohmr")
    rows(dp, args.batch_size)  # raises unless the world size divides the batch
    main_rank = is_main(dp)
    if main_rank:
        logger = get_logger(args.save_dir, "prohmr")
        save_config(args.save_dir, vars(args))
    else:
        logger = null_logger()

    cfg = ProHMRConfig(with_focal_length=args.with_focal_length,
                       with_cam_center=args.with_cam_center, with_bbox_info=args.with_bbox_info)
    weights = ProHMRLossWeights(with_full_2d_loss=args.with_full_2d_loss,
                                with_global_3d_loss=args.with_global_3d_loss)

    # ---------------- data: the generator's batches and the mocap stream
    rng_np = np.random.RandomState(args.seed)
    if args.synthetic:
        smpl_n = smpl_m = smpl_f = make_synthetic_model(num_vertices=6890, device=device)

        def host_batches(first):  # batch `seed` i feeds step i - 1; batch 0 the ActNorms
            i = first
            while True:
                yield synthetic_batch(args.batch_size, seed=i)
                i += 1

        def mocap_batch():
            return {"body_pose": rng_np.randn(args.batch_size, 69).astype(np.float32) * 0.3,
                    "betas": rng_np.randn(args.batch_size, 10).astype(np.float32) * 0.5}
    else:
        from ..data import EgoBodyDataset

        smpl_n = smpl_create(args.smpl_model_path, "neutral", device=device)
        smpl_m = smpl_create(args.smpl_model_path, "male", device=device)
        smpl_f = smpl_create(args.smpl_model_path, "female", device=device)
        train_file = args.dataset_file_train or os.path.join(
            args.dataset_root, "annotation_egocentric_smpl_npz", "egocapture_train_smpl.npz")
        ds = EgoBodyDataset(
            dataset_file=train_file, data_root=args.dataset_root, split="train", train=True,
            do_augment=args.do_augment, scene_type=args.scene_type, scene_cano=args.scene_cano,
            add_scale=args.add_bbox_scale)
        mocap = MoCapDataset(args.cmu_mocap_file)

        def host_batches(first):
            for bt in egobody_batches(ds, args.batch_size, first):
                yield finalize_batch(bt, smpl_m, smpl_f)

        def mocap_batch():
            return mocap.sample(args.batch_size, rng_np)

    # ---------------- models and optimizers
    model = init_random_(ProHMR(cfg), seed=args.seed, training=True)
    disc = init_discriminator_(Discriminator(), seed=args.seed + 10)
    if args.load_imagenet_ckpt:
        _load_backbone(model, _read_state_dict(args.load_imagenet_ckpt), prefix="")
        logger.info("warm-started backbone from ImageNet ckpt %s", args.load_imagenet_ckpt)
    model = model.to(device, memory_format=torch.channels_last)
    disc = disc.to(device)
    optimizer, disc_optimizer = make_optimizers(model, disc, args.lr, args.weight_decay)
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)

    start_step = 0
    ckpt_dir = os.path.join(args.save_dir, "checkpoints")
    latest = latest_checkpoint(ckpt_dir) if args.resume else None
    if latest:
        state = restore_checkpoint(latest)
        model.load_state_dict(state["model"], strict=True)
        disc.load_state_dict(state["discriminator"], strict=True)
        optimizer.load_state_dict(state["optimizer"])
        disc_optimizer.load_state_dict(state["disc_optimizer"])
        generator.set_state(state["generator"])
        _set_rng_state(rng_np, state["mocap_rng"])
        start_step = int(state["step"]) + 1
        logger.info("resumed from %s at step %d", latest, start_step)
        host = host_batches(start_step + 1)
    else:
        host = host_batches(0)
        # ActNorm's data-dependent init on the first batch, the whole of it
        # on every rank
        initialize(model, cfg, to_device_batch(next(host), device), scene_cano=args.scene_cano)
    replicate(dp, model)
    replicate(dp, disc)
    # every rank reads the global batch and keeps its rows
    batch_iter = prefetch_to_device((shard_batch(dp, b) for b in host), size=2, device=device)

    def checkpoint(step: int) -> None:
        """Rank 0 writes; every rank waits for the file."""
        if main_rank:
            save_checkpoint(os.path.join(ckpt_dir, f"step_{step}"), {
                "model": model.state_dict(), "discriminator": disc.state_dict(),
                "optimizer": optimizer.state_dict(),
                "disc_optimizer": disc_optimizer.state_dict(),
                "generator": generator.get_state(), "mocap_rng": _rng_state(rng_np),
                "step": step,
            })
        barrier(dp)

    step_fn = make_prohmr_train_step(cfg, weights, smpl_n, smpl_m, smpl_f, optimizer,
                                     disc_optimizer, scene_cano=args.scene_cano, dp=dp)
    writer = MetricsWriter(args.save_dir) if main_rank else NullWriter()
    t0 = time.time()
    for step in range(start_step, args.num_steps):
        batch = next(batch_iter)
        metrics = step_fn(model, disc, batch, to_torch(shard_batch(dp, mocap_batch()), device),
                          generator)
        if step % args.log_step == 0 or step == args.num_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            writer.write(step, m)
            logger.info("step %d loss %.4f disc %.4f (%.2f s/step)", step, m["loss"],
                        m["loss_disc"], (time.time() - t0) / max(step - start_step + 1, 1))
        if step % args.save_step == 0 and step > start_step:
            checkpoint(step)
    if start_step < args.num_steps:
        checkpoint(args.num_steps - 1)
    writer.close()
    logger.info("done")
    shutdown(dp)


if __name__ == "__main__":
    main()
