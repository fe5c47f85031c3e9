"""Stage-2 EgoHMR evaluation CLI (port of egohmr_tpu/eval/test_egohmr.py).

The same flags with the same defaults, the same printed summary keys and the
same `results.pkl` schema, so `tools/visualize_results.py` reads the file.
What differs: `--device` (default `cuda`) takes the place of `--platform`;
`--data_parallel` is accepted and must be false unless the process sees a
single device; `--pointnet_impl fused` means kernel K1 on the card and its
plain version on the CPU; each batch draws its noise from a
`torch.Generator` seeded from `--seed` and the batch index. With
`--device cuda` and no card the CLI fails: it does not carry on on the CPU.

Usage:
  python -m egohmr_tpu_torch.eval.test_egohmr --synthetic --num_samples 5
"""
from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np
import torch

from ..data import pad_batch, synthetic_batch, to_device_batch, to_torch
from ..diffusion import GuidanceConfig, make_schedule
from ..models import BodyRepStats, EgoHMR, EgoHMRConfig, init_random_
from ..nn import cast_params_bf16
from ..smpl import create as smpl_create
from ..smpl import make_synthetic_model
from ..utils.device import resolve_device
from .pipeline import EvalResult, evaluate_batch, sample_bodies

METRIC_NAMES = ("g_mpjpe", "g_mpjpe_vis", "g_mpjpe_invis",
                "mpjpe_all", "mpjpe_vis", "mpjpe_invis",
                "pa_mpjpe_all", "pa_mpjpe_vis", "pa_mpjpe_invis",
                "v2v_all", "v2v_vis", "v2v_invis",
                "std_all", "std_vis", "std_invis",
                "apd_all", "apd_vis", "apd_invis", "coll_ratio", "contact")
# error metrics aggregate weighted by joint/vertex counts (error SUMS over
# the whole split divided by the global count); diversity metrics are plain
# per-image means over the images with a non-empty mask (indicator weights)
WEIGHT_KEY = {"mpjpe_vis": "vis", "pa_mpjpe_vis": "vis", "g_mpjpe_vis": "vis",
              "mpjpe_invis": "invis", "pa_mpjpe_invis": "invis",
              "g_mpjpe_invis": "invis",
              "v2v_vis": "vvis", "v2v_invis": "vinvis",
              "std_vis": "vis_any", "apd_vis": "vis_any",
              "std_invis": "invis_any", "apd_invis": "invis_any"}


def parse_args(argv=None, **default_overrides):
    """Build the stage-2 eval arg set. `default_overrides` replaces flag
    DEFAULTS (not parsed values)."""
    p = argparse.ArgumentParser(description="EgoHMR (stage 2) evaluation")
    b = lambda x: str(x).lower() in ["true", "1"]  # noqa: E731
    p.add_argument("--two_stage", type=b, default=True)
    p.add_argument("--scene_crop_by_stage1_transl", type=b, default=True)
    p.add_argument("--stage1_result_path", type=str, default="")
    p.add_argument("--dataset_root", type=str, default="/mnt/ssd/egobody_release")
    p.add_argument("--dataset_file", type=str, default="")
    p.add_argument("--checkpoint", type=str, default="",
                   help="reference torch .pt/.pth/.ckpt, a checkpoint of the "
                        "port's training CLI, or a .npz param tree written by "
                        "the JAX package's save_npz")
    p.add_argument("--body_rep_stats", type=str, default="",
                   help="preprocess_stats.npz path")
    p.add_argument("--smpl_model_path", type=str, default="data/smpl")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--batch_size", type=int, default=5)
    p.add_argument("--log_freq", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scene_cano", type=b, default=True)
    p.add_argument("--scene_type", type=str, default="cube")
    p.add_argument("--num_diffusion_timesteps", type=int, default=50)
    p.add_argument("--timestep_respacing_eval", type=str, default="ddpm",
                   choices=["ddim5", "ddpm"])
    p.add_argument("--diffuse_fuse", type=b, default=True)
    p.add_argument("--with_coap_grad", type=b, default=True,
                   help="collision-guided sampling")
    p.add_argument("--cond_grad_weight", type=float, default=2.0)
    p.add_argument("--guidance_refresh", type=int, default=1,
                   help="recompute the selection pass of a guided step only "
                        "every N-th such step, reusing it in between "
                        "(1 = exact; 2/4 trade an approximation for speed). "
                        "sdf backend only")
    p.add_argument("--collision_backend", type=str, default="sdf",
                   choices=["sdf", "occupancy", "volsdf"],
                   help="'sdf': exact mesh SDF; the learned backends "
                        "('occupancy', 'volsdf') are not ported yet")
    p.add_argument("--occupancy_ckpt", type=str, default="")
    p.add_argument("--sdfnet_ckpt", type=str, default="")
    p.add_argument("--only_mask_img_cond", type=b, default=True)
    p.add_argument("--pelvis_vis_loosen", type=b, default=True)
    p.add_argument("--gcn_nonlocal_layer", type=b, default=False)
    p.add_argument("--eval_spacing", type=int, default=1)
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--eval_coll_loss", type=b, default=True)
    p.add_argument("--eval_contact_score", type=b, default=True)
    p.add_argument("--eval_with_vis_mask_pa", type=b, default=True)
    p.add_argument("--with_focal_length", type=b, default=True)
    p.add_argument("--with_cam_center", type=b, default=True)
    p.add_argument("--with_bbox_info", type=b, default=True)
    p.add_argument("--add_bbox_scale", type=float, default=1.2)
    p.add_argument("--num_batches", type=int, default=0,
                   help="limit evaluated batches (0 = all)")
    p.add_argument("--save_results", type=b, default=False)
    p.add_argument("--save_root", type=str, default="output_results")
    p.add_argument("--render", type=b, default=False,
                   help="save body-overlay renders for the first batch")
    p.add_argument("--output_render_root", type=str, default="output_render")
    p.add_argument("--bf16", type=b, default=True,
                   help="bfloat16 conditioning + denoiser (BN folded to the "
                        "activation dtype); sampler math, guidance, SMPL and "
                        "metrics stay float32; pass false for the exact-f32 "
                        "parity path")
    p.add_argument("--pointnet_impl", type=str, default="fused",
                   choices=["xla", "fused"],
                   help="scene encoder: 'fused' = the whole-network CUDA "
                        "kernel on the card (bf16 storage), its plain "
                        "version on the CPU; 'xla' = the exact f32 path of "
                        "plain matmuls")
    p.add_argument("--data_parallel", type=b, default=True,
                   help="accepted for the original's command lines; must "
                        "be false when the process sees several devices")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (fails without a card) or 'cpu'")
    if default_overrides:
        known = {a.dest for a in p._actions}
        unknown = set(default_overrides) - known
        assert not unknown, f"unknown default overrides: {sorted(unknown)}"
        p.set_defaults(**default_overrides)
    return p.parse_args(argv)


def _synthetic_model(cfg: EgoHMRConfig) -> EgoHMR:
    """The random weights of a `--synthetic` run, from seed 0."""
    return init_random_(EgoHMR(cfg), seed=0)


def _load_model(checkpoint: str, cfg: EgoHMRConfig) -> EgoHMR:
    """A reference `.pt`/`.pth`/`.ckpt` loads as it is (the port's modules
    use the reference's keys), and so does the model state of a checkpoint
    of the port's training CLI; a `.npz` param tree of the JAX package goes
    through `interop.state_dict_from_jax`. The trained timestep table `pe`,
    which the reference layout leaves out, comes with them where the file
    has it (the training checkpoint's `trained_buffers`, the tree's
    `embed_timestep.pe`)."""
    model = EgoHMR(cfg)
    buffers = {}
    if checkpoint.endswith((".pt", ".pth", ".ckpt")):
        obj = torch.load(checkpoint, map_location="cpu", weights_only=True)
        if isinstance(obj, dict) and "model" in obj:  # the training CLI's
            buffers = obj.get("trained_buffers", {})
            obj = obj["model"]
        elif isinstance(obj, dict) and "state_dict" in obj:
            obj = obj["state_dict"]
        sd = {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}
    elif checkpoint.endswith(".npz"):
        from ..interop import state_dict_from_jax
        from ..utils.checkpoint import load_npz_tree

        tree = load_npz_tree(checkpoint)
        params = tree["params"] if "params" in tree else tree
        sd = state_dict_from_jax(params)
        if "pe" in params.get("embed_timestep", {}):
            buffers = {"embed_timestep.pe": torch.tensor(params["embed_timestep"]["pe"])}
    else:
        raise ValueError(
            f"--checkpoint {checkpoint!r}: the port reads a reference torch "
            ".pt/.pth/.ckpt, a checkpoint of its training CLI or a .npz param "
            "tree. An orbax directory needs the JAX stack: export it there with "
            "egohmr_tpu.utils.checkpoint.save_npz and pass the .npz")
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        for name, t in buffers.items():
            model.get_buffer(name).copy_(t)
    return model


def main(argv=None, **default_overrides):
    args = parse_args(argv, **default_overrides)
    device = resolve_device(args.device, args.data_parallel)
    if args.collision_backend != "sdf":
        raise NotImplementedError(
            f"--collision_backend {args.collision_backend}: the learned "
            "collision backends are not ported yet (ROADMAP slice 7)")

    cfg = EgoHMRConfig(
        only_mask_img_cond=args.only_mask_img_cond,
        pelvis_vis_loosen=args.pelvis_vis_loosen,
        gcn_nonlocal_layer=args.gcn_nonlocal_layer,
        diffuse_fuse=args.diffuse_fuse,
        with_focal_length=args.with_focal_length,
        with_cam_center=args.with_cam_center,
        with_bbox_info=args.with_bbox_info,
        pointnet_impl=args.pointnet_impl,
    )

    respacing = ("" if args.timestep_respacing_eval == "ddpm"
                 else args.timestep_respacing_eval)
    schedule = make_schedule(args.num_diffusion_timesteps, "cosine", respacing).to(device)
    sampler = "ddpm" if respacing == "" else "ddim"
    # the guidance threads into BOTH samplers (DDIM uses the eps-shift form)
    with_guidance = args.with_coap_grad
    guidance = GuidanceConfig(cond_grad_weight=args.cond_grad_weight)

    # ---------------- model + stats
    if args.synthetic:
        smpl_n = smpl_m = smpl_f = make_synthetic_model(num_vertices=6890, device=device)
        model = _synthetic_model(cfg)
        stats = BodyRepStats(mean=torch.zeros(144, device=device),
                             std=torch.ones(144, device=device))
    else:
        smpl_n = smpl_create(args.smpl_model_path, "neutral", device=device)
        smpl_m = smpl_create(args.smpl_model_path, "male", device=device)
        smpl_f = smpl_create(args.smpl_model_path, "female", device=device)
        model = _load_model(args.checkpoint, cfg)
        from ..data.stats import load_stats

        mean, std = load_stats(args.body_rep_stats)
        stats = BodyRepStats(mean=to_torch(mean, device), std=to_torch(std, device))
    if args.bf16:
        model = cast_params_bf16(model)  # once, not per batch
    model = model.to(device, memory_format=torch.channels_last).eval()

    # ---------------- data
    if args.synthetic:
        def batches():
            for i in range(args.num_batches or 4):
                yield (synthetic_batch(args.batch_size, seed=100 + i, device=device),
                       args.batch_size, None)

    else:
        from ..data.egobody import EgoBodyDataset

        test_file = args.dataset_file or os.path.join(
            args.dataset_root, "annotation_egocentric_smpl_npz",
            "egocapture_test_smpl.npz")
        ds = EgoBodyDataset(
            dataset_file=test_file, data_root=args.dataset_root,
            split="test", train=False, spacing=args.eval_spacing,
            scene_type=args.scene_type, scene_cano=args.scene_cano,
            add_scale=args.add_bbox_scale,
            load_stage1_transl=args.two_stage,
            stage1_result_path=args.stage1_result_path,
            scene_crop_by_stage1_transl=args.scene_crop_by_stage1_transl,
        )

        def batches():
            # drop_last=False: evaluate the FULL test split; a short final
            # batch is padded to the batch size and trimmed from the metrics
            it = ds.iter_batches(args.batch_size, shuffle=False, drop_last=False)
            for i, b in enumerate(it):
                if args.num_batches and i >= args.num_batches:
                    break
                n = b["img"].shape[0]
                if n < args.batch_size:
                    b = pad_batch(b, args.batch_size)
                # imgname is host-only (dropped by to_device_batch); keep it
                # alongside for source-frame overlay rendering
                yield to_device_batch(b, device), n, b.get("imgname")

    def run_batch(batch, generator):
        outputs, cond = sample_bodies(
            model, cfg, smpl_n, stats, schedule, batch, generator,
            args.num_samples, sampler=sampler, with_guidance=with_guidance,
            guidance=guidance, use_stage1_transl=args.two_stage,
            collision_backend=args.collision_backend, bf16=args.bf16,
            params_precast=args.bf16,
            guidance_refresh_every=max(1, args.guidance_refresh),
        )
        return evaluate_batch(
            cfg, smpl_n, smpl_m, smpl_f, batch, outputs, cond,
            eval_with_vis_mask_pa=args.eval_with_vis_mask_pa,
            eval_collision=args.eval_coll_loss,
            eval_contact=args.eval_contact_score,
            collision_backend=args.collision_backend,
        ), outputs

    def host(x, n):
        return x.detach().float().cpu().numpy()[:n]

    acc: dict = {}
    weights_acc: dict = {}
    saved = []
    n_images = 0
    # per-image [N, S] invis errors for the smallest-error-sample mode and
    # the reference-schema results.pkl
    minerr_err, minerr_cnt = [], []
    for i, (batch, n_valid, imgnames) in enumerate(batches()):
        generator = torch.Generator(device=device).manual_seed(
            (args.seed * 1_000_003 + i) % (2 ** 63))
        with torch.no_grad():
            res, outputs = run_batch(batch, generator)
        # to the host, dropping padded rows
        res = EvalResult(*(None if v is None else host(v, n_valid) for v in res))
        n_images += n_valid
        minerr_err.append(res.mpjpe_invis)
        minerr_cnt.append(res.invis_count)
        counts = {"vis": res.vis_count, "invis": res.invis_count,
                  "vvis": res.vertex_vis_count, "vinvis": res.vertex_invis_count}
        counts["vis_any"] = (counts["vis"] > 0).astype(np.float32)
        counts["invis_any"] = (counts["invis"] > 0).astype(np.float32)
        for name in METRIC_NAMES:
            v = getattr(res, name)
            if v is None:
                continue
            if name in WEIGHT_KEY:
                w = counts[WEIGHT_KEY[name]]
                w = np.broadcast_to(
                    w.reshape(v.shape[0], *([1] * (v.ndim - 1))), v.shape)
            else:
                w = np.ones_like(v)
            acc.setdefault(name, []).append((v * w).reshape(-1))
            weights_acc.setdefault(name, []).append(w.reshape(-1))
        if args.save_results:
            # reference results.pkl schema: rotmat poses [B,S,.,3,3], betas,
            # per-sample collision/contact, stage-1 pred cam + GT cam
            # translations
            rotmat = host(outputs["pred_pose_rotmat"], n_valid)
            row = {
                "pred_betas_list": host(outputs["pred_betas"], n_valid),
                "pred_global_orient_list": rotmat[:, :, :1],
                "pred_body_pose_list": rotmat[:, :, 1:],
                "gt_cam_full_list": host(batch["smpl_params"]["transl"], n_valid),
                # extra (not in the reference dump): the raw rot6d vector
                "pred_pose_6d": host(outputs["pred_pose_6d"], n_valid),
            }
            if res.coll_ratio is not None:
                row["collision_ratio_list"] = res.coll_ratio
            if res.contact is not None:
                row["contact_ratio_list"] = res.contact
            if args.two_stage and "stage1_transl_full" in batch:
                row["pred_cam_full_list"] = host(batch["stage1_transl_full"], n_valid)
            saved.append(row)
        if args.render and i == 0:
            _render_batch(args, cfg, smpl_n, batch, outputs, imgnames=imgnames)
        if i % max(args.log_freq, 1) == 0:
            g = (np.concatenate(acc["g_mpjpe"]).sum()
                 / max(np.concatenate(weights_acc["g_mpjpe"]).sum(), 1))
            print(f"[batch {i}] images={n_images} G-MPJPE={g*1000:.1f}mm")

    summary = {}
    for name, chunks in acc.items():
        num = np.concatenate(chunks).sum()
        den = np.concatenate(weights_acc[name]).sum()
        scale = 1000.0 if ("mpjpe" in name or "v2v" in name
                           or "std" in name or "apd" in name) else 1.0
        summary[name] = float(num / max(den, 1e-9) * scale)

    # smallest-error-sample-invis mode: per image, pick the sample with the
    # lowest invisible-joint error, then report the global
    # invis-count-weighted error of the selected samples
    if minerr_err:
        err = np.concatenate(minerr_err)  # [N, S] per-image masked means
        cnt = np.concatenate(minerr_cnt)  # [N]
        sel = np.argmin(err, axis=1)
        chosen = err[np.arange(len(err)), sel]
        summary["mpjpe_invis_min_sample"] = float(
            (chosen * cnt).sum() / max(cnt.sum(), 1e-9) * 1000.0)
        print("--------- mode: smallest-error-sample-invis from "
              f"{err.shape[1]} samples ---------")
        print(f"MPJPE-invis: {summary['mpjpe_invis_min_sample']:.2f}")
    print(json.dumps(summary, indent=2))

    if args.save_results:
        # reference layout: {save_root}/output_egohmr_{model_id}/
        # results_seed_{seed}.pkl
        model_id = (os.path.basename(os.path.dirname(args.checkpoint))
                    if args.checkpoint else "synthetic")
        out_dir = os.path.join(args.save_root, f"output_egohmr_{model_id}")
        os.makedirs(out_dir, exist_ok=True)
        out = {k: np.concatenate([r[k] for r in saved])
               for k in saved[0]} if saved else {}
        out_path = os.path.join(out_dir, f"results_seed_{args.seed}.pkl")
        with open(out_path, "wb") as f:
            pickle.dump(out, f, protocol=2)
        print(f"[INFO] pred results saved to {out_dir}.")
    return summary


def _render_batch(args, cfg, smpl, batch, outputs, imgnames=None):
    """Overlay the first sample's body on the SOURCE frame when the jpg
    resolves, falling back to a gray canvas at full resolution otherwise
    (synthetic runs / images missing from the fixture)."""
    from PIL import Image

    from ..viz.renderer import render_on_img

    def host(x):
        return x.detach().float().cpu().numpy()

    os.makedirs(args.output_render_root, exist_ok=True)
    verts = host(outputs["pred_vertices"][:, 0])  # [B, V, 3]
    # samples were generated with the stage-1 translation when present
    # (sample_bodies swaps it in its local copy): render with the same one
    if args.two_stage and "stage1_transl_full" in batch:
        transl = host(batch["stage1_transl_full"])
    else:
        transl = host(batch["smpl_params"]["transl"])
    fx = host(batch["fx"]) * cfg.fx_norm_coeff
    cx = host(batch["cam_cx"])
    cy = host(batch["cam_cy"])
    box_center = host(batch["box_center"]) if "box_center" in batch else None
    box_size = host(batch["box_size"]) if "box_size" in batch else None
    faces = smpl.faces.cpu().numpy()
    H, W = int(cfg.full_img_h), int(cfg.full_img_w)

    for b in range(min(len(verts), 4)):
        name = f"render_{b}.png"
        canvas = None
        if imgnames is not None and b < len(imgnames):
            path = imgnames[b]
            if isinstance(path, str) and os.path.exists(path):
                img = Image.open(path).convert("RGB")
                if img.size != (W, H):
                    img = img.resize((W, H))
                canvas = np.asarray(img, dtype=np.uint8).copy()
                parts = os.path.normpath(path).split(os.sep)
                rec = parts[-4] if len(parts) >= 4 else "img"
                name = f"{rec}_{os.path.basename(path)}.png"
        if canvas is None:
            canvas = np.full((H, W, 3), 32, np.uint8)
        if box_center is not None and box_size is not None:
            # green bbox like the reference's cv2.rectangle
            x0 = int(np.clip(box_center[b][0] - box_size[b] / 2, 0, W - 1))
            x1 = int(np.clip(box_center[b][0] + box_size[b] / 2, 0, W - 1))
            y0 = int(np.clip(box_center[b][1] - box_size[b] / 2, 0, H - 1))
            y1 = int(np.clip(box_center[b][1] + box_size[b] / 2, 0, H - 1))
            t = 3
            # clamp the far-stripe starts: a negative slice start would
            # wrap and paint the stripe on the opposite image edge
            canvas[y0:y0 + t, x0:x1] = (0, 255, 0)
            canvas[max(y1 - t, 0):y1, x0:x1] = (0, 255, 0)
            canvas[y0:y1, x0:x0 + t] = (0, 255, 0)
            canvas[y0:y1, max(x1 - t, 0):x1] = (0, 255, 0)
        out = render_on_img(canvas, verts[b] + transl[b], faces,
                            (fx[b], fx[b]), (cx[b], cy[b]))
        Image.fromarray(out).save(os.path.join(args.output_render_root, name))
    print(f"renders saved to {args.output_render_root}/")


if __name__ == "__main__":
    main()
