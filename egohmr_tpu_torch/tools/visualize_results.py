"""Render an evaluation CLI's `results.pkl` in the scene, headless: the port
of the JAX package's `tools/visualize_results.py`, with its flags, views,
colours and file names.

The reference's test_egohmr.py pops an open3d window per image: the
predicted body mesh, the scene point cloud and a coordinate frame in the
physical camera frame. This renders the same composition with the
software rasteriser (`viz/renderer.py:render_mesh_soft`, NumPy) from the
camera and from orbit views, and writes PNGs.

Input is the `results.pkl` of `eval.test_egohmr` (the reference's schema:
`pred_global_orient_list` / `pred_body_pose_list` [N, S, ., 3, 3],
`pred_betas_list`, `pred_cam_full_list` / `gt_cam_full_list`). The bodies
are rebuilt with the SMPL forward (`smpl.lbs`) on `--device` (default
`cuda`, failing without a card; `cpu` on request). The ground-truth body
overlay of the reference viewer needs the live batch (the pkl has no GT
pose), so it is not drawn.

Usage:
  python -m egohmr_tpu_torch.tools.visualize_results \\
      --results output_results/output_egohmr_synthetic/results_seed_0.pkl \\
      --synthetic_smpl --scene scene_points.npy --indices 0 1 --out_dir out/vis
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from ..utils.device import resolve_device

BODY_COLOR = (10.0, 255.0, 255.0)
SCENE_COLOR = (128.0, 128.0, 128.0)
AXIS_COLORS = ((230.0, 60.0, 60.0), (60.0, 230.0, 60.0), (60.0, 60.0, 230.0))


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m egohmr_tpu_torch.tools.visualize_results",
                                description="render results.pkl in scene")
    p.add_argument("--results", required=True, help="results_seed_*.pkl")
    p.add_argument("--scene", default="", help=".npy [P,3] scene points (the "
                   "dataloader's scene_pcd_verts_full; optional)")
    p.add_argument("--smpl_model_path", default="data/smpl")
    p.add_argument("--synthetic_smpl", action="store_true",
                   help="use the synthetic SMPL body (no pkls needed)")
    p.add_argument("--indices", type=int, nargs="*", default=[0])
    p.add_argument("--sample", type=int, default=0,
                   help="which diffusion sample to show (the reference shows "
                        "sample 0)")
    p.add_argument("--img_size", type=int, nargs=2, default=[960, 540])
    p.add_argument("--focal", type=float, default=500.0)
    p.add_argument("--views", nargs="*",
                   default=["camera", "orbit45", "top"],
                   choices=["camera", "orbit45", "orbit-45", "top"])
    p.add_argument("--axis_frame", type=lambda s: s.lower() in ("1", "true"),
                   default=True, help="draw the origin coordinate frame "
                   "(o3d mesh_frame analogue)")
    p.add_argument("--out_dir", default="output_vis")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the SMPL forward runs: 'cuda' (fails without a "
                        "card) or 'cpu'")
    return p.parse_args(argv)


def look_at(eye, target, up=(0.0, -1.0, 0.0)):
    """world->view 4x4 for a camera at `eye` looking at `target` (+z
    forward, +y down: the dataset's camera convention)."""
    eye, target, up = (np.asarray(a, np.float64) for a in (eye, target, up))
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    r = np.stack([right, down, fwd])        # rows = view axes
    t = -r @ eye
    m = np.eye(4)
    m[:3, :3], m[:3, 3] = r, t
    return m


def _axis_frame_quads(size=0.5, n=40):
    """Origin coordinate frame as coloured point runs along +x/+y/+z (the
    o3d create_coordinate_frame analogue)."""
    pts, cols = [], []
    for ax, c in enumerate(AXIS_COLORS):
        run = np.zeros((n, 3))
        run[:, ax] = np.linspace(0.0, size, n)
        pts.append(run)
        cols.append(np.broadcast_to(c, (n, 3)))
    return np.concatenate(pts), np.concatenate(cols)


def compose_and_render(body_verts, faces, scene_points, view, img_size,
                       focal, axis_frame=True, background=24):
    """One z-buffered pass over the body mesh and the scene and axis quads
    (the o3d viewer composes all geometries in one scene)."""
    from ..viz.renderer import _points_to_quads, render_mesh_soft

    w, h = img_size
    cc = (w / 2.0, h / 2.0)
    fl = (focal, focal)
    body = np.asarray(body_verts, np.float64)
    if view is not None:
        body = body @ view[:3, :3].T + view[:3, 3]
    verts = [body]
    tris = [np.asarray(faces, np.int64).reshape(-1, 3)]
    colors = [np.broadcast_to(BODY_COLOR, (len(tris[0]), 3))]

    def add_points(p, c):
        if view is not None:
            p = p @ view[:3, :3].T + view[:3, 3]
        qv, qf = _points_to_quads(np.asarray(p, np.float64), fl)
        tris.append(qf + sum(len(v) for v in verts))
        verts.append(qv)
        colors.append(np.repeat(np.asarray(c, np.float64), 2, axis=0))

    if scene_points is not None and len(scene_points):
        add_points(np.asarray(scene_points, np.float64),
                   np.broadcast_to(SCENE_COLOR, (len(scene_points), 3)))
    if axis_frame:
        fp, fc = _axis_frame_quads()
        add_points(fp, fc)
    canvas = np.full((h, w, 3), background, np.uint8)
    return render_mesh_soft(canvas, np.concatenate(verts),
                            np.concatenate(tris), fl, cc,
                            color=np.concatenate(colors), alpha=0.95)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    from PIL import Image

    from ..smpl import create as smpl_create
    from ..smpl import lbs, make_synthetic_model

    with open(args.results, "rb") as f:
        res = pickle.load(f)
    smpl = (make_synthetic_model(num_vertices=6890, device=device) if args.synthetic_smpl
            else smpl_create(args.smpl_model_path, "neutral", device=device))
    faces = smpl.faces.cpu().numpy()
    scene = np.load(args.scene) if args.scene else None

    def rows(key, i):
        return torch.as_tensor(np.asarray(res[key][i:i + 1, args.sample]), device=device)

    n = len(res["pred_betas_list"])
    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for i in args.indices:
        assert 0 <= i < n, f"index {i} out of range (N={n})"
        # the reference viewer shows the body at the stage-1 predicted
        # camera translation when present, else the GT one
        transl = res.get("pred_cam_full_list", res["gt_cam_full_list"])[i]
        with torch.no_grad():
            out = lbs(smpl, rows("pred_betas_list", i), rows("pred_global_orient_list", i),
                      rows("pred_body_pose_list", i), pose2rot=False)
        v = out.vertices[0].cpu().numpy() + np.asarray(transl)

        centroid = v.mean(0)
        dist = max(2.5, float(np.linalg.norm(centroid)))
        views = {
            "camera": None,
            "orbit45": look_at(centroid + dist * np.array(
                [np.sin(np.pi / 4), -0.15, -np.cos(np.pi / 4)]), centroid),
            "orbit-45": look_at(centroid + dist * np.array(
                [-np.sin(np.pi / 4), -0.15, -np.cos(np.pi / 4)]), centroid),
            "top": look_at(centroid + np.array([0.0, -dist, 1e-3]),
                           centroid, up=(0.0, 0.0, 1.0)),
        }
        for name in args.views:
            img = compose_and_render(v, faces, scene, views[name],
                                     args.img_size, args.focal,
                                     axis_frame=args.axis_frame)
            path = os.path.join(args.out_dir, f"vis_{i:04d}_{name}.png")
            Image.fromarray(img).save(path)
            written.append(path)
    print(f"wrote {len(written)} renders to {args.out_dir}/")
    return written


if __name__ == "__main__":
    main()
