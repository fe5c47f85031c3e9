"""Drive the PyTorch/CUDA port (`egohmr_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device  — require CUDA; print the card's name and power limit
  2. build   — compile every kernel from csrc/ (one nvcc per source, all at
               once)
  3. kernel  — hold K1 (the fused PointNet) and K2 (the nearest-vertex
               argmin) to their plain PyTorch versions on the card at the
               shapes the main paths give them, and time kernel, plain
               version and, for K2, the one-call library route
  4. serve   — serve unguided requests at full width (ResNet-50, 20k scene
               points, 6890-vertex synthetic SMPL, DDIM-5, bf16, random
               weights from a seed) through `serving.Predictor`, counting
               K1's launches, and check the bodies against the f32 pipeline
  5. guided  — serve collision-guided requests at the same width: guided
               DDIM-5 at batch 64 and guided DDPM-50 at batch 16, bf16,
               counting K1's and K2's launches (K2: one per guided step, 4
               and 11 per request), on scenes built so that the unguided
               bodies' legs penetrate them; then check, at raised guidance
               weights, that the guided bodies collide less than the
               unguided ones of the same seed; then time the parts of a
               guided request on their own
Before the last line come a JSON object with one entry per kernel and the
card's name and power limit; the last line is {"ok": true, "device":
{...}}. Nothing runs without a GPU.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

B_TIME, P_FULL, V_FULL = 64, 20000, 6890
# published peaks of one H100 SXM: bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a GPU", file=sys.stderr)
        sys.exit(1)
    import egohmr_tpu_torch  # noqa: F401  (fails here outside a checkout)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # f32 comparisons in full f32: no TF32 in matmuls or in cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
                  f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return smi


def phase_build() -> None:
    from egohmr_tpu_torch import _build

    names = ["pointnet_fused", "nearest_vertex"]
    t0 = time.perf_counter()
    _build.build(names)
    log("build", f"{', '.join(n + '.cu' for n in names)} built for sm_90a in "
                 f"{time.perf_counter() - t0:.1f} s")
    for name in names:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line and "0 bytes spill" not in line:
                log("build", f"{name}: {line.strip()}")


def bound(flops: float, peak: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of operations over
    their peak rate and bytes (inputs once, outputs once) over the memory
    rate, in ms."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def phase_kernel_k1(cfg) -> dict:
    from egohmr_tpu_torch.models import init_random_
    from egohmr_tpu_torch.nn import ResnetPointnet, pointnet_forward
    from egohmr_tpu_torch.nn import pointnet_fused as k1

    enc = init_random_(ResnetPointnet(cfg.scene_feat_dim, cfg.pointnet_hidden_dim),
                       seed=1).cuda().eval()
    g = torch.Generator().manual_seed(2)
    max_err = 0.0
    # the main path's shape, and a small ragged one (neither P is a
    # multiple of the 64-point tile)
    for B, P in ((B_TIME, P_FULL), (3, 4099)):
        pts = torch.randn(B, P, 3, generator=g).cuda()
        got = k1.pointnet_fused_feature(enc, pts)
        torch.cuda.synchronize()
        ref = k1.pointnet_fused_reference(enc, pts)
        err = (got - ref).abs()
        strict = (err <= 5e-5 + 5e-3 * ref.abs()).float().mean().item()
        bar = 2.0 ** -7 * ref.abs().max().item()
        cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1).min().item()
        log("kernel", f"K1 vs plain at B={B}, P={P}: max_abs_err {err.max().item():.3e} "
                      f"(bar {bar:.3e}), {strict * 100:.2f}% of elements within "
                      f"rtol 5e-3/atol 5e-5, min cosine {cos:.7f}")
        if not torch.isfinite(got).all() or err.max().item() > bar or cos < 0.9999:
            fail(f"K1 disagrees with its plain version at B={B}, P={P}")
        max_err = max(max_err, err.max().item())
    log("kernel", "bar: 2^-7 x max|plain| (two bf16 ulps of the largest pooled "
                  "value): the tensor cores sum in another order than cuBLAS's "
                  "f32 GEMM, a few bf16 activations round the other way, and "
                  "the flips carry through three pooled stages")

    pts = torch.randn(B_TIME, P_FULL, 3, generator=g).cuda()
    with torch.no_grad():
        ms = time_ms(lambda: k1.pointnet_fused_feature(enc, pts), reps=10)
        plain_ms = time_ms(lambda: k1.pointnet_fused_reference(enc, pts), reps=5)
        f32_ms = time_ms(lambda: pointnet_forward(enc, pts), reps=5)
    log("kernel", f"B={B_TIME}, P={P_FULL}, median of CUDA-event timings: K1 {ms:.3f} ms, "
                  f"plain emulation {plain_ms:.3f} ms, f32 pointnet_forward {f32_ms:.3f} ms")
    # products per point: fc_pos 3->2H, block 0 (2H->H, H->H, shortcut
    # 2H->H), blocks 1-3 on the point's own half (three H->H each; the
    # pooled half is one row per cloud); bytes: the bf16 points, the bf16
    # weights, the f32 feature
    H = cfg.pointnet_hidden_dim
    macs = 3 * 2 * H + 2 * H * H + H * H + 2 * H * H + 9 * H * H
    n_weights = sum(p.numel() for p in enc.parameters())
    b = bound(2.0 * macs * B_TIME * P_FULL, PEAK_BF16,
              B_TIME * P_FULL * 3 * 2 + n_weights * 2 + B_TIME * H * 4)
    log("kernel", f"K1 bound {b['bound_ms']:.3f} ms by {b['bound_by']} "
                  f"(bf16 tensor-core peak): K1 runs at {b['bound_ms'] / ms * 100:.1f}% of that rate")
    return {"name": "pointnet_fused", "route": "cuda",
            "source": "egohmr_tpu_torch/csrc/pointnet_fused.cu",
            "replaces": "egohmr_tpu/nn/pointnet_fused.py:46",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": None, "f32_pointnet_ms": f32_ms}


def points_near_body(B: int, P: int, V: int, seed: int):
    """A seeded body-sized vertex cloud and points scattered around it."""
    g = torch.Generator().manual_seed(seed)
    verts = torch.randn(B, V, 3, generator=g) * torch.tensor([0.25, 0.5, 0.15])
    near = verts[:, torch.randint(V, (P,), generator=g)]
    pts = near + 0.05 * torch.randn(B, P, 3, generator=g)
    return pts.cuda(), verts.cuda()


def phase_kernel_k2() -> dict:
    from egohmr_tpu_torch.collision import knn as k2

    def dist(pts, verts, idx):
        v = torch.gather(verts, 1, idx[..., None].expand(-1, -1, 3))
        return torch.linalg.norm(pts - v, dim=-1)

    def library(pts, verts):
        # the one-call route: a batched f32 product, then argmin
        v_sq = torch.sum(verts * verts, dim=-1)[:, None, :]
        return torch.baddbmm(v_sq, pts, verts.transpose(1, 2), alpha=-2.0).argmin(-1)

    def k2_bound(B, P, V):
        # per pair the least is three FMAs, 6 flops: with -2 folded into
        # the point, |v|^2 - 2 p.v is one chain of three (the kernel spends
        # four; the compare and select are not counted); f32 points and
        # vertices in, int64 out
        return bound(6.0 * B * P * V, PEAK_F32, B * P * 12 + B * V * 12 + B * P * 8)

    # the shapes the callers give it: guided DDIM-5 (batch 64) and guided
    # DDPM-50 (batch 16) search a body's vertices from 1024 scene points;
    # the metrics search them from the whole cloud, and the cloud from the
    # body (chamfer distance, contact); then a ragged and a tied case
    shapes = {"guided": (B_TIME, 1024, V_FULL), "guided DDPM": (16, 1024, V_FULL),
              "metric": (16, P_FULL, V_FULL), "cloud": (16, V_FULL, P_FULL),
              "ragged": (3, 777, 431), "duplicated": (2, 1500, 5000)}
    max_err, n_differ, timed = 0.0, 0, {}
    for name, (B, P, V) in shapes.items():
        pts, verts = points_near_body(B, P, V if name != "duplicated" else V // 2, seed=P)
        if name == "duplicated":  # v[j + V/2] == v[j]: exact ties
            verts = torch.cat([verts, verts], dim=1)
        before = k2.launches
        got = k2.nearest_vertex_idx(pts, verts)
        if k2.launches != before + 1:
            fail(f"K2 was not launched at the {name} shape")
        torch.cuda.synchronize()
        ref = k2.nearest_vertex_idx_reference(pts, verts)
        differ = int((got != ref).sum())
        d_got, d_ref = dist(pts, verts, got), dist(pts, verts, ref)
        err = (d_got - d_ref).abs().max().item()
        ok = bool(((d_got - d_ref).abs() <= 1e-6 + 1e-5 * d_ref).all())
        in_range = 0 <= int(got.min()) and int(got.max()) < V
        if name == "duplicated":
            ok = ok and differ == 0 and int(got.max()) < V // 2
        log("kernel", f"K2 vs plain, {name} shape B={B}, P={P}, V={V}: {differ} of "
                      f"{B * P} indices differ, max |d_kernel - d_plain| {err:.3e}")
        if not (ok and in_range and got.dtype == torch.int64):
            fail(f"K2 disagrees with its plain version at the {name} shape")
        max_err, n_differ = max(max_err, err), n_differ + differ
        if name in ("guided", "metric", "cloud"):
            if not torch.equal(library(pts, verts), ref):
                log("kernel", f"(the library route's indices differ from the plain "
                              f"version's at the {name} shape)")
            t = {"ms": time_ms(lambda: k2.nearest_vertex_idx(pts, verts), reps=20),
                 "plain_ms": time_ms(lambda: k2.nearest_vertex_idx_reference(pts, verts), reps=5),
                 "library_ms": time_ms(lambda: library(pts, verts), reps=5),
                 **k2_bound(B, P, V)}
            log("kernel", f"K2 at the {name} shape, median of CUDA-event timings: kernel "
                          f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, baddbmm+argmin "
                          f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms by "
                          f"{t['bound_by']} (f32 CUDA-core peak)")
            timed[name] = t
    log("kernel", "bar: indices equal, or where the kernel's f32 order picks another "
                  "vertex at a near-tie, true distances within rtol 1e-5, atol 1e-6; "
                  "duplicated vertices go to the lowest index")
    return {"name": "nearest_vertex", "route": "cuda",
            "source": "egohmr_tpu_torch/csrc/nearest_vertex.cu",
            "replaces": "egohmr_tpu/collision/knn_pallas.py:29",
            "max_abs_err": max_err, "n_idx_differ": n_differ, **timed["guided"],
            "metric_shape": timed["metric"], "cloud_shape": timed["cloud"]}


def phase_serve(cfg) -> int:
    from egohmr_tpu_torch.data import synthetic_batch, to_torch
    from egohmr_tpu_torch.diffusion import make_schedule
    from egohmr_tpu_torch.eval import sample_bodies
    from egohmr_tpu_torch.models import BodyRepStats, EgoHMR, init_random_
    from egohmr_tpu_torch.collision import knn as k2
    from egohmr_tpu_torch.nn import pointnet_fused as k1
    from egohmr_tpu_torch.serving import Predictor
    from egohmr_tpu_torch.smpl import make_synthetic_model

    dev = torch.device("cuda")
    B, V = 64, V_FULL
    t0 = time.perf_counter()
    model = init_random_(EgoHMR(cfg), seed=0).eval()
    smpl = make_synthetic_model(num_vertices=V)
    stats = BodyRepStats(torch.zeros(144), torch.ones(144))
    schedule = make_schedule(50, "cosine", "ddim5")
    pred = Predictor(model, cfg, smpl, stats, schedule, device=dev,
                     batch_size=B, num_samples=1, pointnet_impl="fused")
    full = synthetic_batch(B, num_scene_points=P_FULL, seed=10)
    short = {k: ({kk: vv[:40] for kk, vv in v.items()} if isinstance(v, dict)
                 else v[:40]) for k, v in full.items()}
    stream = [synthetic_batch(B, num_scene_points=P_FULL, seed=12 + i) for i in range(3)]
    pred(full)  # warm-up: cuDNN algorithm selection, allocator growth
    torch.cuda.synchronize()
    log("serve", f"ResNet-{cfg.resnet_layers}, img_feat {cfg.img_feat_dim}, PointNet H="
                 f"{cfg.pointnet_hidden_dim}, GCN {cfg.gcn_hid_dim}x{cfg.gcn_layers}, V={V}, "
                 f"P={P_FULL}, DDIM-5, bf16; set-up and warm-up "
                 f"{time.perf_counter() - t0:.1f} s")

    def check(out, n):
        want = {"pred_pose_6d": (n, 1, 144), "pred_betas": (n, 1, 10),
                "pred_keypoints_3d": (n, 1, 45, 3)}
        for k, shape in want.items():
            if out[k].shape != shape or not np.isfinite(out[k]).all():
                fail(f"{k}: shape {out[k].shape} (want {shape}) or non-finite values")

    k1.launches = k2.launches = 0  # main path starts: count launches from here
    results = []
    for name, batch in (("full request", full), ("short request", short)):
        before = k1.launches
        t = time.perf_counter()
        out = pred(batch, seed=1)
        ms = (time.perf_counter() - t) * 1e3
        n = batch["img"].shape[0]
        check(out, n)
        if k1.launches <= before:
            fail(f"{name}: K1 was not launched")
        results.append(out)
        log("serve", f"{name}: {n} bodies in {ms:.1f} ms ({n / ms * 1e3:.1f} bodies/s), "
                     f"K1 launches {k1.launches - before}")
    before = k1.launches
    t = time.perf_counter()
    outs = list(pred.map_batches(stream, seed=5))
    ms = (time.perf_counter() - t) * 1e3
    for out in outs:
        check(out, B)
    if len(outs) != len(stream) or k1.launches - before != len(stream):
        fail(f"map_batches: {len(outs)} results, K1 launches {k1.launches - before}")
    log("serve", f"map_batches: {len(stream)} requests of {B} in {ms:.1f} ms "
                 f"({len(stream) * B / ms * 1e3:.1f} bodies/s, {ms / len(stream):.1f} ms "
                 f"per request), K1 launches {k1.launches - before}")
    launches = k1.launches  # main path ends
    if k2.launches != 0:
        fail(f"the unguided path launched K2 {k2.launches} times")

    # the padded short request returns the leading rows of the full one
    short_dev = np.abs(results[1]["pred_pose_6d"] - results[0]["pred_pose_6d"][:40]).max()
    log("serve", f"short request vs the same rows of the full one: max abs {short_dev:.3e}")
    if not short_dev <= 2e-4:
        fail("padding leaked into the short request's rows")
    # the bf16 K1 path against the f32 plain pipeline on the same request:
    # the bar of egohmr_tpu's bf16 pipeline test (mean abs < 0.05)
    batch = to_torch(full, dev)
    out32, _ = sample_bodies(model.to(dev), replace(cfg, pointnet_impl="xla"),
                             smpl.to(dev), BodyRepStats(stats.mean.to(dev), stats.std.to(dev)),
                             schedule.to(dev), batch,
                             torch.Generator(device=dev).manual_seed(1), 1,
                             sampler="ddim")
    a = out32["pred_keypoints_3d"].cpu().numpy()
    b = results[0]["pred_keypoints_3d"]
    dev_mean = float(np.mean(np.abs(a - b)))
    log("serve", f"bf16+K1 vs f32 plain pipeline, pred_keypoints_3d: mean abs "
                 f"{dev_mean:.4e} (bar 5e-2), max abs {float(np.max(np.abs(a - b))):.4e}")
    if not dev_mean < 0.05:
        fail("the served bodies stray from the f32 pipeline")
    return launches


def closed_body_model(rings: int = 82, slices: int = 84):
    """The synthetic SMPL tables with a closed surface: an ellipsoid of
    2 + rings x slices vertices (6890, with SMPL's 13,776 faces, at the
    defaults) around the synthetic skeleton, skinned to its nearest joints.
    `make_synthetic_model` draws its faces and blend shapes at random per
    vertex, which gives the collision terms no inside and no outside; this
    one has both, and stays smooth under shape and pose, so a guided body
    can be checked to collide less. Same shapes, same work."""
    from egohmr_tpu_torch.smpl import make_synthetic_model

    V = 2 + rings * slices
    base = make_synthetic_model(num_vertices=V, num_faces=8)
    phi = np.pi * np.arange(1, rings + 1) / (rings + 1)
    th = 2 * np.pi * np.arange(slices) / slices
    ring = np.stack([np.outer(np.sin(phi), np.cos(th)), np.outer(np.sin(phi), np.sin(th)),
                     np.outer(np.cos(phi), np.ones(slices))], -1).reshape(-1, 3)
    unit = np.concatenate([[[0.0, 0.0, 1.0]], ring, [[0.0, 0.0, -1.0]]]).astype(np.float32)
    joints = (base.j_regressor @ base.v_template).numpy()
    v = unit * np.array([0.3, 0.5, 0.2], np.float32) + joints.mean(0)

    def r(i, j):
        return 1 + i * slices + j % slices

    faces = [(0, r(0, j), r(0, j + 1)) for j in range(slices)]
    for i in range(rings - 1):
        for j in range(slices):
            a, b, c, d = r(i, j), r(i, j + 1), r(i + 1, j), r(i + 1, j + 1)
            faces += [(a, c, b), (b, c, d)]
    faces += [(V - 1, r(rings - 1, j + 1), r(rings - 1, j)) for j in range(slices)]
    d2 = ((v[:, None] - joints[None]) ** 2).sum(-1)
    w = np.exp(-(d2 - d2.min(1, keepdims=True)) / 0.02)
    j_reg = np.zeros((24, V), np.float32)
    for k in range(24):
        own = np.where(d2.argmin(1) == k)[0]
        own = own if len(own) else np.array([k % V])
        j_reg[k, own] = 1.0 / len(own)
    # blend shapes that keep the surface smooth: each moves the vertices
    # along their normals by a field linear in the position on the unit
    # sphere, at the random tables' amplitudes (1e-2 and 1e-3)
    rng = np.random.RandomState(0)
    shapedirs = 1e-2 * unit[:, :, None] * (unit @ rng.randn(3, 10))[:, None, :]
    posedirs = 1e-3 * (unit @ rng.randn(3, 207)).T[:, :, None] * unit[None]
    return base._replace(
        shapedirs=torch.tensor(shapedirs.astype(np.float32)),
        posedirs=torch.tensor(posedirs.reshape(207, V * 3).astype(np.float32)),
        v_template=torch.tensor(v), faces=torch.tensor(np.asarray(faces, np.int64)),
        lbs_weights=torch.tensor((w / w.sum(1, keepdims=True)).astype(np.float32)),
        j_regressor=torch.tensor(j_reg))


# guidance weights for the check that guidance lowers collisions: the
# reference's, times the batch (the loss is a batch mean, so each body feels
# 1/B of its own gradient), times 1e5 (see `phase_guided`)
RAISED = {"ddim": dict(ddim_scale=1.0 * 64 * 1e5), "ddpm": dict(cond_grad_weight=2.0 * 16 * 1e5)}
LEG_JOINTS = (1, 2, 4, 5, 7, 8, 10, 11)  # the joints the guidance moves


def phase_guided(cfg) -> dict:
    from egohmr_tpu_torch.collision import (bbox_mask, collision_loss, signed_distance,
                                            topk_scene_points)
    from egohmr_tpu_torch.collision import knn as k2
    from egohmr_tpu_torch.data import synthetic_batch
    from egohmr_tpu_torch.diffusion import GuidanceConfig, make_schedule
    from egohmr_tpu_torch.geometry import rotmat_to_rot6d
    from egohmr_tpu_torch.models import BodyRepStats, EgoHMR, init_random_
    from egohmr_tpu_torch.nn import pointnet_fused as k1
    from egohmr_tpu_torch.serving import MESH_OUTPUT_KEYS, Predictor
    from egohmr_tpu_torch.smpl import vertex_normals

    dev = torch.device("cuda")
    model = init_random_(EgoHMR(cfg), seed=0).eval()
    smpl = closed_body_model()
    smpl_dev = smpl.to(dev)
    if smpl.num_vertices != V_FULL or smpl.faces.shape[0] != 13776:
        fail(f"closed body: {smpl.num_vertices} vertices, {smpl.faces.shape[0]} faces")
    leg = np.isin(smpl.lbs_weights.numpy().argmax(1), LEG_JOINTS)
    # pose statistics around the rest pose (6-D identity, std 0.2: joint
    # angles of some 15 degrees), so the random denoiser's bodies stay one
    # closed surface with an inside
    rest = rotmat_to_rot6d(torch.eye(3).expand(24, 3, 3)).reshape(144)
    stats = BodyRepStats(rest, torch.full((144,), 0.2))

    def predictor(sampler, schedule, B, **kw):
        return Predictor(model, cfg, smpl, stats, schedule, device=dev, batch_size=B,
                         num_samples=1, pointnet_impl="fused", sampler=sampler,
                         output_keys=MESH_OUTPUT_KEYS, **kw)

    def check(out, n):
        want = {"pred_pose_6d": (n, 1, 144), "pred_betas": (n, 1, 10),
                "pred_keypoints_3d": (n, 1, 45, 3), "pred_vertices": (n, 1, V_FULL, 3)}
        for k, shape in want.items():
            if out[k].shape != shape or not np.isfinite(out[k]).all():
                fail(f"{k}: shape {out[k].shape} (want {shape}) or non-finite values")

    def penetrated(batch, out, n_in=1024):
        """The request with its first `n_in` scene points moved into the
        bbox of the legs of `out`'s bodies (canonical frame + translation)."""
        v = out["pred_vertices"][:, 0][:, leg]
        lo, hi = v.min(1, keepdims=True), v.max(1, keepdims=True)
        u = np.random.RandomState(0).rand(v.shape[0], n_in, 3).astype(np.float32)
        scene = batch["scene_pcd_verts_full"].copy()
        scene[:, :n_in] = lo + (hi - lo) * u + batch["smpl_params"]["transl"][:, None]
        return {**batch, "scene_pcd_verts_full": scene}

    def losses(out, batch):
        """Per-body collision loss of the served meshes against the 4096
        scene points nearest the body's origin, the guidance's own set:
        (mean over those points, mean over the ones in the body's bbox as
        the guidance scores it, number of points inside the body)."""
        v = torch.tensor(out["pred_vertices"][:, 0]).to(dev)
        scene = torch.tensor(batch["scene_pcd_verts_full"]
                             - batch["smpl_params"]["transl"][:, None]).to(dev)
        pts = topk_scene_points(scene, 4096)
        sdf = signed_distance(pts, v, vertex_normals(v, smpl_dev.faces))
        return (collision_loss(sdf).cpu().numpy(),
                collision_loss(sdf, bbox_mask(pts, v).float()).cpu().numpy(),
                (sdf < 0).sum(-1).cpu().numpy())

    def short_of(batch, n):
        return {k: ({kk: vv[:n] for kk, vv in v.items()} if isinstance(v, dict) else v[:n])
                for k, v in batch.items()}

    runs = [("ddim", make_schedule(50, "cosine", "ddim5"), 64, 4, [64, 40]),
            ("ddpm", make_schedule(50, "cosine", ""), 16, 11, [16])]
    served = []
    for sampler, schedule, B, _, _ in runs:
        # a scene that the unguided body penetrates: 1024 of its points go
        # into the bbox of that body's legs
        free = predictor(sampler, schedule, B)
        batch = synthetic_batch(B, num_scene_points=P_FULL, seed=20)
        batch = penetrated(batch, free(batch, seed=1))
        pred = predictor(sampler, schedule, B, with_guidance=True)
        pred(batch)  # warm-up: cuDNN algorithm selection, allocator growth
        served.append((pred, batch, free))
    torch.cuda.synchronize()

    k1.launches = k2.launches = 0  # main path starts: count launches from here
    for i, (sampler, schedule, B, n_guided, sizes) in enumerate(runs):
        pred, batch, free = served[i]
        for n in sizes:
            b1, b2 = k1.launches, k2.launches
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = pred(batch if n == B else short_of(batch, n), seed=1)
            ms = (time.perf_counter() - t) * 1e3
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            check(out, n)
            d1, d2 = k1.launches - b1, k2.launches - b2
            log("guided", f"{sampler} x{schedule.num_timesteps}, batch {B}, bf16: {n} bodies in "
                          f"{ms:.1f} ms ({n / ms * 1e3:.1f} bodies/s), K1 launches {d1}, "
                          f"K2 launches {d2}, peak memory {peak:.0f} MiB")
            if d1 != 1 or d2 != n_guided:
                fail(f"guided {sampler}: K1 launched {d1} times (want 1), K2 {d2} "
                     f"(want {n_guided}, one per guided step)")
            if n == B:
                served[i] = (pred, batch, free, out)
    counts = {"k1": k1.launches, "k2": k2.launches}  # main path ends

    # Guidance acted. With random weights the denoiser's x0 barely follows
    # x_t, so of the guided steps' shifts only the last one lands on the
    # served body, and its size is (1 - abar_0) / sqrt(abar_0) = 1.9e-3
    # (DDIM) or 0.02 (DDPM) times a gradient of some 1e-4 (a batch mean of
    # squared depths of centimetres): at the reference weights that is
    # below one bf16 step of x_t, and the served bodies differ from the
    # unguided ones by rounding flips. Those readings are printed, held only
    # to "the pose differs". The bar is at the RAISED weights, where the
    # shift is centimetres, on the request as served (bf16) and in f32:
    # against the unguided bodies of the same seed, the mean collision loss
    # falls by over 1% and at least 80% of the bodies collide less. The
    # loss is the mean over the guidance's 4096 points; the mean over the
    # points in the body's bbox, whose count moves with the body, is
    # printed beside it.
    for (sampler, schedule, B, _, _), (pred, batch, free, out) in zip(runs, served):
        unguided = free(batch, seed=1)
        lf, mf, inside = losses(unguided, batch)
        log("guided", f"{sampler}: scene with 1024 points in the unguided legs' bbox: "
                      f"{inside.mean():.0f} points inside a body (least {inside.min()}), "
                      f"unguided collision loss {lf.mean():.6e} (least {lf.min():.3e})")
        if not lf.min() > 0:
            fail(f"guided {sampler}: an unguided body does not penetrate its scene")
        moved = float(np.abs(out["pred_pose_6d"] - unguided["pred_pose_6d"]).max())
        lg, mg, _ = losses(out, batch)
        log("guided", f"{sampler}, bf16, reference weights: guided vs unguided pose max abs "
                      f"{moved:.3e}; collision loss guided {lg.mean():.6e}, unguided "
                      f"{lf.mean():.6e} (in-bbox mean {mg.mean():.6e}, {mf.mean():.6e})")
        if not moved > 0:
            fail(f"guided {sampler}: the guidance changed nothing")
        raised = GuidanceConfig(**RAISED[sampler])
        for bf16 in (True, False):
            if not bf16:
                unguided = predictor(sampler, schedule, B, bf16=False)(batch, seed=1)
                lf, mf, _ = losses(unguided, batch)
            got = predictor(sampler, schedule, B, bf16=bf16, with_guidance=True,
                            guidance=raised)(batch, seed=1)
            check(got, B)
            moved = float(np.abs(got["pred_vertices"] - unguided["pred_vertices"]).max())
            lg, mg, _ = losses(got, batch)
            better, drop = int((lg < lf).sum()), 1.0 - lg.mean() / lf.mean()
            log("guided", f"{sampler}, {'bf16' if bf16 else 'f32'}, raised weights {RAISED[sampler]}: "
                          f"vertices moved by up to {moved:.3e} m; collision loss guided "
                          f"{lg.mean():.6e}, unguided {lf.mean():.6e}: down {drop * 100:.2f}% "
                          f"(bar 1%), {better} of {B} bodies collide less (bar {0.8 * B:.0f}); "
                          f"in-bbox mean {mg.mean():.6e}, {mf.mean():.6e}, "
                          f"{int((mg < mf).sum())} of {B} less")
            if not (drop > 0.01 and better >= 0.8 * B):
                fail(f"guided {sampler}: the guided bodies do not collide less than the "
                     "unguided ones")
    for (sampler, schedule, B, n_guided, _), (pred, batch, _, _) in zip(runs, served):
        breakdown(f"{sampler} x{schedule.num_timesteps}, batch {B}", pred, batch, n_guided)
    return counts


def breakdown(name: str, pred, batch, n_guided: int) -> None:
    """Time the parts of one guided request on their own (CUDA events
    around each part, median of 5 after 2 warm-ups, so a part's time holds
    the gaps in which the card waits for the host), and the whole request
    under the profiler (kernel time and kernel count)."""
    from egohmr_tpu_torch.collision import (bbox_mask, nearest_vertex,
                                            topk_scene_points_near_body)
    from egohmr_tpu_torch.data import to_torch
    from egohmr_tpu_torch.eval.pipeline import _to_f32
    from egohmr_tpu_torch.geometry import rot6d_to_rotmat
    from egohmr_tpu_torch.models import (compute_condition, make_denoise_fn,
                                         make_guidance_fn, model_outputs)
    from egohmr_tpu_torch.smpl import lbs, vertex_normals

    model, cfg, smpl, stats = pred._model, pred.cfg, pred._smpl, pred._stats
    dev_batch = to_torch(batch, pred.device)
    dev_batch["img"] = dev_batch["img"].to(torch.bfloat16)
    B = dev_batch["img"].shape[0]
    with torch.no_grad():
        cond = compute_condition(model, cfg, dev_batch)
        raw = make_denoise_fn(model, cfg, cond)
        cond32 = _to_f32(cond)
        guide = make_guidance_fn(model, cfg, smpl, cond32, stats, selection_refresh_every=2)
        x = torch.randn(B, 144, generator=torch.Generator().manual_seed(3)).to(pred.device)
        t = torch.zeros(B, dtype=torch.int64, device=pred.device)
        rot = rot6d_to_rotmat(x, "diffusion").reshape(B, 24, 3, 3)
        verts = lbs(smpl, cond32.pred_betas, rot[:, :1], rot[:, 1:], pose2rot=False).vertices
        scene = cond32.scene_pcd[:, :4096].contiguous()
        pts = topk_scene_points_near_body(scene, verts, 1024)
        _, sel = guide.fn(x, t, None, True)
        parts = {
            "conditioning (ResNet-50, K1, heads)":
                lambda: compute_condition(model, cfg, dev_batch),
            "one denoiser step (GCN on 2B rows)":
                lambda: raw(x.to(torch.bfloat16), t).float(),
            "one guided step, whole (selection + gradient)":
                lambda: guide.fn(x, t, None, True),
            "  selection: full LBS":
                lambda: lbs(smpl, cond32.pred_betas, rot[:, :1], rot[:, 1:], pose2rot=False),
            "  selection: vertex normals": lambda: vertex_normals(verts, smpl.faces),
            "  selection: per-step top-1024 (stable sort of 4096)":
                lambda: topk_scene_points_near_body(scene, verts, 1024),
            "  selection: bbox mask": lambda: bbox_mask(pts, verts),
            "  selection: nearest vertex (K2, gather, norm)":
                lambda: nearest_vertex(pts, verts),
            "  gradient: selective re-pose, loss, autograd":
                lambda: guide.fn(x, t, sel, False),
            "outputs (SMPL, reprojection)":
                lambda: model_outputs(cfg, smpl, cond32, x, stats),
        }
        for label, fn in parts.items():
            log("guided", f"{name}: {label}: {time_ms(fn, reps=5):.3f} ms")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pred(batch, seed=1)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_ms = sum(e.self_device_time_total for e in events) / 1e3
    n_kernels = sum(e.count for e in events)
    if kernel_ms > 0:
        log("guided", f"{name}: one request under the profiler: {kernel_ms:.1f} ms of kernels "
                      f"and copies in {n_kernels} launches ({n_guided} guided steps)")
    else:
        log("guided", f"{name}: the profiler recorded no device time: not measured")


def main() -> None:
    smi = phase_device()
    from egohmr_tpu_torch.models import EgoHMRConfig

    cfg = EgoHMRConfig()  # full width: ResNet-50, H=256, GCN 1024x4
    phase_build()
    kernels = [phase_kernel_k1(cfg), phase_kernel_k2()]
    unguided = phase_serve(cfg)
    guided = phase_guided(cfg)
    # launches: over both main paths, each counted from 0 just before it
    kernels[0].update(launches=unguided + guided["k1"], launches_unguided=unguided,
                      launches_guided=guided["k1"])
    kernels[1].update(launches=guided["k2"], launches_unguided=0,
                      launches_guided=guided["k2"])
    for k in kernels:
        if k["launches"] < 1:
            fail(f"{k['name']} was never launched on a main path")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
