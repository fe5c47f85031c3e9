"""Drive the PyTorch/CUDA port (`egohmr_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device  — require CUDA; print the card's name and power limit
  2. build   — compile every kernel from csrc/ (one nvcc per source, all at
               once)
  3. kernel  — hold K1 (the fused PointNet), K2 (the nearest-vertex
               argmin) and K3 (the matmul-rate probe, all six variants) to
               their plain PyTorch versions on the card at the shapes the
               main paths give them, and time kernel, plain version and,
               where there is one, the one-call library route; then run
               the probe proper (`tools/probe_int8_mma.py`, its defaults)
               and hold each variant to its peak and to cuBLAS's rate on
               one 8192^3 product
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
  6. eval    — run the evaluation CLI (`eval/test_egohmr.py`) at the same
               width, 8 images x 5 samples x 2 batches of synthetic data:
               unguided DDIM-5 and the CLI's own defaults (guided DDPM-50),
               bf16 with K1, counting K1's and K2's launches (K1 once and K2
               twice per batch in `evaluate_batch`, plus one K2 per guided
               step), on data with every other body moved to the image's edge
               so that the keys over invisible joints average over dozens of
               them; hold K2 to its plain version on the bodies and scenes
               `evaluate_batch` gives it, and each summary and its NaN pattern
               to the f32 plain run of the same images and noise on the card
               (error metrics within 5 mm); show where the bf16 run's larger
               diversity comes from; time `evaluate_batch` and K2 inside it
  7. train   — stage-2 training at the same width, batch 16: ms per step
               in f32 (TF32 off) and bf16-mixed, imgs/s, peak memory; one
               step with the collision loss (K2 once, counted by its wrapper
               and by the profiler, held to its plain version on that step's
               own inputs and timed at [16, 4096] x 6890); the bf16 gradient
               against the f32 one on the same draws, its cosine held to the
               JAX package's on the same weights, batch and draws; the loss
               falling over 100 bf16 steps on one batch; the training CLI, 2
               steps resumed to 4 with the collision loss from step 2 (K1 0,
               K2 2 launches)
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
# published peaks of one H100 SXM: bf16 and int8 tensor cores, f32 CUDA
# cores, HBM3
PEAK_BF16, PEAK_INT8, PEAK_F32, PEAK_BYTES = 989e12, 1979e12, 67e12, 3.35e12


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

    names = ["pointnet_fused", "nearest_vertex", "probe_mma"]
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
    from egohmr_tpu_torch.nn import ResnetPointnet, cast_params_bf16, pointnet_forward
    from egohmr_tpu_torch.nn import pointnet_fused as k1

    enc = init_random_(ResnetPointnet(cfg.scene_feat_dim, cfg.pointnet_hidden_dim),
                       seed=1).cuda().eval()
    g = torch.Generator().manual_seed(2)
    max_err = 0.0
    # the serving paths' shape, the evaluation path's (a batch of 8 images),
    # and a small ragged one (no P is a multiple of the 128-point tile)
    for B, P in ((B_TIME, P_FULL), (8, P_FULL), (3, 4099)):
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
    enc16, pts16 = cast_params_bf16(enc), pts.to(torch.bfloat16)
    with torch.no_grad():
        ms = time_ms(lambda: k1.pointnet_fused_feature(enc, pts), reps=10)
        plain_ms = time_ms(lambda: k1.pointnet_fused_reference(enc, pts), reps=5)
        f32_ms = time_ms(lambda: pointnet_forward(enc, pts), reps=5)
        # the many-call route: the port's plain encoder in bf16 on cuBLAS
        bf16_ms = time_ms(lambda: pointnet_forward(enc16, pts16), reps=5)
        small = {B: time_ms(lambda: k1.pointnet_fused_feature(enc, pts[:B]), reps=10)
                 for B in (16, 8)}
    log("kernel", f"B={B_TIME}, P={P_FULL}, median of CUDA-event timings: K1 {ms:.3f} ms, "
                  f"plain emulation {plain_ms:.3f} ms, f32 pointnet_forward {f32_ms:.3f} ms, "
                  f"bf16 pointnet_forward (cuBLAS, many calls) {bf16_ms:.3f} ms; "
                  f"K1 at B=16 {small[16]:.3f} ms, at B=8 {small[8]:.3f} ms")
    # K1's launches by kernel, under the profiler. The pool kernel of the
    # first form (a serial walk over per-tile partial maxes) is gone: the
    # max is merged by atomicMax, and context_kernel only decodes it and
    # computes the pooled-context rows.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        k1.pointnet_fused_feature(enc, pts)
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            name = e.key.replace("void ", "").replace("(anonymous namespace)::", "")
            name = name.split("(")[0][:48]
            parts[name] = parts.get(name, 0.0) + e.self_device_time_total / 1e3
    if parts:
        log("kernel", "K1 by kernel, one call under the profiler, ms: "
                      + ", ".join(f"{k} {v:.3f}" for k, v in sorted(parts.items()))
                      + "; no pool kernel: context_kernel, 4 launches, decodes the max")
    else:
        log("kernel", "K1 by kernel: the profiler recorded no device time: not measured")
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
            "library_ms": None, "f32_pointnet_ms": f32_ms, "bf16_pointnet_ms": bf16_ms,
            "ms_b16": small[16], "ms_b8": small[8], "by_kernel_ms": parts}


def points_near_body(B: int, P: int, V: int, seed: int):
    """A seeded body-sized vertex cloud and points scattered around it."""
    g = torch.Generator().manual_seed(seed)
    verts = torch.randn(B, V, 3, generator=g) * torch.tensor([0.25, 0.5, 0.15])
    near = verts[:, torch.randint(V, (P,), generator=g)]
    pts = near + 0.05 * torch.randn(B, P, 3, generator=g)
    return pts.cuda(), verts.cuda()


def k2_agrees(pts, verts, got, ref):
    """K2's indices against the plain version's: the count that differ, the
    largest gap between the true distances to the two picks, and whether
    every gap is within rtol 1e-5, atol 1e-6 (a near-tie that the kernel's
    f32 order resolves the other way)."""
    def dist(idx):
        v = torch.gather(verts, 1, idx[..., None].expand(-1, -1, 3))
        return torch.linalg.norm(pts - v, dim=-1)

    d_got, d_ref = dist(got), dist(ref)
    gap = (d_got - d_ref).abs()
    in_range = 0 <= int(got.min()) and int(got.max()) < verts.shape[1]
    ok = bool((gap <= 1e-6 + 1e-5 * d_ref).all()) and in_range and got.dtype == torch.int64
    return int((got != ref).sum()), gap.max().item(), ok


def phase_kernel_k2() -> dict:
    from egohmr_tpu_torch.collision import knn as k2

    def library(pts, verts):
        # the one-call route: a batched f32 product, then argmin
        v_sq = torch.sum(verts * verts, dim=-1)[:, None, :]
        return torch.baddbmm(v_sq, pts, verts.transpose(1, 2), alpha=-2.0).argmin(-1)

    def k2_bound(B, P, V):
        # per pair the least is three FMAs, 6 flops: with -2 folded into
        # the vertex, |v|^2 - 2 p.v is one chain of three (the kernel's min
        # is not counted); f32 points and vertices in, int64 out
        return bound(6.0 * B * P * V, PEAK_F32, B * P * 12 + B * V * 12 + B * P * 8)

    # the shapes the callers give it: guided DDIM-5 (batch 64) and guided
    # DDPM-50 (batch 16) search a body's vertices from 1024 scene points;
    # the metrics search them from the whole cloud, and the cloud from the
    # body (chamfer distance, contact), at 16 clouds and at the evaluation
    # path's 8 images x 5 samples; then a ragged and a tied case
    shapes = {"guided": (B_TIME, 1024, V_FULL), "guided DDPM": (16, 1024, V_FULL),
              "metric": (16, P_FULL, V_FULL), "cloud": (16, V_FULL, P_FULL),
              "eval metric": (40, P_FULL, V_FULL), "eval cloud": (40, V_FULL, P_FULL),
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
        differ, err, ok = k2_agrees(pts, verts, got, ref)
        if name == "duplicated":
            ok = ok and differ == 0 and int(got.max()) < V // 2
        log("kernel", f"K2 vs plain, {name} shape B={B}, P={P}, V={V}: {differ} of "
                      f"{B * P} indices differ, max |d_kernel - d_plain| {err:.3e}")
        if not ok:
            fail(f"K2 disagrees with its plain version at the {name} shape")
        max_err, n_differ = max(max_err, err), n_differ + differ
        if name in ("guided", "guided DDPM", "metric", "cloud", "eval metric", "eval cloud"):
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
            "guided_ddpm_shape": timed["guided DDPM"],
            "metric_shape": timed["metric"], "cloud_shape": timed["cloud"],
            "eval_metric_shape": timed["eval metric"], "eval_cloud_shape": timed["eval cloud"]}


def phase_kernel_k3() -> dict:
    from egohmr_tpu_torch.tools import probe_int8_mma as k3

    dev = torch.device("cuda")
    G = 32
    inputs = k3.make_inputs(seed=0, device=dev)
    max_err = 0.0
    for name in k3.VARIANTS:
        ops = list(inputs[name])
        if name.startswith("B"):
            ops[0] = ops[0].clone()
            ops[0][5, 7] = 127  # the perturbed variant's add wraps here
        for r in (1, 2, 7):
            before = k3.launches
            got = k3.run(name, r, G, *ops)
            if k3.launches != before + 1:
                fail(f"K3 {name} was not launched")
            torch.cuda.synchronize()
            ref = k3.plain(name, r, G, *ops)
            if got.shape != (G, 1, k3.N) or got.dtype != ref.dtype:
                fail(f"K3 {name}: result {tuple(got.shape)} {got.dtype}")
            err = (got.double() - ref.double()).abs().max().item()
            if got.dtype == torch.int32:
                ok, how = torch.equal(got, ref), "equal element for element"
            elif name.startswith("A"):
                ok = bool(torch.isclose(got, ref, rtol=1e-4, atol=1e-4).all())
                how = "within rtol 1e-4 of the plain f32 sum"
                max_err = max(max_err, err)
            else:
                close = torch.isclose(got, ref, rtol=1e-5, atol=1e-7).float().mean().item()
                ok = close >= 0.999 and bool(torch.isclose(got, ref, rtol=2e-2, atol=1e-3).all())
                how = (f"{close * 100:.3f}% of elements within rtol 1e-5 (bar 99.9%; the "
                       "rest within one quantisation step, rtol 2e-2)")
                max_err = max(max_err, err)
            log("kernel", f"K3 {name} vs plain, M,K,N={k3.M},{k3.K},{k3.N}, G={G}, R={r}: "
                          f"max abs err {err:.3e}, {how}")
            if not ok:
                fail(f"K3 {name} disagrees with its plain version at R={r}")

    # the probe proper, through its entry point: this is K3's main path
    k3.launches = 0
    results = k3.main([])
    launches = k3.launches
    torch.cuda.synchronize()
    for name in k3.VARIANTS:
        res = results[name]
        if res.get("hoisted"):
            log("kernel", f"K3 probe {name}: hoisted (t(R1) {res['t_r1_ms']} ms, t(R2) "
                          f"{res['t_r2_ms']} ms): no rate")
            continue
        peak, unit = ((PEAK_INT8, "TOPS") if name in k3.INT8_VARIANTS else (PEAK_BF16, "TFLOP/s"))
        share = k3.flop() / (res["us_per_matmul"] * 1e-6) / peak
        log("kernel", f"K3 probe {name}: {res['us_per_matmul']} us per product, "
                      f"{res['tflops']} {unit}, {res['pct_bf16_peak']}% of the bf16 peak, "
                      f"{res['pct_int8_peak']}% of the int8 peak")
        if share > k3.CLOCK_HEADROOM:
            fail(f"K3 probe {name} reads {share * 100:.1f}% of its peak, more than "
                 "the card's highest clock allows")
    log("kernel", f"K3 probe: int8_speedup_pure {results.get('int8_speedup_pure')}, "
                  f"int8_speedup_with_glue {results.get('int8_speedup_with_glue')}")
    if "us_per_matmul" not in results["A_bf16"]:
        fail("K3 probe: variant A_bf16 gave no rate")

    # yardsticks, all per [M, K] x [K, N] product: the plain version's loop
    # (two chain lengths, one chain), and the one PyTorch call that computes
    # a single product, bf16 and int8, in a stream of 200 calls: at 268 MFLOP
    # a call these are launch-bound, a time per call and not a rate
    x, w = inputs["A_bf16"]
    xq, wq = inputs["B_int8"]
    t_short = time_ms(lambda: k3.plain("A_bf16", 8, 1, x, w), reps=5)
    t_long = time_ms(lambda: k3.plain("A_bf16", 40, 1, x, w), reps=5)
    plain_ms = (t_long - t_short) / 32

    def stream(fn, n=200):
        return time_ms(lambda: [fn() for _ in range(n)], reps=5) / n

    lib_bf16 = stream(lambda: torch.matmul(x, w))
    lib_int8 = stream(lambda: torch._int_mm(xq, wq))
    # the rate yardstick: what cuBLAS reaches on this card at this power
    # limit, on one 8192^3 product (not the probe's function)
    big = 8192
    g = torch.Generator(device=dev).manual_seed(0)
    a16 = torch.randn(big, big, device=dev, generator=g).to(torch.bfloat16)
    b16 = torch.randn(big, big, device=dev, generator=g).to(torch.bfloat16)
    a8 = torch.randint(-127, 128, (big, big), device=dev, generator=g, dtype=torch.int8)
    # B column-major (the TN layout cuBLASLt's int8 kernels take): with B
    # row-major `_int_mm` takes a path some 7x slower
    b8 = torch.randint(-127, 128, (big, big), device=dev, generator=g,
                       dtype=torch.int8).t().contiguous().t()
    rate_bf16 = 2.0 * big ** 3 / (time_ms(lambda: torch.matmul(a16, b16), reps=5) * 1e-3)
    rate_int8 = 2.0 * big ** 3 / (time_ms(lambda: torch._int_mm(a8, b8), reps=5) * 1e-3)
    del a16, b16, a8, b8
    log("kernel", f"rate yardstick, cuBLAS on one {big}^3 product, median of 5 CUDA-event "
                  f"timings: torch.matmul bf16 {rate_bf16 / 1e12:.1f} TFLOP/s "
                  f"({rate_bf16 / PEAK_BF16 * 100:.1f}% of the peak), torch._int_mm int8 "
                  f"{rate_int8 / 1e12:.1f} TOPS ({rate_int8 / PEAK_INT8 * 100:.1f}%)")
    us = {}
    for name in k3.VARIANTS:
        if "us_per_matmul" not in results[name]:
            continue
        us[name] = results[name]["us_per_matmul"]
        rate = k3.flop() / (us[name] * 1e-6)
        peak, lib = ((PEAK_INT8, rate_int8) if name in k3.INT8_VARIANTS else (PEAK_BF16, rate_bf16))
        log("kernel", f"K3 probe {name}: {rate / peak * 100:.1f}% of its peak, "
                      f"{rate / lib * 100:.1f}% of the cuBLAS rate yardstick")
    ms = results["A_bf16"]["us_per_matmul"] * 1e-3
    # a launch reads x and w once and writes out once, whatever R: per
    # product that is next to nothing, and the products bound it
    r2 = 160
    launch_bytes = k3.M * k3.K * 2 + k3.K * k3.N * 2 + G * k3.N * 4
    b = bound(float(k3.flop()), PEAK_BF16, launch_bytes / (G * r2))
    log("kernel", f"K3 per product: kernel (A_bf16) {ms:.6f} ms, plain loop {plain_ms:.6f} ms, "
                  f"one torch.matmul bf16 call {lib_bf16:.6f} ms, one torch._int_mm call "
                  f"{lib_int8:.6f} ms (both launch-bound at this size), "
                  f"bound {b['bound_ms']:.6f} ms bf16 / "
                  f"{k3.flop() / PEAK_INT8 * 1e3:.6f} ms int8 by operations")
    return {"name": "probe_mma", "route": "cuda",
            "source": "egohmr_tpu_torch/csrc/probe_mma.cu",
            "replaces": "tools/probe_int8_mxu.py:168",
            "launches": launches, "max_abs_err": max_err,
            "unit": "per [2048,256]x[256,256] product, variant A_bf16",
            "ms": ms, "plain_ms": plain_ms, **b, "library_ms": lib_bf16,
            "library_int8_ms": lib_int8,
            "bound_int8_ms": k3.flop() / PEAK_INT8 * 1e3,
            "library_rate_tflops_bf16": rate_bf16 / 1e12,
            "library_rate_tops_int8": rate_int8 / 1e12,
            "us_per_matmul": us,
            "variants": {n: results[n] for n in k3.VARIANTS},
            "int8_speedup_pure": results.get("int8_speedup_pure"),
            "int8_speedup_with_glue": results.get("int8_speedup_with_glue")}


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


EVAL_ARGS = ["--synthetic", "--batch_size", "8", "--num_samples", "5", "--num_batches", "2"]
# name -> (the CLI's arguments, guided steps per batch)
EVAL_RUNS = {"unguided DDIM-5": (["--timestep_respacing_eval", "ddim5",
                                  "--with_coap_grad", "false"], 0),
             "guided DDPM-50 (the CLI's defaults)": ([], 11)}
F32_PLAIN = ["--bf16", "false", "--pointnet_impl", "xla"]
MIN_INVISIBLE_JOINTS = 48  # below this the *_invis keys average too little to be held to a bar


def edge_batch(batch_size: int, *, seed: int, device):
    """`synthetic_batch` with every other body, and its scene with it, moved
    to the right edge of the full image, so that the keys over invisible
    joints and vertices average over many of them and over several images
    (as it comes, the data has one such joint in two batches). The camera
    (f = 1500, centre 960 of 1920) meets the edge at x / z = 0.64; the
    synthetic body reaches further to +x than to -x, hence the offsets."""
    from egohmr_tpu_torch.data import synthetic_batch, to_torch

    batch = synthetic_batch(batch_size, seed=seed)
    transl = batch["smpl_params"]["transl"]
    offsets = np.linspace(-0.5, -0.2, len(transl[1::2]))
    dx = (0.64 * transl[1::2, 2] + offsets - transl[1::2, 0]).astype(transl.dtype)
    transl[1::2, 0] += dx
    batch["scene_pcd_verts_full"][1::2, :, 0] += dx[:, None]
    batch["keypoints_3d_full"][1::2, :, 0] += dx[:, None]
    return to_torch(batch, device)


def phase_eval(cfg) -> dict:
    from egohmr_tpu_torch.collision import knn as k2
    from egohmr_tpu_torch.diffusion import make_schedule
    from egohmr_tpu_torch.eval import evaluate_batch, sample_bodies
    from egohmr_tpu_torch.eval import test_egohmr as cli
    from egohmr_tpu_torch.eval.metrics import diversity_std
    from egohmr_tpu_torch.models import BodyRepStats
    from egohmr_tpu_torch.nn import cast_params_bf16
    from egohmr_tpu_torch.nn import pointnet_fused as k1
    from egohmr_tpu_torch.smpl import make_synthetic_model

    B, S, n_batches = 8, 5, 2
    cli.synthetic_batch = edge_batch  # every run below, the f32 ones too, reads this data
    dev = torch.device("cuda")
    model32 = cli._synthetic_model(cfg).to(dev, memory_format=torch.channels_last).eval()
    model = cast_params_bf16(model32)
    smpl = make_synthetic_model(num_vertices=V_FULL, device=dev)
    stats = BodyRepStats(torch.zeros(144, device=dev), torch.ones(144, device=dev))
    schedule = make_schedule(50, "cosine", "ddim5").to(dev)
    fused, plain = replace(cfg, pointnet_impl="fused"), replace(cfg, pointnet_impl="xla")

    def sample(batch, bf16=True, schedule=schedule, **kw):
        kw = {"sampler": "ddim", **kw}
        return sample_bodies(model if bf16 else model32, fused if bf16 else plain, smpl, stats,
                             schedule, batch, torch.Generator(device=dev).manual_seed(0), S,
                             bf16=bf16, params_precast=bf16, **kw)

    # the CLI's two batches: how many joints and vertices the *_invis keys
    # average over; K2 against its plain version on the very bodies and
    # scenes `evaluate_batch` hands it; and where the bf16 run's larger
    # diversity comes from
    n_invis, n_images = [0, 0], 0
    for seed in (100, 101):
        batch = edge_batch(B, seed=seed, device=dev)
        outputs, cond = sample(batch)
        res = evaluate_batch(fused, smpl, smpl, smpl, batch, outputs, cond)
        n_invis[0] += int(res.invis_count.sum())
        n_invis[1] += int(res.vertex_invis_count.sum())
        n_images += int((res.invis_count > 0).sum())
        verts = outputs["pred_vertices"].reshape(B * S, -1, 3).contiguous()
        scene = cond.scene_pcd.repeat_interleave(S, dim=0).contiguous()
        for what, (pts, vts) in {"scene -> body": (scene, verts),
                                 "body -> scene": (verts, scene)}.items():
            got = k2.nearest_vertex_idx(pts, vts)
            differ, err, ok = k2_agrees(pts, vts, got, k2.nearest_vertex_idx_reference(pts, vts))
            log("eval", f"K2 vs plain on batch {seed - 100}'s own bodies, {what} "
                        f"[{pts.shape[0]}, {pts.shape[1]}] x {vts.shape[1]}: {differ} of "
                        f"{got.numel()} indices differ, max |d_kernel - d_plain| {err:.3e}")
            if not ok:
                fail(f"K2 disagrees with its plain version inside evaluate_batch ({what})")
        # the same x_T through the f32 plain model: the conditioning is
        # shared by an image's S samples, so its rounding moves them together
        # and leaves their spread alone; what differs from sample to sample
        # is the bf16 denoiser's rounding of each x
        out32, _ = sample(batch, bf16=False)
        j16, j32 = (o["pred_keypoints_3d_full"][:, :, :24] for o in (outputs, out32))
        j16, j32 = j16 - j16[:, :, :1], j32 - j32[:, :, :1]
        std16, std32, std_err = (diversity_std(x).mean().item() * 1e3
                                 for x in (j16, j32, j16 - j32))
        log("eval", f"batch {seed - 100}, unguided DDIM-5, diversity std over the {S} samples, "
                    f"mm: bf16 {std16:.4f}, f32 {std32:.4f}, of (bf16 - f32) body by body "
                    f"{std_err:.4f}; f32 and that in quadrature "
                    f"{(std32 ** 2 + std_err ** 2) ** 0.5:.4f}")
    log("eval", f"the two batches: {n_invis[0]} of {n_batches * B * 24} joints and {n_invis[1]} "
                f"of {n_batches * B * V_FULL} vertices are invisible, in {n_images} of "
                f"{n_batches * B} images")
    if n_invis[0] < MIN_INVISIBLE_JOINTS:
        fail(f"only {n_invis[0]} invisible joints: the *_invis keys check too little")

    def run(extra):
        t = time.perf_counter()
        summary = cli.main(EVAL_ARGS + extra)
        torch.cuda.synchronize()
        return summary, time.perf_counter() - t

    cli.main(EVAL_ARGS[:-1] + ["1"] + EVAL_RUNS["unguided DDIM-5"][0])  # warm-up
    counts = {"k1": 0, "k2": 0}
    for name, (extra, guided_steps) in EVAL_RUNS.items():
        k1.launches = k2.launches = 0  # main path starts: count launches from here
        summary, secs = run(extra)
        d1, d2 = k1.launches, k2.launches  # main path ends
        want2 = n_batches * (2 + guided_steps)
        log("eval", f"{name}, bf16 + K1, {B} images x {S} samples x {n_batches} batches: "
                    f"{secs:.2f} s for the whole CLI run (model set-up included); K1 launches "
                    f"{d1}, K2 launches {d2}")
        if d1 != n_batches or d2 != want2:
            fail(f"eval {name}: K1 launched {d1} times (want {n_batches}), K2 {d2} "
                 f"(want {want2}: 2 per evaluated batch and {guided_steps} guided "
                 "steps per batch)")
        counts["k1"] += d1
        counts["k2"] += d2
        # the f32 plain run on the card: the same images, the same noise
        f32, secs32 = run(extra + F32_PLAIN)
        log("eval", f"{name}: f32 plain run on the card {secs32:.2f} s")
        if set(summary) != set(f32):
            fail(f"eval {name}: summary keys differ between the bf16 and the f32 run")
        # every value finite, or NaN exactly where the f32 run's is; the
        # error metrics, in mm, within 5 mm of the f32 run's
        worst = ""
        for key in sorted(summary):
            v, w = summary[key], f32[key]
            if np.isnan(v) != np.isnan(w) or np.isinf(v):
                fail(f"eval {name}: {key} is {v} (f32 plain on the card {w})")
            if key in ("coll_ratio", "contact") and not 0.0 <= v <= 1.0:
                fail(f"eval {name}: {key} = {v} outside [0, 1]")
            diff = abs(v - w)
            log("eval", f"{name}: {key}: bf16 {v:.4f}, f32 {w:.4f}, |diff| {diff:.4f}")
            if ("mpjpe" in key or "v2v" in key) and not diff <= 5.0:
                worst = worst or f"{key} ({diff:.2f} mm, bar 5)"
        if worst:
            fail(f"eval {name}: {worst}: the bf16 run strays from the f32 run")

    # the time of `evaluate_batch` per batch, and of K2 inside it
    batch = edge_batch(B, seed=100, device=dev)
    with torch.no_grad():
        outputs, cond = sample(batch)

        def host_ms(fn, reps=5):
            fn()
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(times))

        eval_ms = host_ms(lambda: evaluate_batch(fused, smpl, smpl, smpl, batch, outputs, cond))
        bare_ms = host_ms(lambda: evaluate_batch(fused, smpl, smpl, smpl, batch, outputs, cond,
                                                 eval_collision=False, eval_contact=False))
        sample_ms = host_ms(lambda: sample(batch), reps=3)
        ddpm = make_schedule(50, "cosine", "").to(dev)
        guided_ms = host_ms(lambda: sample(batch, schedule=ddpm, sampler="ddpm",
                                           with_guidance=True), reps=2)
        verts = outputs["pred_vertices"].reshape(B * S, -1, 3).contiguous()
        scene = cond.scene_pcd.repeat_interleave(S, dim=0).contiguous()
        k2_metric = time_ms(lambda: k2.nearest_vertex_idx(scene, verts), reps=10)
        k2_cloud = time_ms(lambda: k2.nearest_vertex_idx(verts, scene), reps=10)
    pairs = float(B * S) * P_FULL * V_FULL
    k2_bound = 6.0 * pairs / PEAK_F32 * 1e3
    log("eval", f"one batch of {B} images x {S} samples, host clock, median: unguided DDIM-5 "
                f"`sample_bodies` {sample_ms:.2f} ms, guided DDPM-50 `sample_bodies` "
                f"{guided_ms:.2f} ms, `evaluate_batch` {eval_ms:.2f} ms "
                f"({bare_ms:.2f} ms without the collision and contact scores)")
    log("eval", f"K2 inside `evaluate_batch`, CUDA events, median of 10: scene -> body "
                f"[{B * S}, {P_FULL}] x {V_FULL}: {k2_metric:.3f} ms; body -> scene "
                f"[{B * S}, {V_FULL}] x {P_FULL}: {k2_cloud:.3f} ms; bound {k2_bound:.3f} ms each "
                f"by operations; together {(k2_metric + k2_cloud) / eval_ms * 100:.1f}% of "
                f"`evaluate_batch`")
    counts.update(eval_ms=eval_ms, eval_no_collision_ms=bare_ms, sample_ms=sample_ms,
                  guided_sample_ms=guided_ms,
                  k2_metric_ms=k2_metric, k2_cloud_ms=k2_cloud, k2_bound_ms=k2_bound)
    return counts


TRAIN_B = 16  # the training CLI's default batch
# The bf16-mixed gradient's cosine to the f32 one, read by the JAX package on
# the CPU at full width on the weights, batch and draws of this script's
# gradient check (`tests/grad_cosine_full_width.py`: whole model 0.0743,
# outside the ResNet 0.9775; the port on the CPU 0.0817 and 0.9767). The
# weights' fingerprint there, which the check requires before it compares.
JAX_GRAD_COSINE = {"all": 0.0743, "outside the ResNet": 0.9775}
GRAD_COSINE_MARGIN = {"all": 0.03, "outside the ResNet": 0.01}
WEIGHTS_FINGERPRINT = 158740.438725781


def train_draws(batch_size: int, cond_mask_prob: float, seed: int = 3):
    """(t, noise, drop) from `seed` for a 50-step schedule, as
    `tests/grad_cosine_full_width.py` draws them."""
    rng = np.random.RandomState(seed)
    t = rng.randint(0, 50, batch_size).astype(np.int64)
    noise = rng.randn(batch_size, 144).astype(np.float32)
    drop = rng.rand(batch_size) < cond_mask_prob
    return t, noise, drop


def phase_train(cfg) -> dict:
    """Stage-2 training at full width (`EgoHMRConfig()`, batch 16, P=20,000,
    V=6890, synthetic data, the training init from a seed): step times in
    f32 (TF32 off) and bf16-mixed; one step with the collision loss, whose
    K2 call is held to its plain version on that step's own inputs and
    timed; the bf16 gradient against the f32 one on the same draws; the
    loss falling over 100 bf16 steps on one batch; and the CLI, 2 steps
    resumed to 4 (the collision loss from step 2), which is the path's main
    run."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from egohmr_tpu_torch.collision import knn as k2
    from egohmr_tpu_torch.collision import sdf
    from egohmr_tpu_torch.data import synthetic_batch
    from egohmr_tpu_torch.diffusion import make_schedule
    from egohmr_tpu_torch.models import BodyRepStats, EgoHMR, LossWeights, init_random_
    from egohmr_tpu_torch.nn import pointnet_fused as k1
    from egohmr_tpu_torch.smpl import make_synthetic_model
    from egohmr_tpu_torch.train import (TrainConfig, make_optimizer, make_train_step,
                                        stage2_loss, train_egohmr, trainable_tensors)

    dev = torch.device("cuda")
    B = TRAIN_B
    smpl = make_synthetic_model(num_vertices=V_FULL, device=dev)
    stats = BodyRepStats(torch.zeros(144, device=dev), torch.ones(144, device=dev))
    schedule = make_schedule(50, "cosine", "").to(dev)
    batches = [synthetic_batch(B, num_scene_points=P_FULL, seed=30 + i, device=dev)
               for i in range(4)]
    t0 = time.perf_counter()
    init = init_random_(EgoHMR(cfg), seed=0, training=True).state_dict()
    log("train", f"ResNet-{cfg.resnet_layers}, GCN {cfg.gcn_hid_dim}x{cfg.gcn_layers}, batch {B}, "
                 f"P={P_FULL}, V={V_FULL}; training init in {time.perf_counter() - t0:.1f} s")

    def fresh(**kw):
        model = EgoHMR(cfg)
        model.load_state_dict(init)
        model = model.to(dev, memory_format=torch.channels_last)
        tcfg = TrainConfig(**kw)
        opt = make_optimizer(model, tcfg)
        step = make_train_step(cfg, tcfg, LossWeights(), schedule, stats, smpl, smpl, smpl, opt)
        return model, step

    # ---- step times: CUDA events around each step beside the host clock
    times = {}
    for name, mp in (("f32", False), ("bf16-mixed", True)):
        model, step = fresh(mixed_precision=mp)
        gen = torch.Generator(device=dev).manual_seed(1)
        for i in range(3):  # warm-up: cuDNN algorithm selection, allocator growth
            step(model, batches[i % 4], gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        b1, b2 = k1.launches, k2.launches
        dev_ms, host_ms, losses = [], [], []
        for i in range(20):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t = time.perf_counter()
            start.record()
            terms = step(model, batches[i % 4], gen)
            end.record()
            end.synchronize()
            host_ms.append((time.perf_counter() - t) * 1e3)
            dev_ms.append(start.elapsed_time(end))
            losses.append(terms["loss"])
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        if k1.launches != b1 or k2.launches != b2:
            fail(f"training without the collision loss launched K1 {k1.launches - b1} and K2 "
                 f"{k2.launches - b2} times (want 0: K1 has no backward, K2 serves the "
                 "collision loss only)")
        if not all(torch.isfinite(x) for x in losses):
            fail(f"{name} training: a non-finite loss")
        t = {"ms": float(np.median(dev_ms)), "host_ms": float(np.median(host_ms)),
             "peak_mib": peak}
        t["imgs_per_s"] = B / t["host_ms"] * 1e3
        # where a step's time goes: its kernels under the profiler, the rest
        # is the card waiting on the host
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(model, batches[0], gen)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        t["kernel_ms"] = sum(e.self_device_time_total for e in events) / 1e3
        t["kernel_launches"] = sum(e.count for e in events)
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
        t["top_kernels_ms"] = {e.key[:60]: e.self_device_time_total / 1e3 for e in top}
        times[name] = t
        log("train", f"{name} step, median of 20 after 3 warm-up: {t['ms']:.2f} ms (CUDA events), "
                     f"{t['host_ms']:.2f} ms (host clock), {t['imgs_per_s']:.1f} imgs/s, peak "
                     f"memory {peak:.0f} MiB; K1 and K2 launches 0; one step under the "
                     f"profiler: {t['kernel_ms']:.2f} ms of kernels in {t['kernel_launches']} "
                     "launches, the largest: " + ", ".join(
                         f"{k} {v:.2f}" for k, v in t["top_kernels_ms"].items()))
        del model, step
    log("train", f"bf16-mixed over f32: {times['f32']['ms'] / times['bf16-mixed']['ms']:.2f}x "
                 "per step (CUDA events)")

    # ---- one step with the collision loss: K2 on that step's own inputs
    model, step = fresh(use_collision_loss=True)
    seen = []
    nearest = sdf.nearest_vertex_idx

    def spy(points, verts, **kw):
        idx = nearest(points, verts, **kw)
        seen.append((points.clone(), verts.clone(), idx.clone()))
        return idx

    sdf.nearest_vertex_idx = spy
    gen = torch.Generator(device=dev).manual_seed(2)
    step(model, batches[0], gen)  # warm-up
    seen.clear()
    before = k2.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        terms = step(model, batches[1], gen)
        torch.cuda.synchronize()
    sdf.nearest_vertex_idx = nearest
    launched = k2.launches - before
    profiled = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "nearest_vertex_kernel" in e.key)
    coll = float(terms["loss_coap_penetration"])
    log("train", f"collision step: K2 launches {launched} (wrapper), {profiled} "
                 f"nearest_vertex_kernel launches (profiler); loss_coap_penetration {coll:.6e}")
    if launched != 1 or profiled != 1 or len(seen) != 1 or not np.isfinite(coll):
        fail(f"the collision step: K2 launched {launched} times, profiled {profiled}, "
             f"loss_coap_penetration {coll}")
    pts, verts, got = seen[0]
    differ, err, ok = k2_agrees(pts, verts, got, k2.nearest_vertex_idx_reference(pts, verts))
    log("train", f"K2 vs plain on the step's own inputs [{pts.shape[0]}, {pts.shape[1]}] x "
                 f"{verts.shape[1]}: {differ} of {got.numel()} indices differ, max "
                 f"|d_kernel - d_plain| {err:.3e}")
    if pts.shape != (B, TrainConfig().max_collision_points, 3) or not ok:
        fail("K2 disagrees with its plain version on the training step's inputs")

    def library(p, v):
        v_sq = torch.sum(v * v, dim=-1)[:, None, :]
        return torch.baddbmm(v_sq, p, v.transpose(1, 2), alpha=-2.0).argmin(-1)

    k2_train = {"ms": time_ms(lambda: k2.nearest_vertex_idx(pts, verts), reps=20),
                "plain_ms": time_ms(lambda: k2.nearest_vertex_idx_reference(pts, verts), reps=5),
                "library_ms": time_ms(lambda: library(pts, verts), reps=5),
                **bound(6.0 * pts.shape[0] * pts.shape[1] * verts.shape[1], PEAK_F32,
                        pts.numel() * 4 + verts.numel() * 4 + got.numel() * 8)}
    log("train", f"K2 at the training shape, median of CUDA-event timings: kernel "
                 f"{k2_train['ms']:.3f} ms, plain {k2_train['plain_ms']:.3f} ms, baddbmm+argmin "
                 f"{k2_train['library_ms']:.3f} ms, bound {k2_train['bound_ms']:.4f} ms by "
                 f"{k2_train['bound_by']}")
    del model, step, seen

    # ---- the bf16 gradient against the f32 one, on the same draws, held to
    # the JAX package's reading on the same weights, batch and draws
    fingerprint = float(sum(float((v.double() ** 2).sum()) for v in init.values()
                            if v.is_floating_point()))
    if abs(fingerprint / WEIGHTS_FINGERPRINT - 1) > 1e-9:
        fail(f"the training init's fingerprint {fingerprint!r} is not the one JAX's gradient "
             f"cosine was read on ({WEIGHTS_FINGERPRINT!r})")
    draws = dict(zip(("t", "noise", "drop"), (torch.from_numpy(a).to(dev) for a in
                                              train_draws(B, cfg.cond_mask_prob))))
    model, _ = fresh()
    trained = trainable_tensors(model)
    grads = {}
    for mp in (False, True):
        saved = {k: v.clone() for k, v in model.state_dict().items()}
        for x in trained.values():
            x.grad = None
        loss, _ = stage2_loss(model, cfg, LossWeights(), schedule, stats, smpl, smpl, smpl,
                              batches[0], use_collision=False, mixed_precision=mp, **draws)
        loss.backward()
        grads[mp] = {k: x.grad.double() for k, x in trained.items()}
        model.load_state_dict(saved)
    for k, g in grads[True].items():
        if trained[k].grad.dtype != torch.float32 or not torch.isfinite(g).all():
            fail(f"bf16-mixed gradient of {k}: {trained[k].grad.dtype}, or not finite")

    def cosine(keys):
        a = torch.cat([grads[False][k].reshape(-1) for k in keys])
        b = torch.cat([grads[True][k].reshape(-1) for k in keys])
        return float(a @ b / (a.norm() * b.norm())), float(a.norm())

    parts = {"all": list(trained), "outside the ResNet": [k for k in trained
                                                          if not k.startswith("backbone.")]}
    for top in ("backbone", "scene_enc", "diffusion_model", "embed_timestep", "beta_layer"):
        parts[top] = [k for k in trained if k.startswith(top + ".")]
    cosines = {name: cosine(keys) for name, keys in parts.items()}
    log("train", "bf16-mixed vs f32 gradient (TF32 off), cosine and f32 norm: " + ", ".join(
        f"{n} {c:.4f} ({nrm:.4g})" for n, (c, nrm) in cosines.items()))
    # A train-mode ResNet-50 at a random init amplifies the bf16 rounding
    # into its gradient, far the largest: the JAX package reads a
    # whole-model cosine of 0.0743 here, not its stub-backbone test's 0.99
    for part, want in JAX_GRAD_COSINE.items():
        bar = want - GRAD_COSINE_MARGIN[part]
        log("train", f"{part}: cosine {cosines[part][0]:.4f}, JAX on the CPU {want:.4f}, "
                     f"bar {bar:.4f}")
        if not cosines[part][0] >= bar:
            fail(f"the bf16-mixed gradient ({part}) strays from the f32 one further than "
                 "in the JAX package")
    del model, grads, trained

    # ---- the loss falls: 100 bf16-mixed steps at lr 1e-3 on one batch
    model, step = fresh(lr=1e-3)
    gen = torch.Generator(device=dev).manual_seed(4)
    losses = torch.stack([step(model, batches[0], gen)["loss"] for _ in range(100)]).tolist()
    early, late = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    # at lr 1e-3 the first Adam steps move every weight by about 1e-3 and
    # the loss can spike before it falls, which inflates the mean of the
    # first 5: the last 5 are held to the first step's loss too
    log("train", f"100 bf16-mixed steps at lr 1e-3 on one batch: the first 5 losses "
                 f"{', '.join(f'{x:.4f}' for x in losses[:5])} (mean {early:.4f}), the "
                 f"largest {max(losses):.4f}, mean of the last 5 {late:.4f}: {late / early:.4f}x "
                 f"the first 5, {late / losses[0]:.4f}x the first (bar 0.8x each)")
    if not (np.isfinite(late) and late < 0.8 * early and late < 0.8 * losses[0]):
        fail("the loss did not fall below 0.8 of its start")
    del model, step

    # ---- the CLI: 2 steps, then resumed to 4 with the collision loss from
    # step 2: the path's main run, counted from 0
    with tempfile.TemporaryDirectory() as save_dir:
        args = ["--synthetic", "--batch_size", str(B), "--log_step", "1", "--val_step", "1000",
                "--save_step", "1000", "--data_parallel", "false", "--start_coap_step", "2",
                "--save_dir", save_dir]
        k1.launches = k2.launches = 0  # main path starts: count launches from here
        t = time.perf_counter()
        train_egohmr.main(args + ["--num_steps", "2"])
        train_egohmr.main(args + ["--num_steps", "4"])
        secs = time.perf_counter() - t
        counts = {"k1": k1.launches, "k2": k2.launches}  # main path ends
        with open(f"{save_dir}/metrics.jsonl") as f:
            steps = [json.loads(line)["step"] for line in f]
    log("train", f"the CLI, --synthetic, 2 steps then resumed to 4: {secs:.1f} s (model set-up "
                 f"included), metrics.jsonl steps {steps}, K1 launches {counts['k1']}, "
                 f"K2 launches {counts['k2']}")
    if steps != [0, 1, 2, 3] or counts != {"k1": 0, "k2": 2}:
        fail(f"the training CLI: steps {steps}, launches {counts} (want K1 0, K2 2)")
    return {**counts, "times": times, "k2_train_shape": k2_train,
            "grad_cosine": {n: c for n, (c, _) in cosines.items()},
            "loss_first": losses[0], "loss_first5": early, "loss_last5": late}


def main() -> None:
    smi = phase_device()
    from egohmr_tpu_torch.models import EgoHMRConfig

    cfg = EgoHMRConfig()  # full width: ResNet-50, H=256, GCN 1024x4
    phase_build()
    kernels = [phase_kernel_k1(cfg), phase_kernel_k2(), phase_kernel_k3()]
    unguided = phase_serve(cfg)
    guided = phase_guided(cfg)
    evaluated = phase_eval(cfg)
    trained = phase_train(cfg)
    # launches: over the main paths, each counted from 0 just before it (K3's
    # main path is the probe's own entry point, counted in its phase)
    kernels[0].update(launches=unguided + guided["k1"] + evaluated["k1"] + trained["k1"],
                      launches_unguided=unguided, launches_guided=guided["k1"],
                      launches_eval=evaluated["k1"], launches_train=trained["k1"])
    kernels[1].update(launches=guided["k2"] + evaluated["k2"] + trained["k2"],
                      launches_unguided=0, launches_guided=guided["k2"],
                      launches_eval=evaluated["k2"], launches_train=trained["k2"],
                      eval_shapes={k: evaluated[k] for k in
                                   ("k2_metric_ms", "k2_cloud_ms", "k2_bound_ms", "eval_ms")},
                      train_shape=trained["k2_train_shape"])
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
