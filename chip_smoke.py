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
               one 8192^3 product; hold the graph-convolution epilogue
               (`nn/gconv_epilogue.py`) to its plain statement at the
               bulk (128) and mesh-guided (160) denoiser rows and time it
               against the plain glue it replaces and its bound; hold the
               ResNet epilogue (`nn/resnet_epilogue.py`) to its plain
               statement bit for bit at each of ResNet-50's 49 passes at
               B = 64, and time each pass against its byte bound and the
               plain glue it replaces, summed over a request, and the
               whole bf16 forward fused and plain
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
  8. stage1  — stage 1 (ProHMR-scene) at full width (ResNet-50, the 4-step
               Glow at hidden 1024, PointNet H=256 on 20,000 points, 6890
               vertices): the evaluation CLI at its defaults (10 images x 5
               samples, K1) over 6 batches, K1 counted by its wrapper and the
               profiler (once per batch) and held to its plain version on the
               CLI's clouds, the summary within 5 mm and the translations
               within 2 mm of the CLI's f32 plain run, ms of the first batch
               (K1's weights prepared) and median ms of the other five, by
               CUDA events and the host clock; the stage-2 CLI (--two_stage
               true) conditioned on the translations of its results.pkl;
               the training CLI, 2 steps resumed to 4 at batch 32 (K1 0
               launches); the G+D step's ms, imgs/s, peak memory and kernels
  9. learned — the learned collision backends (the distilled occupancy and
               signed-distance nets) at full width: (a) the three shipped
               artifacts on the card, each held to its sidecar's agreement
               bar less 0.02 on draws made on the card (labels through K2)
               and to the CPU's query on CPU-made inputs; (b) the evaluation
               query, 40 bodies x 20,000 points with each 192-wide net, its
               time, peak memory and chunking; (c) learned-guided DDIM-5 at
               batch 64 and DDPM-50 at batch 16, bf16 with K1 (K1 once and
               K2 never per request), request and guided-step times, peak
               memory, and guidance lowering the learned collision loss at
               raised weights, pooled over 5 scenes; (d) the evaluation CLI with
               `--collision_backend occupancy` and `test_egohmr_volsmpl` at
               their defaults (K1 and K2 once per batch), against their f32
               plain runs and the sdf backend's collision ratio; (e) both
               distillation CLIs for 1000 steps (the loss falls, agreement
               beats an untrained net's and the all-outside answer's, the
               artifact reloads) and K2 at the label shapes
 10. parallel — data parallelism at full width: (a) the stage-2 DP step
               on NCCL at world 1 equal to the plain step bit for bit, f32
               and bf16-mixed; (b) two ranks sharing the card over gloo:
               the stage-2 step at batch 16 and the stage-1 G+D step at
               batch 32 against their 1-way steps, the replicas equal after
               more steps, a collision step's K2 held to its plain version,
               the point-sharded encoder against the whole cloud's; (c) the
               evaluation CLI at two ranks against one, f32 plain and at its
               defaults, every K1 and K2 call of both held to its plain
               version on its own inputs, and a shard's guided gradient
               against the whole batch's; (d) `Predictor` over two replicas
               on the card against one device, each K1 call held likewise;
               the step's, request's and gradient all-reduce's times. Two
               ranks share one card: no scaling figure
 11. tp      — tensor parallelism at full width: `Predictor` over a 2 x 2
               data x model grid, every shard on the one card, against the
               one-device `Predictor` at batch 64, DDIM-5, on phase 5's
               closed body and penetrated scene: unguided f32 and guided f32
               (weights a tenth of phase 5's raised ones) within rtol/atol
               2e-4, unguided bf16 within a mean abs of 0.05; K1 never
               launched on the grid (switched to the split plain encoder),
               K2 once per guided step on each data row, each call held to
               its plain version; host-clock and CUDA-event ms per request;
               at phase 5's raised weights, the grid's and the flat
               2-replica split's gaps from one device, printed. One card:
               no latency claim
 12. bench   — the measurement entry points at full width, in process, at
               --iters 1 (chains of 3 and 9 requests): `python -m
               egohmr_tpu_torch.bench` in its default mode (`sample_bodies`
               unguided, and the paper setting), --guided-ddim, --guided,
               --serving and --train; one sweep point of
               `tools/profile_serving.py`. Each prints one JSON line with
               the JAX bench's metric name and a non-null value; K1
               launches in the default, serving and guided runs, K2 in the
               guided and training runs; before each request program is
               timed, one untimed request of it runs under the recorder and
               every K1 and K2 call of it is held to its plain version; where the mode captures the program, a
               second eager run and one replay of the same request follow,
               the replay held to the eager run bit for bit (or within
               twice the two eager runs' gap) and its K1 and K2 launches to
               the eager run's calls by the device's kernels
 13. tools   — the JAX repo's last entry points, ported to
               `egohmr_tpu_torch/tools/`, at full width, in process, on an
               EgoBody-layout root written here (20 frames, 20,000-point
               clouds, synthetic SMPL pickles, random checkpoints of both
               stages): `real_weights_eval` at its defaults (K1 once a
               batch in each stage, K2 twice a batch plus 11 times a guided
               batch), its stage-2 error keys within 5 mm of its `--bf16
               false` run; `measure_guidance_reuse_deviation --batch 16`
               (K2 ceil(g / r) times a request, g = 4 and 11 guided steps);
               `compare_train_precision --steps 200 --eval_every 100` (K2
               once a step, both runs' losses below 0.8 x their start);
               `probe_gcn` at its defaults; `visualize_results` on the
               stage-2 `results.pkl`. Every K1 and K2 call of these runs is
               held to its plain version
 14. graphs  — the served request as one captured CUDA graph per shape
               (`utils/graphs.py`, behind `Predictor`) at full width: (a)
               unguided DDIM-5 at 64, bf16 and f32, replayed requests equal
               to `Predictor.eager` bit for bit on 3 seeds and after
               another shape's capture, K1 once a request; (b) guided
               DDIM-5 at 64 and DDPM-50 at 16 on phase 5's scenes at its
               raised weights: two eager runs of one seed compared first,
               replay then bit for bit where they agree (else within twice
               their gap), K1 1 and K2 4 and 11 a request by the replay
               accounting and by the device's kernels; (c) the profiler on a replayed and an
               eager request of each: host launch calls, device kernels,
               kernel ms; (d) submit, blocking and steady-state ms per
               request, eager against graphed, three rounds in turns, with
               each program's capture seconds and pool bytes
 15. volsdf  — EgoHMR-VolSMPL on the served path (`Predictor` with
               `collision_backend="volsdf"`) at full width: 5 x 5 a request,
               bf16, DDPM-50 guided on its 11 steps t <= 10 at the
               reference's weight 30 by the shipped 192-wide SDF net over
               all 20,000 scene points, each guided step's terms recorded:
               (a) two eager runs of one seed, then the replay equal to
               eager bit for bit (else within twice their gap); per
               replayed request `guided_steps` 11 and `field_rows` 11 x 25
               x 24 x 20,000, the record's 11 steps finite with a non-zero
               gradient, device ms and peak memory; (b) the same request
               without `record_guidance` returns no record, its outputs
               those of (a); (c) the unguided bulk request (64 x 1, DDIM-5,
               a NumPy batch through the staging ring) under the profiler:
               22 host calls per replayed request, its device kernels
               printed
On the card every `Predictor` of phases 4, 5, 10 and 11 (one device or flat
replicas) and `bench`'s request modes in phase 12 run their captured
programs: a replayed launch calls no wrapper, so K1's and K2's counts come
from the replay accounting (a wrapper called during a capture counts one
launch per replay of it, `utils/graphs.py:count_launch`), and the phases
count from after `warmup()`, whose eager warm-up runs launch for real. In
each of these phases' counted runs one replayed request of every program
(phase 14: every counted request) runs under the profiler, and its K1 and
K2 launches and both epilogues' by the accounting must equal those counted
from the device's kernels (K1's four stage kernels, K2's search kernel, one
kernel a call of each epilogue): the kernels line's `launches_profiled`.
Kernel calls are watched in eager requests (`Predictor.eager`, the request
hook's `program.eager`), and replayed ones
are held to them through replay's bit-equality with eager.
Before the last line come a JSON object with one entry per kernel and the
card's name and power limit; the last line is {"ok": true, "device":
{...}}. Nothing runs without a GPU.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
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


# K1's and K2's device kernels per wrapper call: K1 is four stage and four
# context kernels, K2 one search kernel (and, split, a combine kernel); the
# graph-convolution epilogue one kernel a fused convolution, the ResNet
# epilogue one a fused pass
DEVICE_KERNELS = {"k1": ("stage_kernel", 4), "k2": ("nearest_vertex_kernel", 1),
                  "gconv": ("gconv_epilogue_kernel", 1),
                  "resnet": ("resnet_epilogue_kernel", 1)}
# their launches in the main paths' requests run under the profiler,
# counted from the device's kernels (`profiled_launches`)
PROFILED = {"k1": 0, "k2": 0, "gconv": 0, "resnet": 0}
# fused graph convolutions and fused ResNet passes on each phase's main
# paths, each path counted from 0 just before it, as K1's and K2's launches
# are (`fused_starts`, `fused_ends`)
GCONV, RESNET = {}, {}


def fused_starts() -> None:
    """A main path starts: the fused graph convolutions and ResNet passes
    count from 0."""
    from egohmr_tpu_torch.nn import gconv_epilogue as ge
    from egohmr_tpu_torch.nn import resnet_epilogue as re_

    ge.gconv_fused = re_.resnet_fused = 0


def fused_ends(phase: str) -> tuple:
    """A main path ends: its fused graph convolutions and ResNet passes,
    added to `phase`'s."""
    from egohmr_tpu_torch.nn import gconv_epilogue as ge
    from egohmr_tpu_torch.nn import resnet_epilogue as re_

    GCONV[phase] = GCONV.get(phase, 0) + ge.gconv_fused
    RESNET[phase] = RESNET.get(phase, 0) + re_.resnet_fused
    return ge.gconv_fused, re_.resnet_fused


def launches_on_device(prof) -> dict:
    """K1's, K2's and the epilogues' wrapper calls in a profiler session,
    counted from the device kernels it recorded, inside graph replays
    too."""
    import re

    out = {}
    for k, (kernel, per_call) in DEVICE_KERNELS.items():
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and re.search(rf"\b{kernel}\b", e.key))
        if n % per_call:
            fail(f"{n} {kernel} launches on the device, not {per_call} per {k.upper()} call")
        out[k] = n // per_call
    return out


MARKERS = 256  # marker kernels that lead each session of `traced`


def markers_in(prof) -> tuple:
    """The marker kernels (`torch.cuda._sleep`) in a profiler session: how
    many, and their device ms."""
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" in e.key]
    return sum(e.count for e in ev), sum(e.self_device_time_total for e in ev) / 1e3


@contextlib.contextmanager
def traced(what: str, cpu: bool = False):
    """A profiler session (the device's activity, and the host's with
    `cpu`) on a synchronised card, led by MARKERS marker kernels: late in a
    long process the trace was seen to drop the first device records of
    every session (a request's copies and first kernels, never later ones),
    so that they fall on the markers. Fails if it kept none of them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]) as prof:
        for _ in range(MARKERS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()
    kept = markers_in(prof)[0]
    if kept < 1:
        fail(f"{what}: the trace lost all {MARKERS} marker kernels before it, so it may have "
             "lost its first kernels too")
    if kept < MARKERS:
        log("profiler", f"{what}: the trace lost {MARKERS - kept} of the {MARKERS} marker "
                        "kernels before it")


def profiled_launches(request, what: str, want: dict = None):
    """`request()` on a synchronised card under the profiler: its result and
    K1's, K2's, the fused graph convolutions' and ResNet passes' launches in
    it, counted from the device's kernels. Fails unless the wrappers' counts (for a
    replayed request, its program's replay accounting) equal them, and
    `want` on the kernels it names. Adds them to PROFILED."""
    from egohmr_tpu_torch.collision import knn as k2
    from egohmr_tpu_torch.nn import gconv_epilogue as ge
    from egohmr_tpu_torch.nn import pointnet_fused as k1
    from egohmr_tpu_torch.nn import resnet_epilogue as re_

    b1, b2, b3, b4 = k1.launches, k2.launches, ge.gconv_fused, re_.resnet_fused
    with traced(what) as prof:
        out = request()
    counted = {"k1": k1.launches - b1, "k2": k2.launches - b2, "gconv": ge.gconv_fused - b3,
               "resnet": re_.resnet_fused - b4}
    device = launches_on_device(prof)
    if counted != device or (want is not None
                             and any(device[k] != v for k, v in want.items())):
        fail(f"{what}: K1, K2 and epilogues' launches {counted} by the wrappers' counts, "
             f"{device} by the device kernels under the profiler"
             + (f" (want {want})" if want else ""))
    for k in PROFILED:
        PROFILED[k] += device[k]
    return out, device


def max_gap(a, b) -> float:
    """The largest |a - b| over two results of one structure (dicts, lists,
    tensors, arrays); 0.0 is bit for bit."""
    if isinstance(a, dict):
        if set(a) != set(b):
            fail(f"result keys differ: {sorted(a)} vs {sorted(b)}")
        return max((max_gap(a[k], b[k]) for k in a), default=0.0)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            fail(f"result lengths differ: {len(a)} vs {len(b)}")
        return max((max_gap(x, y) for x, y in zip(a, b)), default=0.0)
    a = a.detach().cpu().double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().cpu().double().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.shape != b.shape:
        fail(f"result shapes differ: {a.shape} vs {b.shape}")
    if not np.isfinite(a).all():
        fail(f"non-finite values in a result of shape {a.shape}")
    return float(np.abs(a.astype(np.float64) - b).max()) if a.size else 0.0


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

    names = ["pointnet_fused", "nearest_vertex", "probe_mma", "markers", "gconv_epilogue",
             "resnet_epilogue"]
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


def k1_bound(enc, B: int, P: int) -> dict:
    """K1's bound at [B, P]. Products per point: fc_pos 3->2H, block 0
    (2H->H, H->H, shortcut 2H->H), blocks 1-3 on the point's own half (three
    H->H each; the pooled half is one row per cloud); bytes: the bf16
    points, the bf16 weights, the f32 feature."""
    H = enc.block_0.fc_1.weight.shape[0]
    macs = 3 * 2 * H + 2 * H * H + H * H + 2 * H * H + 9 * H * H
    n_weights = sum(p.numel() for p in enc.parameters())
    return bound(2.0 * macs * B * P, PEAK_BF16, B * P * 3 * 2 + n_weights * 2 + B * H * 4)


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
        err, bar, cos, ok = k1_agrees(got, ref)
        strict = ((got - ref).abs() <= 5e-5 + 5e-3 * ref.abs()).float().mean().item()
        log("kernel", f"K1 vs plain at B={B}, P={P}: max_abs_err {err:.3e} "
                      f"(bar {bar:.3e}), {strict * 100:.2f}% of elements within "
                      f"rtol 5e-3/atol 5e-5, min cosine {cos:.7f}")
        if not ok:
            fail(f"K1 disagrees with its plain version at B={B}, P={P}")
        max_err = max(max_err, err)
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
    b = k1_bound(enc, B_TIME, P_FULL)
    log("kernel", f"K1 bound {b['bound_ms']:.3f} ms by {b['bound_by']} "
                  f"(bf16 tensor-core peak): K1 runs at {b['bound_ms'] / ms * 100:.1f}% of that rate")
    return {"name": "pointnet_fused", "route": "cuda",
            "source": "egohmr_tpu_torch/csrc/pointnet_fused.cu",
            "replaces": "egohmr_tpu/nn/pointnet_fused.py:46",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": None, "f32_pointnet_ms": f32_ms, "bf16_pointnet_ms": bf16_ms,
            "ms_b16": small[16], "ms_b8": small[8], "by_kernel_ms": parts}


# fused graph convolutions a denoiser call at EgoHMRConfig()'s 4 residual
# blocks: the input one and two a block (the output convolution stays plain)
GCONV_PER_CALL = 9
# fused passes a bf16 ResNet-50 forward: the stem and three a block (16)
RESNET_PER_FORWARD = 49


def device_ms(fn, n: int = 50, kernel: str = None) -> float:
    """Device time of one `fn()` (every kernel it launches, or those named
    `kernel`), from the profiler over n calls after one more."""
    import re

    fn()
    with traced("device_ms") as prof:
        for _ in range(n):
            fn()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "spin_kernel" not in e.key
                and (kernel is None or re.search(rf"\b{kernel}\b", e.key)))
    if total <= 0:
        fail("the profiler recorded no device time" + (f" in {kernel}" if kernel else ""))
    return total / 1e3 / n


def phase_kernel_gconv(cfg) -> dict:
    """The graph-convolution epilogue at the GCN's width against its plain
    statement, at the rows a denoiser call has in bulk (64 images x
    cond/uncond = 128) and in the mesh-guided cell (16 x 5 x 2 = 160):
    BatchNorm and ReLU, with the residual add, and those stages off. Bar:
    one bf16 ulp at the larger of each output's magnitude and 1/256 of the
    largest. Then its device time a call against the plain glue's
    (`modulated_gconv_mix`, `_bn_relu`, the residual add) and its bound by
    bytes (h0, h1 and the residual read, the output written)."""
    from egohmr_tpu_torch.models.egohmr import _adjacency
    from egohmr_tpu_torch.nn import cast_params_bf16
    from egohmr_tpu_torch.nn import gconv_epilogue as ge
    from egohmr_tpu_torch.nn.gcn import GraphConv, ModulatedGraphConv, _bn_relu
    from egohmr_tpu_torch.nn.gcn import modulated_gconv_mix

    D, dev = cfg.gcn_hid_dim, torch.device("cuda")
    adj = _adjacency(dev)
    g = torch.Generator().manual_seed(4)

    def drawn(bn):
        p = GraphConv(D, D) if bn else ModulatedGraphConv(D, D)
        with torch.no_grad():
            for name, t in p.named_parameters():
                t.copy_(torch.randn(t.shape, generator=g) * (D ** -0.5 if name.endswith("W")
                                                             else 0.5))
            if bn:
                p.bn.weight.copy_(1 + 0.1 * torch.randn(D, generator=g))
                p.bn.bias.copy_(0.1 * torch.randn(D, generator=g))
                p.bn.running_mean.copy_(0.3 * torch.randn(D, generator=g))
                p.bn.running_var.copy_(1 + torch.rand(D, generator=g))
        return cast_params_bf16(p).eval().to(dev)

    p, po = drawn(True), drawn(False)
    res = {}
    with torch.no_grad():
        for N in (128, 160):
            x = torch.randn(N, 24, D, generator=g).to(dev, torch.bfloat16)
            resid = torch.relu(torch.randn(N, 24, D, generator=g)).to(dev, torch.bfloat16)
            for stage, gc, bn, r in (("bn_relu", p.gconv, p.bn, None),
                                     ("residual", p.gconv, p.bn, resid),
                                     ("output", po, None, None)):
                c = ge.build_constants(gc, adj, bn)
                h0, h1 = x @ gc.W[0], x @ gc.W[1]
                got = ge.gconv_epilogue(c, h0, h1, r).float()
                torch.cuda.synchronize()
                ref = ge.gconv_epilogue_reference(c, h0, h1, r).float()
                mag = torch.maximum(ref.abs(), ref.abs().max() / 256)
                ulps = ((got - ref).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max()
                differ = int((got != ref).sum())
                log("kernel", f"gconv epilogue vs plain at N={N}, D={D}, {stage}: "
                              f"{differ} of {got.numel()} outputs differ, at most "
                              f"{ulps.item():.2f} ulp (bar 1)")
                if not (ulps <= 1 and torch.isfinite(got).all()):
                    fail(f"the graph-convolution epilogue disagrees with its plain version at "
                         f"N={N}, {stage}")
            c = ge.build_constants(p.gconv, adj, p.bn)
            h0, h1 = x @ p.gconv.W[0], x @ p.gconv.W[1]
            ms = device_ms(lambda: ge.gconv_epilogue(c, h0, h1, resid))
            plain_ms = device_ms(lambda: resid + _bn_relu(
                p.bn, modulated_gconv_mix(p.gconv, adj, h0, h1), False))
            products_ms = device_ms(lambda: (x @ p.gconv.W[0], x @ p.gconv.W[1]))
            b = bound(2.0 * N * 24 * D * 24, PEAK_F32, 4 * N * 24 * D * 2)
            res[N] = {"ms": ms, "plain_ms": plain_ms, "products_ms": products_ms, **b}
            log("kernel", f"gconv epilogue at N={N}, D={D}, with the residual, device ms a call "
                          f"(profiler): kernel {ms:.4f}, plain glue {plain_ms:.4f}, the two "
                          f"weight products {products_ms:.4f}; bound {b['bound_ms']:.4f} ms by "
                          f"{b['bound_by']}: {b['bound_ms'] / ms * 100:.1f}% of it")
    return {"name": "gconv_epilogue", "route": "cuda",
            "source": "egohmr_tpu_torch/csrc/gconv_epilogue.cu", "replaces": None,
            "ms": res[128]["ms"], "plain_ms": res[128]["plain_ms"],
            "bound_ms": res[128]["bound_ms"], "bound_by": res[128]["bound_by"],
            "library_ms": None, "rows_160": res[160]}


def phase_kernel_resnet() -> dict:
    """The ResNet epilogue at each of ResNet-50's pass shapes at B = 64
    against its plain statement, bit for bit (the kernel rounds each f32
    product and sum as the statement does, and the output once, in place);
    its device time a pass against the plain glue it replaces
    (`batchnorm_eval`, the residual through the downsample BatchNorm,
    `torch.relu`) and its bound by bytes (a and the residual read, the
    output written), each call on fresh buffers, rotated over more than
    twice the card's L2; then one whole bf16 ResNet-50 forward at B = 64,
    fused and plain (`_fused` off): its 49 passes by the wrapper's count and
    by the profiler, and their device time inside the forward, which is the
    time set against the 49 passes' bound."""
    from egohmr_tpu_torch.nn import ResNet, cast_params_bf16, resnet_forward
    from egohmr_tpu_torch.nn import resnet as resnet_module
    from egohmr_tpu_torch.nn import resnet_epilogue as re_
    from egohmr_tpu_torch.nn.core import batchnorm_eval

    passes = re_.RESNET50_PASSES
    if sum(n for *_, n in passes) != RESNET_PER_FORWARD:
        fail("RESNET50_PASSES does not list ResNet-50's 49 passes")
    dev, cl, B = torch.device("cuda"), torch.channels_last, B_TIME
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size", 50 * 2 ** 20)
    g = torch.Generator().manual_seed(5)
    gd = torch.Generator(device=dev).manual_seed(6)

    def bn_drawn(C):
        bn = torch.nn.BatchNorm2d(C).eval()
        with torch.no_grad():
            bn.weight.copy_(1 + 0.1 * torch.randn(C, generator=g))
            bn.bias.copy_(0.1 * torch.randn(C, generator=g))
            bn.running_mean.copy_(0.3 * torch.randn(C, generator=g))
            bn.running_var.copy_(1 + torch.rand(C, generator=g))
        return bn.to(dev)

    def act(shape, relu=False):
        x = torch.randn(shape, device=dev, generator=gd)
        return (torch.relu(x) if relu else x).bfloat16().contiguous(memory_format=cl)

    def rotating(call, sets):
        """`call(a, r)` on the next of `sets` each time: no call finds its
        bytes in L2 from the one before."""
        turn = itertools.count()
        return lambda: call(*sets[next(turn) % len(sets)])

    rows, summed = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    with torch.no_grad():
        for C, H, form, n in passes:
            bn, bn_ds = bn_drawn(C), bn_drawn(C)
            c, shape = re_.build_constants(bn), (B, C, H, H)
            c_ds = re_.build_constants(bn_ds) if form == 2 else None
            a = act(shape)
            r = act(shape, relu=form == 1) if form else None
            ref = re_.resnet_epilogue_reference(a, c, r, c_ds)
            got = re_.resnet_epilogue(a.clone(), c, r, c_ds)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                differ = int((got != ref).sum())
                fail(f"the ResNet epilogue differs from its plain statement at {shape}, form "
                     f"{form}: {differ} of {got.numel()} outputs")
            set_bytes = a.numel() * 2 * (2 if form else 1)
            sets = [(a, r)] + [(act(shape), act(shape, relu=form == 1) if form else None)
                               for _ in range(-(-4 * l2 // set_bytes) - 1)]
            ms = device_ms(rotating(lambda a_, r_: re_.resnet_epilogue(a_, c, r_, c_ds), sets))

            def plain(a_, r_):
                y = batchnorm_eval(bn, a_, 1)
                if form == 1:
                    y = y + r_
                elif form == 2:
                    y = y + batchnorm_eval(bn_ds, r_, 1)
                return torch.relu(y)

            plain_ms = device_ms(rotating(plain, sets))
            del sets
            nbytes = a.numel() * 2 * (3 if form else 2)
            bound_ms = nbytes / PEAK_BYTES * 1e3
            rows.append({"C": C, "H": H, "form": form, "passes": n, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms})
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
                summed[k] += n * v
            log("kernel", f"ResNet epilogue at [{B}, {C}, {H}, {H}], form {form} (x{n} a "
                          f"forward): bit for bit against its plain statement; device ms a pass "
                          f"(profiler, buffers rotated over 4x L2) {ms:.4f}, plain glue "
                          f"{plain_ms:.4f}, bound by bytes {bound_ms:.4f}: "
                          f"{bound_ms / ms * 100:.1f}% of it")
    log("kernel", f"ResNet epilogue, the {RESNET_PER_FORWARD} passes of a forward at B={B} "
                  f"timed each alone: {summed['ms']:.3f} ms, plain glue "
                  f"{summed['plain_ms']:.3f} ms; bound {summed['bound_ms']:.3f} ms by bytes")

    # one whole forward, fused and plain
    torch.manual_seed(7)
    model = ResNet(50).eval()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.load_state_dict(bn_drawn(m.num_features).cpu().state_dict())
    m16 = cast_params_bf16(model.to(dev))
    x = torch.randn(B, 224, 224, 3, generator=g).to(dev, torch.bfloat16)
    with torch.no_grad():
        feats, _ = profiled_launches(lambda: resnet_forward(m16, x), "a bf16 ResNet-50 forward",
                                     want={"resnet": RESNET_PER_FORWARD})
        forward_ms = device_ms(lambda: resnet_forward(m16, x), n=10)
        in_forward_ms = device_ms(lambda: resnet_forward(m16, x), n=10,
                                  kernel=DEVICE_KERNELS["resnet"][0])
        fused_ = resnet_module._fused
        resnet_module._fused = lambda *a: False
        try:
            plain = resnet_forward(m16, x)
            plain_forward_ms = device_ms(lambda: resnet_forward(m16, x), n=10)
        finally:
            resnet_module._fused = fused_
    gap = (feats.float() - plain.float()).abs().max().item()
    scale = plain.float().abs().max().item()
    log("kernel", f"bf16 ResNet-50 forward at B={B}, device ms (profiler): fused "
                  f"{forward_ms:.3f}, plain {plain_forward_ms:.3f}; the {RESNET_PER_FORWARD} "
                  f"passes inside the fused forward {in_forward_ms:.3f} ms against their "
                  f"{summed['bound_ms']:.3f} ms bound by bytes "
                  f"({summed['bound_ms'] / in_forward_ms * 100:.1f}% of it); features fused vs "
                  f"plain max |diff| {gap:.3e} of max {scale:.3e}")
    if not (gap <= 0.05 * scale and torch.isfinite(feats.float()).all()):
        fail("the fused ResNet-50 forward strays from the plain one beyond 0.05 of the largest")
    return {"name": "resnet_epilogue", "route": "cuda",
            "source": "egohmr_tpu_torch/csrc/resnet_epilogue.cu", "replaces": None,
            "ms": in_forward_ms, "bound_ms": summed["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "alone_ms": summed["ms"], "plain_ms": summed["plain_ms"],
            "forward_ms": forward_ms, "plain_forward_ms": plain_forward_ms, "by_shape": rows}


def k1_agrees(got, ref):
    """K1's pooled features against the plain version's: the largest
    error, its bar (2^-7 x max|plain|, two bf16 ulps of the largest pooled
    value), the least cosine per cloud (>= 0.9999), and whether all hold."""
    err = (got - ref).abs().max().item()
    bar = 2.0 ** -7 * ref.abs().max().item()
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1).min().item()
    return err, bar, cos, bool(torch.isfinite(got).all()) and err <= bar and cos >= 0.9999


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


def k2_score_gap(pts, verts, got, ref):
    """Where K2's pick and the plain version's differ by more than
    `k2_agrees` allows: the largest ratio of the gap between the two picks'
    scores |v|^2 - 2 p.v (the quantity both argmin, here in f64) to what the
    f32 evaluation of those scores can err, 8 u (|v|^2 + 2 sum |p_i v_i|)
    for each pick (u = 2^-24). At most 1: the kernel's pick is an argmin of
    the f32 score, a near-tie that the other sum order resolves the other
    way. Far from the origin (bodies in the camera frame, metres away) that
    rounding exceeds `k2_agrees`'s fixed distance bar near a vertex.
    Returns (that ratio, the largest f64 distance of the kernel's pick less
    the plain version's)."""
    p = pts.double()

    def score(idx):
        v = torch.gather(verts, 1, idx[..., None].expand(-1, -1, 3)).double()
        sq = (v * v).sum(-1)
        return (sq - 2.0 * (p * v).sum(-1), 8 * 2.0 ** -24 * (sq + 2.0 * (p * v).abs().sum(-1)),
                torch.linalg.norm(p - v, dim=-1))

    (s_got, e_got, d_got), (s_ref, e_ref, d_ref) = score(got), score(ref)
    return float(((s_got - s_ref) / (e_got + e_ref)).max()), float((d_got - d_ref).max())


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
    pred.warmup(full)  # captures the request's program (cuDNN, K1's weights, the pool)
    if not pred.captured:
        fail("the one-device Predictor on the card is not captured")
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
    fused_starts()
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
    # a replayed request's launches by the replay accounting against the
    # device's kernels
    out, _ = profiled_launches(lambda: pred(full, seed=2), "serve: a replayed request",
                               want={"k1": 1, "k2": 0, "gconv": GCONV_PER_CALL * 5,
                                     "resnet": RESNET_PER_FORWARD})
    check(out, B)
    log("serve", f"a replayed request under the profiler: K1 1 launch, {GCONV_PER_CALL * 5} "
                 f"fused graph convolutions, {RESNET_PER_FORWARD} fused ResNet passes by the "
                 "replay accounting and by the device's kernels")
    launches = k1.launches  # main path ends
    fused_ends("serve")
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


def penetrated(batch, out, leg, n_in: int = 1024):
    """The request with its first `n_in` scene points moved into the bbox of
    the legs (the vertices `leg`) of `out`'s bodies (canonical frame +
    translation)."""
    v = out["pred_vertices"][:, 0][:, leg]
    lo, hi = v.min(1, keepdims=True), v.max(1, keepdims=True)
    u = np.random.RandomState(0).rand(v.shape[0], n_in, 3).astype(np.float32)
    scene = batch["scene_pcd_verts_full"].copy()
    scene[:, :n_in] = lo + (hi - lo) * u + batch["smpl_params"]["transl"][:, None]
    return {**batch, "scene_pcd_verts_full": scene}


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
        batch = penetrated(batch, free(batch, seed=1), leg)
        pred = predictor(sampler, schedule, B, with_guidance=True)
        pred.warmup(batch)  # captures the request's program
        served.append((pred, batch, free))
    torch.cuda.synchronize()

    k1.launches = k2.launches = 0  # main path starts: count launches from here
    fused_starts()
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
        # a replayed request's launches by the replay accounting against the
        # device's kernels
        out, _ = profiled_launches(lambda: pred(batch, seed=2),
                                   f"guided {sampler}: a replayed request",
                                   want={"k1": 1, "k2": n_guided,
                                         "gconv": GCONV_PER_CALL * schedule.num_timesteps,
                                         "resnet": RESNET_PER_FORWARD})
        check(out, B)
        log("guided", f"{sampler}: a replayed request under the profiler: K1 1, K2 {n_guided} "
                      "launches by the replay accounting and by the device's kernels")
    counts = {"k1": k1.launches, "k2": k2.launches}  # main path ends
    fused_ends("guided")

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

    (model, smpl, stats, _, _), cfg = pred._replicas[0], pred.cfg
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

    p = graph_profile(lambda: pred(batch, seed=1))
    if p["kernel_ms"] > 0:
        log("guided", f"{name}: one replayed request under the profiler: {p['kernel_ms']:.1f} ms "
                      f"of kernels and copies in {p['device_kernels']} device launches "
                      f"({n_guided} guided steps), host launch calls {p['host']}")
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
                             **kw)

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
        fused_starts()
        summary, secs = run(extra)
        d1, d2 = k1.launches, k2.launches  # main path ends
        fused_ends("eval")
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
        fused_starts()
        t = time.perf_counter()
        train_egohmr.main(args + ["--num_steps", "2"])
        train_egohmr.main(args + ["--num_steps", "4"])
        secs = time.perf_counter() - t
        counts = {"k1": k1.launches, "k2": k2.launches}  # main path ends
        fused_ends("train")
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


# stage 1's evaluation CLI at its defaults (batch 10, 5 samples, K1), 6
# batches: the first prepares K1's weights, the other five are timed apart
S1_ARGS = ["--synthetic", "--device", "cuda", "--num_batches", "6"]
S1_BATCHES = 6
S1_TRAIN_B = 32  # the stage-1 training CLI's default batch
# the bar on the CLI's translations, K1 against the f32 plain encoder, in mm:
# four times the 0.5 mm predicted before the first run (`PERF.md`)
S1_TRANSL_BAR_MM = 2.0
S1_ERROR_BAR_MM = 5.0  # every error key, as in phase 6


def phase_stage1() -> dict:
    """Stage 1 at full width (`ProHMRConfig()`: ResNet-50, the 4-step Glow at
    hidden 1024 over a 2566-d context, PointNet H=256 on 20,000 points, 6890
    vertices), random weights from a seed, synthetic data: (a) the
    evaluation CLI at its defaults with K1, counted by its wrapper and the
    profiler, K1 held to its plain version on the clouds the CLI gave it,
    and the summary and translations held to the CLI's f32 plain run; (b)
    the stage-2 CLI with `--two_stage true` conditioned on the translations
    of (a)'s `results.pkl`, handed in with its synthetic batches (the pkl
    -> `EgoBodyDataset` path is held on the CPU by
    `tests/test_torch_prohmr_cli.py`); (c) the training CLI, 2 steps resumed to 4 at
    batch 32, K1 0 launches; (d) the G+D step's time, imgs/s, peak memory
    and kernels."""
    import pickle
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from egohmr_tpu_torch.data import synthetic_batch, to_torch
    from egohmr_tpu_torch.eval import test_egohmr as s2cli
    from egohmr_tpu_torch.eval import test_prohmr as s1cli
    from egohmr_tpu_torch.models import Discriminator, ProHMR, ProHMRConfig, ProHMRLossWeights
    from egohmr_tpu_torch.models import init_discriminator_, prohmr
    from egohmr_tpu_torch.nn import pointnet_fused as k1
    from egohmr_tpu_torch.smpl import make_synthetic_model
    from egohmr_tpu_torch.train import make_optimizers, make_prohmr_train_step, train_prohmr

    dev = torch.device("cuda")
    cfg = ProHMRConfig()
    B, S = s1cli.parse_args([]).batch_size, s1cli.parse_args([]).num_samples
    result = {}
    tmp = tempfile.TemporaryDirectory()

    # ---- (a) the evaluation CLI: every batch's forward timed, K1's inputs kept
    forward, fused = s1cli.forward, prohmr.pointnet_forward_fused
    per_batch, seen = [], []

    def timed_forward(*a, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        out = forward(*a, **kw)
        end.record()
        end.synchronize()
        per_batch.append((start.elapsed_time(end), (time.perf_counter() - t) * 1e3))
        return out

    def spy(enc, pts):
        seen.append((enc, pts.clone()))
        return fused(enc, pts)

    s1cli.forward, prohmr.pointnet_forward_fused = timed_forward, spy
    runs = {}
    try:
        s1cli.main(S1_ARGS[:-1] + ["1", "--save_results", "false"])  # warm-up
        for name, extra in (("fused", []), ("xla", ["--pointnet_impl", "xla"])):
            per_batch.clear()
            seen.clear()
            save = f"{tmp.name}/{name}"
            k1.launches = 0  # main path starts: count launches from here
            t = time.perf_counter()
            summary = s1cli.main(S1_ARGS + extra + ["--save_root", save])
            secs = time.perf_counter() - t
            launches = k1.launches  # main path ends
            with open(f"{save}/results.pkl", "rb") as f:
                transl = pickle.load(f)["pred_cam_full_list"]
            runs[name] = {"summary": summary, "transl": transl, "launches": launches,
                          "secs": secs, "batches": list(per_batch), "seen": list(seen)}
            # the first batch prepares K1's weights (a new model each run)
            ev, host = (float(np.median([b[i] for b in per_batch[1:]])) for i in (0, 1))
            log("stage1", f"eval CLI --pointnet_impl {name}, {B} images x {S} samples x "
                          f"{S1_BATCHES} batches: {secs:.2f} s for the whole run (model set-up "
                          f"included); ms per batch's forward, CUDA events "
                          f"{[round(b[0], 3) for b in per_batch]}, host clock "
                          f"{[round(b[1], 3) for b in per_batch]} (first {per_batch[0][0]:.3f} "
                          f"/ {per_batch[0][1]:.3f}, median of the other "
                          f"{len(per_batch) - 1} {ev:.3f} / {host:.3f}); K1 launches {launches}")
            runs[name].update(event_ms=ev, host_ms=host, first_event_ms=per_batch[0][0],
                              first_host_ms=per_batch[0][1])
        # the whole run under one profiler session: K1's four stage kernels
        # per call, and the kernels of each batch's forward. One session, not
        # one a batch: a session stopped and started once a batch has been
        # seen to lose a batch's kernels. A marker kernel runs on a
        # synchronized card before and after each forward, so the device's
        # own clock tells each forward's kernels from the rest of the run.
        def marker():
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)  # `spin_kernel`
            torch.cuda.synchronize()

        def marked_forward(*a, **kw):
            marker()
            out = forward(*a, **kw)
            marker()
            return out

        s1cli.forward = marked_forward
        k1.launches = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            s1cli.main(S1_ARGS + ["--save_root", f"{tmp.name}/profiled"])
            torch.cuda.synchronize()
    finally:
        s1cli.forward, prohmr.pointnet_forward_fused = forward, fused
    device = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    profiled, batch, inside = [], [], False
    for e in device:
        if "spin_kernel" in e.name:
            if inside:
                profiled.append((sum(k.time_range.elapsed_us() for k in batch) / 1e3,
                                 len(batch), sum("stage_kernel" in k.name for k in batch)))
            batch, inside = [], not inside
        elif inside:
            batch.append(e)
    if len(profiled) != S1_BATCHES or inside:
        fail(f"stage-1 eval under the profiler: {len(profiled)} forwards between markers "
             f"(want {S1_BATCHES})")
    stages = sum("stage_kernel" in e.name for e in device)  # in the forwards or not
    got, want = runs["fused"], runs["xla"]
    prof_ms, prof_launches = profiled[-1][:2]  # the last batch: K1's weights prepared
    log("stage1", f"K1 under the profiler: {stages} stage_kernel launches, {stages / 4:g} K1 "
                  f"calls (wrapper: {k1.launches}); each batch's forward: "
                  f"{[round(p[0], 2) for p in profiled]} ms of kernels in "
                  f"{[p[1] for p in profiled]} launches")
    if got["launches"] != S1_BATCHES or want["launches"] != 0 or stages != 4 * S1_BATCHES:
        fail(f"stage-1 eval: K1 launched {got['launches']} times with fused, "
             f"{want['launches']} with xla, {stages} stage kernels profiled (want "
             f"{S1_BATCHES}, 0, {4 * S1_BATCHES})")
    if len(got["seen"]) != S1_BATCHES or want["seen"]:
        fail(f"stage-1 eval: K1 was handed {len(got['seen'])} clouds (want {S1_BATCHES})")
    # K1 against its plain version on the clouds the CLI gave it
    k1_err = 0.0
    for enc, pts in got["seen"]:
        feat = k1.pointnet_fused_feature(enc, pts)
        ref = k1.pointnet_fused_reference(enc, pts)
        err, bar = (feat - ref).abs().max().item(), 2.0 ** -7 * ref.abs().max().item()
        log("stage1", f"K1 vs plain on the CLI's clouds [{pts.shape[0]}, {pts.shape[1]}]: "
                      f"max_abs_err {err:.3e} (bar {bar:.3e})")
        if not torch.isfinite(feat).all() or err > bar:
            fail("K1 disagrees with its plain version on stage 1's clouds")
        k1_err = max(k1_err, err)
    enc, pts = got["seen"][0]
    with torch.no_grad():
        k1_ms = time_ms(lambda: k1.pointnet_fused_feature(enc, pts), reps=20)
        k1_plain_ms = time_ms(lambda: k1.pointnet_fused_reference(enc, pts), reps=5)
    k1b = k1_bound(enc, pts.shape[0], pts.shape[1])
    log("stage1", f"K1 at B={pts.shape[0]}, P={pts.shape[1]}, median of CUDA-event timings: "
                  f"{k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms, bound {k1b['bound_ms']:.3f} "
                  f"ms by {k1b['bound_by']} ({k1b['bound_ms'] / k1_ms * 100:.1f}%)")
    # the summary and the translations against the f32 plain run
    if list(got["summary"]) != ["g_mpjpe", "mpjpe", "pa_mpjpe", "v2v"] or \
            list(want["summary"]) != list(got["summary"]):
        fail(f"stage-1 summary keys {list(got['summary'])}, {list(want['summary'])}")
    for key, v in got["summary"].items():
        w = want["summary"][key]
        log("stage1", f"{key}: K1 {v:.4f} mm, f32 plain {w:.4f} mm, |diff| {abs(v - w):.4f} "
                      f"(bar {S1_ERROR_BAR_MM})")
        if not (np.isfinite(v) and abs(v - w) <= S1_ERROR_BAR_MM):
            fail(f"stage-1 {key}: {v} with K1, {w} f32 plain")
    if got["transl"].shape != (B * S1_BATCHES, 3) or not np.isfinite(got["transl"]).all():
        fail(f"stage-1 translations: shape {got['transl'].shape} or non-finite")
    dt = np.abs(got["transl"] - want["transl"]) * 1e3
    log("stage1", f"pred_cam_full_list, K1 against f32 plain: max |diff| {dt.max():.4f} mm, "
                  f"mean {dt.mean():.4f} mm (bar {S1_TRANSL_BAR_MM} mm); depths "
                  f"{got['transl'][:, 2].min():.3f}-{got['transl'][:, 2].max():.3f} m")
    if not dt.max() <= S1_TRANSL_BAR_MM:
        fail("stage-1 translations with K1 stray from the f32 plain run")
    result.update(launches=got["launches"], eval_event_ms=got["event_ms"],
                  eval_kernel_ms_per_batch=prof_ms,
                  eval_launches_per_batch=prof_launches,
                  eval_host_ms=got["host_ms"], eval_plain_event_ms=want["event_ms"],
                  eval_plain_host_ms=want["host_ms"], eval_first_event_ms=got["first_event_ms"],
                  eval_first_host_ms=got["first_host_ms"],
                  eval_plain_first_event_ms=want["first_event_ms"],
                  transl_max_diff_mm=float(dt.max()),
                  summary=got["summary"], summary_plain=want["summary"],
                  k1={"max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms, **k1b,
                      "shape": list(pts.shape)})

    # ---- (b) the handoff: the stage-2 CLI conditioned on (a)'s translations
    handoff = got["transl"]
    batches, sample = s2cli.synthetic_batch, s2cli.sample_bodies
    read = []

    def stage1_data(batch_size, *, seed, device):
        i = seed - 100  # the stage-2 CLI's batch i: stage 1's images and translations
        batch = synthetic_batch(batch_size, seed=200 + i)
        batch["stage1_transl_full"] = handoff[i * batch_size:(i + 1) * batch_size]
        return to_torch(batch, device)

    def recording(*a, **kw):
        outputs, cond = sample(*a, **kw)
        read.append(cond.input_transl.float().cpu().numpy())
        return outputs, cond

    s2cli.synthetic_batch, s2cli.sample_bodies = stage1_data, recording
    try:
        s2cli.main(["--synthetic", "--device", "cuda", "--batch_size", str(B), "--num_batches",
                    str(S1_BATCHES), "--num_samples", "1", "--timestep_respacing_eval", "ddim5",
                    "--with_coap_grad", "false", "--two_stage", "true", "--save_results", "true",
                    "--save_root", f"{tmp.name}/s2"])
    finally:
        s2cli.synthetic_batch, s2cli.sample_bodies = batches, sample
    with open(f"{tmp.name}/s2/output_egohmr_synthetic/results_seed_0.pkl", "rb") as f:
        carried = pickle.load(f)["pred_cam_full_list"]
    used = np.concatenate(read)
    log("stage1", f"handoff: the stage-2 CLI conditioned {used.shape[0]} images on the "
                  f"translations of stage 1's results.pkl, handed in with its batches (max "
                  f"|diff| {np.abs(used - handoff).max():.3e} m), and wrote them back (max "
                  f"|diff| {np.abs(carried - handoff).max():.3e} m)")
    if used.shape != handoff.shape or not np.array_equal(used, handoff) or \
            not np.array_equal(carried, handoff):
        fail("the stage-2 CLI did not read stage 1's translations")

    # ---- (c) the training CLI: 2 steps, then resumed to 4
    args = ["--synthetic", "--device", "cuda", "--log_step", "1", "--data_parallel", "false",
            "--save_dir", f"{tmp.name}/train"]
    k1.launches = 0  # main path starts: count launches from here
    t = time.perf_counter()
    train_prohmr.main(args + ["--num_steps", "2"])
    train_prohmr.main(args + ["--num_steps", "4"])
    secs = time.perf_counter() - t
    train_k1 = k1.launches  # main path ends
    with open(f"{tmp.name}/train/metrics.jsonl") as f:
        metrics = [json.loads(line) for line in f]
    steps = [m["step"] for m in metrics]
    log("stage1", f"training CLI, --synthetic, batch {S1_TRAIN_B}, f32 (TF32 off), 2 steps then "
                  f"resumed to 4: {secs:.1f} s (model set-up and checkpoints included), "
                  f"metrics.jsonl steps {steps}, losses "
                  f"{[round(m['loss'], 3) for m in metrics]}, K1 launches {train_k1}")
    if steps != [0, 1, 2, 3] or train_k1 != 0 or \
            not all(np.isfinite(v) for m in metrics for v in m.values()):
        fail(f"the stage-1 training CLI: steps {steps}, K1 launches {train_k1}")
    result["train_launches"] = train_k1
    tmp.cleanup()

    # ---- (d) the G+D step at batch 32: time, imgs/s, peak memory, kernels
    smpl = make_synthetic_model(num_vertices=V_FULL, device=dev)
    model = prohmr.init_random_(ProHMR(cfg), seed=0, training=True)
    model = model.to(dev, memory_format=torch.channels_last)
    disc = init_discriminator_(Discriminator(), seed=10).to(dev)
    tb = [synthetic_batch(S1_TRAIN_B, num_scene_points=P_FULL, seed=i, device=dev)
          for i in range(5)]
    prohmr.initialize(model, cfg, tb[0])
    opt, dopt = make_optimizers(model, disc)
    step = make_prohmr_train_step(cfg, ProHMRLossWeights(), smpl, smpl, smpl, opt, dopt)
    rng = np.random.RandomState(0)
    mocap = [to_torch({"body_pose": rng.randn(S1_TRAIN_B, 69).astype(np.float32) * 0.3,
                       "betas": rng.randn(S1_TRAIN_B, 10).astype(np.float32) * 0.5}, dev)
             for _ in range(4)]
    gen = torch.Generator(device=dev).manual_seed(1)
    for i in range(3):  # warm-up: cuDNN algorithm selection, allocator growth
        step(model, disc, tb[1 + i % 4], mocap[i % 4], gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = k1.launches
    dev_ms, host_ms, losses = [], [], []
    for i in range(20):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t = time.perf_counter()
        start.record()
        m = step(model, disc, tb[1 + i % 4], mocap[i % 4], gen)
        end.record()
        end.synchronize()
        host_ms.append((time.perf_counter() - t) * 1e3)
        dev_ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    if k1.launches != before or not np.isfinite(losses).all():
        fail(f"stage-1 training steps: K1 launched {k1.launches - before} times (want 0), "
             f"losses {losses}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(model, disc, tb[1], mocap[0], gen)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    tr = {"ms": float(np.median(dev_ms)), "host_ms": float(np.median(host_ms)),
          "peak_mib": peak, "kernel_ms": sum(e.self_device_time_total for e in events) / 1e3,
          "kernel_launches": sum(e.count for e in events),
          "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top}}
    tr["imgs_per_s"] = S1_TRAIN_B / tr["host_ms"] * 1e3
    log("stage1", f"G+D step, batch {S1_TRAIN_B}, f32 (TF32 off), median of 20 after 3 warm-up: "
                  f"{tr['ms']:.2f} ms (CUDA events), {tr['host_ms']:.2f} ms (host clock), "
                  f"{tr['imgs_per_s']:.1f} imgs/s, peak memory {peak:.0f} MiB; losses "
                  f"{losses[0]:.3f} -> {losses[-1]:.3f}; one step under the profiler: "
                  f"{tr['kernel_ms']:.2f} ms of kernels in {tr['kernel_launches']} launches, the "
                  "largest: " + ", ".join(f"{k} {v:.2f}" for k, v in tr["top_kernels_ms"].items()))
    result["train_step"] = tr
    return result


# ---------------------------------------------------------------- phase 9
# the shipped distilled collision nets; the two 192-wide ones, one per
# backend, serve the evaluation-shape query and the guided requests
LEARNED_ARTIFACTS = ("occupancy_synthetic.npz", "occupancy_synthetic_signed.npz",
                     "volsdf_synthetic.npz")
WIDE = {"occupancy": "occupancy_synthetic_signed.npz", "volsdf": "volsdf_synthetic.npz"}
# distillation steps: after 300 both nets still give the all-outside
# answer on the held-out draw
DISTILL_STEPS = 1000
# the widths `occupancy_synthetic_signed.npz` was distilled at: at the
# occupancy CLI's defaults (no part code) the net stays near the
# all-outside answer for longer
SIGNED_RECIPE = ["--part_embed_dim", "32", "--hidden_dim", "192", "--num_layers", "5"]


def artifact(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts", name)


def load_learned(name: str, device):
    """(net on `device`, sidecar) of a shipped artifact."""
    from egohmr_tpu_torch.collision.neural_occupancy import load_occupancy
    from egohmr_tpu_torch.collision.neural_sdf import load_sdfnet

    with open(artifact(name) + ".json") as f:
        meta = json.load(f)
    load = load_sdfnet if name.startswith("volsdf") else load_occupancy
    return load(artifact(name), device), meta


def body_of(meta: dict, device):
    """The body an artifact was distilled on (its sidecar's `body`)."""
    from egohmr_tpu_torch.smpl import make_synthetic_model, make_synthetic_watertight_model

    if meta["body"] == "synthetic_watertight":
        return make_synthetic_watertight_model(device=device)
    return make_synthetic_model(num_vertices=V_FULL, device=device)


def learned_field(net, out, betas, pts):
    """The backend's own field: occupancy, or signed distance."""
    from egohmr_tpu_torch.collision.neural_occupancy import occupancy_query
    from egohmr_tpu_torch.collision.neural_sdf import SDFNetConfig, sdf_query

    query = sdf_query if isinstance(net.cfg, SDFNetConfig) else occupancy_query
    return query(net, out, betas, pts)


def learned_loss(net, out, betas, pts):
    """The backend's own collision loss per body, [B]."""
    from egohmr_tpu_torch.collision.neural_occupancy import occupancy_collision_loss
    from egohmr_tpu_torch.collision.neural_sdf import SDFNetConfig, sdf_collision_loss

    field = learned_field(net, out, betas, pts)
    if isinstance(net.cfg, SDFNetConfig):
        return sdf_collision_loss(field)
    return occupancy_collision_loss(field)


def field_flops(net, rows: int) -> float:
    """The decoder's f32 operations for `rows` (body, part, point) rows: the
    split first layer's point half (3 x hidden) and the hidden and output
    layers; the per-(body, part) half is left out."""
    widths = [m.weight.shape[0] for m in net.decoder]  # nn.Linear weights are [out, in]
    macs = 3 * widths[0] + sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    return 2.0 * macs * rows


def phase_learned_artifacts() -> None:
    """(a) each shipped artifact on the card: its held-out agreement on draws
    made on the card (labels through K2) against its sidecar's bar less
    0.02, and its query on CPU-made inputs against the CPU's."""
    from egohmr_tpu_torch.collision.neural_occupancy import (occupancy_agreement,
                                                             sample_labeled_batch)
    from egohmr_tpu_torch.collision.neural_sdf import sdf_agreement
    from egohmr_tpu_torch.smpl import SMPLOutput

    dev = torch.device("cuda")
    for name in LEARNED_ARTIFACTS:
        net, meta = load_learned(name, dev)
        body = body_of(meta, dev)
        g = torch.Generator(dev).manual_seed(123)
        kw = dict(n_bodies=16, points_per_body=1024, label_mode=meta["label_mode"],
                  sign_k=meta.get("sign_k", 4))
        if name.startswith("volsdf"):
            acc, bar = sdf_agreement(net, body, g, **kw)["sign_agreement"], meta["agreement_bar"]
            shipped = meta["sign_agreement"]
        else:
            acc, bar = occupancy_agreement(net, body, g, **kw), meta["accuracy_bar"]
            shipped = meta["accuracy"]
        # the same CPU-made inputs through the CPU's net and the card's
        cpu_net, _ = load_learned(name, "cpu")
        b = sample_labeled_batch(torch.Generator().manual_seed(5), body_of(meta, "cpu"),
                                 batch_bodies=4, points_per_body=2048, label_mode="proximity")
        with torch.no_grad():
            want = learned_field(cpu_net, b.smpl_out, b.betas, b.points)
            got = learned_field(net, SMPLOutput(*(t.to(dev) for t in b.smpl_out)),
                                b.betas.to(dev), b.points.to(dev)).cpu()
        err = (got - want).abs().max().item()
        close = torch.allclose(got, want, rtol=1e-4, atol=1e-5)
        log("learned", f"(a) {name} ({meta['body']}, {meta['label_mode']} labels, hidden "
                       f"{net.cfg.hidden_dim} x {net.cfg.num_layers}): agreement on the card's "
                       f"draws, 16 bodies x 1024 points, {acc:.4f} (sidecar {shipped:.4f}, bar "
                       f"{bar - 0.02:.2f}); card vs CPU query on 4 x 2048 CPU-made points: max "
                       f"abs {err:.3e} (rtol 1e-4, atol 1e-5)")
        if not acc >= bar - 0.02:
            fail(f"{name}: agreement {acc:.4f} on the card under {bar - 0.02:.2f}")
        if not close:
            fail(f"{name}: the card's query strays from the CPU's")


def phase_learned_query() -> dict:
    """(b) the learned collision ratio's query at the evaluation shape, 8
    images x 5 samples = 40 bodies x 20,000 points, with each 192-wide net:
    CUDA-event time, peak memory, and the chunked query against an unchunked
    one on a 2,048-point slice."""
    from functools import partial

    from egohmr_tpu_torch.collision.neural_occupancy import (NUM_PARTS, QUERY_ROWS,
                                                             field_in_chunks, occupancy_from_raw)
    from egohmr_tpu_torch.collision.neural_sdf import SDFNetConfig, sdf_from_raw
    from egohmr_tpu_torch.smpl import lbs, make_synthetic_model

    dev = torch.device("cuda")
    n = 40
    g = torch.Generator(dev).manual_seed(9)
    smpl = make_synthetic_model(num_vertices=V_FULL, device=dev)
    betas = torch.randn(n, 10, generator=g, device=dev) * 0.5
    aa = torch.randn(n, 24, 3, generator=g, device=dev) * 0.2
    out = lbs(smpl, betas, aa[:, 0], aa[:, 1:].reshape(n, 69), pose2rot=True)
    lo, hi = out.vertices.amin(1, keepdim=True) - 0.3, out.vertices.amax(1, keepdim=True) + 0.3
    scene = lo + (hi - lo) * torch.rand(n, P_FULL, 3, generator=g, device=dev)
    timed = {}
    for backend, name in WIDE.items():
        net, _ = load_learned(name, dev)
        head = (partial(sdf_from_raw, net.cfg) if isinstance(net.cfg, SDFNetConfig)
                else occupancy_from_raw)
        with torch.no_grad():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            full = field_in_chunks(net, out, betas, scene, head)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            ms = time_ms(lambda: field_in_chunks(net, out, betas, scene, head), reps=5)
            ref = learned_field(net, out, betas, scene[:, :2048])
        err = (full[:, :2048] - ref).abs().max().item()
        rows = n * NUM_PARTS * P_FULL
        flops = field_flops(net, rows)
        log("learned", f"(b) {backend} ({name}), {n} bodies x {P_FULL} points = {rows:,} rows in "
                       f"chunks of {QUERY_ROWS:,}: {ms:.2f} ms by CUDA events (median of 5), "
                       f"{flops / ms / 1e9:.1f} TFLOP/s f32 of the decoder's {flops / 1e12:.2f} "
                       f"TFLOP (f32 CUDA-core peak 67), peak memory {peak:.0f} MiB above the "
                       f"inputs; chunked vs unchunked on the first 2048 points: max abs "
                       f"{err:.3e}")
        if not (torch.isfinite(full).all() and full.shape == (n, P_FULL)):
            fail(f"{backend}: the evaluation-shape query is not finite or misshapen")
        if not torch.allclose(full[:, :2048], ref, rtol=1e-4, atol=1e-5):
            fail(f"{backend}: the chunked query strays from the unchunked one")
        timed[backend] = {"ms": ms, "peak_mib": peak, "tflop": flops / 1e12}
    return timed


# (sampler, respacing, batch, guided steps per request)
LEARNED_GUIDED_RUNS = (("ddim", "ddim5", 64, 4), ("ddpm", "", 16, 11))
# the scenes (`synthetic_batch` seeds) on which learned guidance must act; the
# first also serves the timed request. Of one scene's 64 bodies the count that
# collides less moves by some 3 from seed to seed (47-57 on seeds 20-24), so
# the bar holds the bodies of all five together.
LEARNED_SCENE_SEEDS = (20, 21, 22, 23, 24)


# guidance weights for the check that the learned guidance lowers
# collisions: the reference's times the batch (the loss is a batch mean)
# times 1e5, as in phase 5. The reference's DDPM weight is the CLI's: 2 for
# occupancy (`test_egohmr`), 30 for volsdf (`test_egohmr_volsmpl`)
def raised(backend: str, sampler: str, B: int) -> dict:
    if sampler == "ddim":
        return dict(ddim_scale=1.0 * B * 1e5)
    return dict(cond_grad_weight=(30.0 if backend == "volsdf" else 2.0) * B * 1e5)


def phase_learned_guided(cfg) -> dict:
    """(c) learned-guided sampling at full width, bf16 with K1: guided
    DDIM-5 at batch 64 and guided DDPM-50 at batch 16 with each backend's
    192-wide net on the body it was distilled on; request latency, the
    guided step's time, launches (K1 once, K2 never) and peak memory; then
    guidance acts, on scenes with 1024 points inside the unguided bodies'
    legs, at raised weights: over the bodies of `LEARNED_SCENE_SEEDS`'
    scenes together, the loss falls by over 1% and at least 80% of them
    collide less."""
    from egohmr_tpu_torch.collision import knn as k2
    from egohmr_tpu_torch.collision import topk_scene_points
    from egohmr_tpu_torch.collision.neural_occupancy import NUM_PARTS, make_occupancy_guidance_fn
    from egohmr_tpu_torch.collision.neural_sdf import make_volsdf_guidance_fn
    from egohmr_tpu_torch.data import synthetic_batch, to_torch
    from egohmr_tpu_torch.diffusion import GuidanceConfig, make_schedule
    from egohmr_tpu_torch.eval import sample_bodies
    from egohmr_tpu_torch.eval.pipeline import _to_f32, tile_condition
    from egohmr_tpu_torch.geometry import rotmat_to_rot6d
    from egohmr_tpu_torch.models import BodyRepStats, EgoHMR, compute_condition, init_random_
    from egohmr_tpu_torch.nn import cast_params_bf16
    from egohmr_tpu_torch.nn import pointnet_fused as k1
    from egohmr_tpu_torch.smpl import SMPLOutput

    dev = torch.device("cuda")
    fused = replace(cfg, pointnet_impl="fused")
    model = cast_params_bf16(init_random_(EgoHMR(cfg), seed=0).eval()).to(
        dev, memory_format=torch.channels_last)
    rest = rotmat_to_rot6d(torch.eye(3).expand(24, 3, 3)).reshape(144).to(dev)
    stats = BodyRepStats(rest, torch.full((144,), 0.2, device=dev))
    runs = [(sampler, make_schedule(50, "cosine", respacing).to(dev), B, n_guided)
            for sampler, respacing, B, n_guided in LEARNED_GUIDED_RUNS]
    counts, timed = {"k1": 0, "k2": 0}, {}

    def sample(net, smpl, backend, sampler, schedule, batch, guided, **kw):
        out, _ = sample_bodies(model, fused, smpl, stats, schedule, batch,
                               torch.Generator(device=dev).manual_seed(1), 1, sampler=sampler,
                               with_guidance=guided, collision_backend=backend, occ_net=net,
                               **kw)
        return out

    def losses(net, out, batch):
        """Per-body learned collision loss of the served bodies against the
        guidance's 4096 scene points nearest the body's origin."""
        n = out["pred_pose_rotmat"].shape[0]
        smpl_out = SMPLOutput(vertices=None, joints=None,
                              full_pose=out["pred_pose_rotmat"].reshape(n, 24, 3, 3),
                              joints_smpl=out["pred_joints_smpl"].reshape(n, 24, 3))
        scene = batch["scene_pcd_verts_full"] - batch["smpl_params"]["transl"][:, None]
        with torch.no_grad():
            return learned_loss(net, smpl_out, out["pred_betas"].reshape(n, 10),
                                topk_scene_points(scene, 4096)).cpu().numpy()

    for backend, name in WIDE.items():
        net, meta = load_learned(name, dev)
        smpl = body_of(meta, dev)
        # the body's parts are closed ellipsoids, each rigidly skinned to one
        # joint, so a point between a leg vertex and its part's centre lies
        # inside the leg; the points fill the legs' +x halves only, as a
        # scene surface that cuts into them from one side would (points all
        # round a limb would pull it every way at once)
        owner = smpl.lbs_weights.argmax(1)
        leg = torch.nonzero(torch.isin(owner, torch.tensor(LEG_JOINTS, device=dev)))[:, 0]
        one_hot = torch.nn.functional.one_hot(owner, 24).float()  # [V, 24]

        def scene(sampler, schedule, B, seed):
            """The batch of `seed`, with 1024 scene points inside the legs of
            its unguided bodies."""
            batch = to_torch(synthetic_batch(B, num_scene_points=P_FULL, seed=seed), dev)
            free = sample(net, smpl, backend, sampler, schedule, batch, False)
            v = free["pred_vertices"][:, 0]
            centres = (one_hot.t() @ v) / one_hot.sum(0)[:, None]  # [B, 24, 3]
            front = (v[:, leg, 0] > centres[:, owner[leg], 0]).float()  # [B, L]
            g = torch.Generator(dev).manual_seed(0)
            pick = leg[torch.multinomial(front, 1024, replacement=True, generator=g)]
            u = 0.9 * torch.rand(B, 1024, 1, generator=g, device=dev)
            vp = torch.gather(v, 1, pick[..., None].expand(-1, -1, 3))
            cp = torch.gather(centres, 1, owner[pick][..., None].expand(-1, -1, 3))
            points = batch["scene_pcd_verts_full"].clone()
            points[:, :1024] = cp + u * (vp - cp) + batch["smpl_params"]["transl"][:, None]
            return {**batch, "scene_pcd_verts_full": points}

        for sampler, schedule, B, n_guided in runs:
            batch = scene(sampler, schedule, B, LEARNED_SCENE_SEEDS[0])
            sample(net, smpl, backend, sampler, schedule, batch, True)  # warm-up
            torch.cuda.synchronize()
            k1.launches = k2.launches = 0  # main path starts: count launches from here
            fused_starts()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = sample(net, smpl, backend, sampler, schedule, batch, True)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            d1, d2 = k1.launches, k2.launches  # main path ends
            fused_ends("learned")
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            counts["k1"] += d1
            counts["k2"] += d2
            # one guided step alone, at this batch
            with torch.no_grad():
                b16 = {**batch, "img": batch["img"].to(torch.bfloat16)}
                cond = _to_f32(tile_condition(compute_condition(model, fused, b16), 1))
                make = make_occupancy_guidance_fn if backend == "occupancy" else \
                    make_volsdf_guidance_fn
                guide = make(net, smpl, cond, stats)
                x = torch.randn(B, 144, generator=torch.Generator().manual_seed(3)).to(dev)
                tt = torch.zeros(B, dtype=torch.int64, device=dev)
                step_ms = time_ms(lambda: guide(x, tt), reps=5)
            rows = B * NUM_PARTS * 4096
            log("learned", f"(c) {backend}, guided {sampler} x{schedule.num_timesteps}, batch {B}, "
                           f"bf16 + K1, body {meta['body']}: request {ms:.1f} ms by the host "
                           f"clock ({B / ms * 1e3:.1f} bodies/s), one guided step {step_ms:.2f} ms "
                           f"by CUDA events ({rows:,} rows forward and backward), {n_guided} "
                           f"guided steps; K1 launches {d1}, K2 launches {d2}; peak memory "
                           f"{peak:.2f} GiB")
            if d1 != 1 or d2 != 0:
                fail(f"learned-guided {backend} {sampler}: K1 launched {d1} times (want 1), "
                     f"K2 {d2} (want 0)")
            for k, shape in {"pred_pose_6d": (B, 1, 144), "pred_vertices":
                             (B, 1, smpl.num_vertices, 3)}.items():
                if out[k].shape != shape or not torch.isfinite(out[k]).all():
                    fail(f"learned-guided {backend} {sampler}: {k} misshapen or not finite")
            timed[f"{backend}_{sampler}"] = {"request_ms": ms, "guided_step_ms": step_ms,
                                             "peak_gib": peak}
            # guidance acts: at raised weights the served bodies collide less
            weights = raised(backend, sampler, B)
            lf, lg, moved, per_scene = [], [], 0.0, []
            for seed in LEARNED_SCENE_SEEDS:
                if seed != LEARNED_SCENE_SEEDS[0]:
                    batch = scene(sampler, schedule, B, seed)
                free = sample(net, smpl, backend, sampler, schedule, batch, False)
                got = sample(net, smpl, backend, sampler, schedule, batch, True,
                             guidance=GuidanceConfig(**weights))
                lf.append(losses(net, free, batch))
                lg.append(losses(net, got, batch))
                gap = (got["pred_vertices"] - free["pred_vertices"]).abs().max().item()
                moved = max(moved, gap)
                per_scene.append(int((lg[-1] < lf[-1]).sum()))
                del free, got
            lf, lg = np.concatenate(lf), np.concatenate(lg)
            n = lf.size
            better, drop = int((lg < lf).sum()), 1.0 - lg.mean() / max(lf.mean(), 1e-30)
            log("learned", f"(c) {backend}, {sampler}, raised weights {weights}, scenes "
                           f"{list(LEARNED_SCENE_SEEDS)}: vertices moved by up to {moved:.3e} m; "
                           f"learned collision loss guided {lg.mean():.6e}, unguided "
                           f"{lf.mean():.6e} (least unguided {lf.min():.3e}): down "
                           f"{drop * 100:.2f}% (bar 1%), {better} of {n} bodies collide less "
                           f"(bar {0.8 * n:.0f}; by scene {per_scene} of {B})")
            if backend == "volsdf" and sampler == "ddim":
                # The last DDIM step adds to the denoiser's x0 a gradient taken
                # at x_t's pose; the random denoiser's x0 is another pose, and
                # the signed distance is zero-gradient outside the thin limbs,
                # so at x_t's pose the points rarely sit in the legs (the
                # vertices move by millimetres). The soft occupancy still
                # pulls there; the learned SDF is held to the bar in DDPM.
                if not moved > 0:
                    fail(f"learned-guided {backend} {sampler}: the guidance changed nothing")
            elif not (drop > 0.01 and better >= 0.8 * n):
                fail(f"learned-guided {backend} {sampler}: the guided bodies do not collide "
                     "less than the unguided ones")
    counts["timed"] = timed
    return counts


LEARNED_EVAL_RUNS = {
    "test_egohmr --collision_backend occupancy":
        ("test_egohmr", ["--collision_backend", "occupancy", "--occupancy_ckpt"]),
    "test_egohmr_volsmpl": ("test_egohmr_volsmpl", []),
}


def phase_learned_eval() -> dict:
    """(d) the evaluation CLIs with the learned backends at full width, 8
    images x 5 samples x 2 batches, bf16 with K1, at the CLI's defaults
    (guided DDPM-50): K1 and K2 once per batch (K2 for the contact score
    only), every error key within 5 mm of the same CLI's f32 plain run, and
    the collision ratio within 0.05 of the mesh-SDF backend's on the same
    seed."""
    from egohmr_tpu_torch.collision import knn as k2
    from egohmr_tpu_torch.eval import test_egohmr, test_egohmr_volsmpl
    from egohmr_tpu_torch.nn import pointnet_fused as k1

    mods = {"test_egohmr": test_egohmr, "test_egohmr_volsmpl": test_egohmr_volsmpl}
    n_batches = 2
    # phase 6's data: half the bodies at the image's edge, so that the
    # *_invis keys average over many joints
    test_egohmr.synthetic_batch = edge_batch
    sdf = test_egohmr.main(EVAL_ARGS)  # the mesh-SDF backend, same seed and data
    counts = {"k1": 0, "k2": 0}
    for name, (mod, extra) in LEARNED_EVAL_RUNS.items():
        if extra:
            extra = extra + [artifact("occupancy_synthetic.npz")]
        k1.launches = k2.launches = 0  # main path starts: count launches from here
        fused_starts()
        t = time.perf_counter()
        summary = mods[mod].main(EVAL_ARGS + extra)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        d1, d2 = k1.launches, k2.launches  # main path ends
        fused_ends("learned")
        counts["k1"] += d1
        counts["k2"] += d2
        f32 = mods[mod].main(EVAL_ARGS + extra + F32_PLAIN)
        log("learned", f"(d) {name}: {secs:.2f} s for the whole CLI run (model set-up "
                       f"included), K1 launches {d1}, K2 launches {d2}; coll_ratio bf16 "
                       f"{summary['coll_ratio']:.4f}, f32 {f32['coll_ratio']:.4f}, sdf backend "
                       f"{sdf['coll_ratio']:.4f}")
        if d1 != n_batches or d2 != n_batches:
            fail(f"{name}: K1 launched {d1} times, K2 {d2} (want {n_batches} each: once per "
                 "batch, K2 for the contact score)")
        if not np.isfinite(summary["coll_ratio"]) or not 0 <= summary["coll_ratio"] <= 1:
            fail(f"{name}: coll_ratio {summary['coll_ratio']}")
        if not abs(summary["coll_ratio"] - sdf["coll_ratio"]) < 0.05:
            fail(f"{name}: coll_ratio {summary['coll_ratio']:.4f} is not within 0.05 of the "
                 f"sdf backend's {sdf['coll_ratio']:.4f}")
        if set(summary) != set(f32):
            fail(f"{name}: summary keys differ between the bf16 and the f32 run")
        gaps = {}
        for key in summary:
            v, w = summary[key], f32[key]
            if np.isnan(v) != np.isnan(w) or np.isinf(v):
                fail(f"{name}: {key} is {v} (f32 plain on the card {w})")
            if ("mpjpe" in key or "v2v" in key) and np.isfinite(w):
                gaps[key] = abs(v - w)
        worst = max(gaps, key=gaps.get)
        log("learned", f"(d) {name}: largest error-key gap to the f32 plain run "
                       f"{gaps[worst]:.3f} mm ({worst}; bar 5)")
        if not gaps[worst] <= 5.0:
            fail(f"{name}: {worst} strays {gaps[worst]:.2f} mm from the f32 run")
    return counts


def phase_learned_distill() -> dict:
    """(e) both distillation CLIs on the card, `--synthetic_watertight
    --label_mode winding`, for DISTILL_STEPS steps (distill_sdf at its
    defaults, distill_occupancy at SIGNED_RECIPE's widths):
    the loss falls, trained agreement beats an untrained net's and the
    all-outside answer's by 0.02 (the sdf net's over 0.75), the artifact
    reloads through the port's loader, ms per step;
    then K2 at the label shapes against its plain version, timed beside
    `baddbmm` + `argmin`."""
    import tempfile

    from egohmr_tpu_torch.collision import knn as k2
    from egohmr_tpu_torch.collision import neural_occupancy as occ
    from egohmr_tpu_torch.collision import neural_sdf as nsdf
    from egohmr_tpu_torch.smpl import make_synthetic_model, make_synthetic_watertight_model
    from egohmr_tpu_torch.train import distill_occupancy, distill_sdf

    dev = torch.device("cuda")
    counts, timed = {"k2": 0}, {}
    body = make_synthetic_watertight_model(device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        for name, cli, module, fn, cfg_cls, agree, key in (
                ("occupancy", distill_occupancy, occ, "distill_occupancy", occ.OccupancyConfig,
                 lambda net, g: occ.occupancy_agreement(net, body, g, label_mode="winding"),
                 "accuracy"),
                ("sdf", distill_sdf, nsdf, "distill_sdf", nsdf.SDFNetConfig,
                 lambda net, g: nsdf.sdf_agreement(net, body, g)["sign_agreement"],
                 "sign_agreement")):
            losses, spans = [], []
            inner = getattr(module, fn)

            def timed_distill(*a, _inner=inner, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                net = _inner(*a, **kw, losses=losses)
                torch.cuda.synchronize()
                spans.append(time.perf_counter() - t0)
                return net

            setattr(module, fn, timed_distill)
            try:
                k2.launches = 0  # main path starts: count launches from here
                meta = cli.main(["--synthetic_watertight", "--label_mode", "winding",
                                 "--steps", str(DISTILL_STEPS), "--log_every", "100",
                                 "--save_path", f"{tmp}/{name}.npz"]
                                + (SIGNED_RECIPE if name == "occupancy" else []))
                d2 = k2.launches  # main path ends
            finally:
                setattr(module, fn, inner)
            counts["k2"] += d2
            first, last = (float(torch.stack(losses[s]).mean()) for s in (slice(0, 5),
                                                                           slice(-5, None)))
            cfg = cfg_cls(**meta["occupancy_config" if name == "occupancy" else "sdf_config"])
            untrained = occ.PartFieldNet(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
            base = agree(untrained, torch.Generator(dev).manual_seed(1))
            # the held-out draw's share of outside points: what a net that
            # calls every point outside agrees on
            held = occ.sample_labeled_batch(torch.Generator(dev).manual_seed(1), body,
                                            batch_bodies=16, points_per_body=1024,
                                            label_mode="winding")
            outside = float((held.sdf >= 0).float().mean())
            path = f"{tmp}/{name}.npz" + ("" if meta["passed"] else ".failed.npz")
            reloaded = (nsdf.load_sdfnet if name == "sdf" else occ.load_occupancy)(path, dev)
            again = agree(reloaded, torch.Generator(dev).manual_seed(1))
            ms = spans[0] * 1e3 / DISTILL_STEPS
            log("learned", f"(e) distill_{name}: {DISTILL_STEPS} steps at batch 8 x 1024 points, "
                           f"hidden {cfg.hidden_dim} x {cfg.num_layers}, part code "
                           f"{cfg.part_embed_dim}, "
                           f"{ms:.2f} ms a step (label draw, forward, backward, Adam; host clock "
                           f"around the loop); loss first 5 {first:.5f}, last 5 {last:.5f} (bar "
                           f"0.8 x); held-out agreement {meta[key]:.4f} (untrained "
                           f"{base:.4f}, all-outside {outside:.4f}), after reload "
                           f"{again:.4f}; K2 launches {d2}")
            if not last < 0.8 * first:
                fail(f"distill_{name}: the loss does not fall")
            if not (meta[key] > max(base, outside + 0.02)
                    and (name != "sdf" or meta[key] > 0.75)):
                fail(f"distill_{name}: trained agreement {meta[key]:.4f} (untrained {base:.4f}, "
                     f"all-outside {outside:.4f})")
            if not abs(again - meta[key]) < 2e-3 or d2 < DISTILL_STEPS:
                fail(f"distill_{name}: reloaded agreement {again:.4f} or K2 launches {d2}")
            timed[name] = {"ms_per_step": ms, "loss_first5": first, "loss_last5": last,
                           "agreement": meta[key], "untrained": base}

    # K2 at the label shapes: the training batch and the held-out batch on
    # the watertight body, and the training batch on the 6890-vertex body
    def library(pts, verts):
        v_sq = torch.sum(verts * verts, dim=-1)[:, None, :]
        return torch.baddbmm(v_sq, pts, verts.transpose(1, 2), alpha=-2.0).argmin(-1)

    shapes = {}
    for B, smpl in ((8, body), (16, body), (8, make_synthetic_model(num_vertices=V_FULL,
                                                                     device=dev))):
        b = occ.sample_labeled_batch(torch.Generator(dev).manual_seed(B), smpl, batch_bodies=B,
                                     points_per_body=1024, label_mode="proximity")
        pts, verts = b.points.contiguous(), b.smpl_out.vertices.contiguous()
        got = k2.nearest_vertex_idx(pts, verts)
        differ, err, ok = k2_agrees(pts, verts, got, k2.nearest_vertex_idx_reference(pts, verts))
        V = verts.shape[1]
        if not ok:
            # compare the two picks' distances in f64 before blaming K2
            d64 = [torch.linalg.norm(pts.double() - torch.gather(
                verts.double(), 1, i[..., None].expand(-1, -1, 3)), dim=-1)
                for i in (got, k2.nearest_vertex_idx_reference(pts, verts))]
            gap64 = (d64[0] - d64[1]).abs().max().item()
            log("learned", f"K2 at [{B}, 1024] x {V}: off the f32 bar; in f64 the two picks' "
                           f"distances differ by up to {gap64:.3e} m")
            fail(f"K2 disagrees with its plain version at the label shape [{B}, 1024] x {V}")
        t = {"ms": time_ms(lambda: k2.nearest_vertex_idx(pts, verts), reps=20),
             "plain_ms": time_ms(lambda: k2.nearest_vertex_idx_reference(pts, verts), reps=10),
             "library_ms": time_ms(lambda: library(pts, verts), reps=10),
             **bound(6.0 * B * 1024 * V, PEAK_F32, B * 1024 * 12 + B * V * 12 + B * 1024 * 8)}
        log("learned", f"(e) K2 at the label shape [{B}, 1024] x {V}: {differ} of {B * 1024} "
                       f"indices differ from the plain version (max gap {err:.3e}); kernel "
                       f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, baddbmm+argmin "
                       f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms by {t['bound_by']}")
        shapes[f"{B}x1024x{V}"] = t
    counts.update(timed=timed, k2_label_shapes=shapes)
    return counts


def phase_learned(cfg) -> dict:
    """Phase 9: the learned collision backends, (a)-(e)."""
    phase_learned_artifacts()
    query = phase_learned_query()
    guided = phase_learned_guided(cfg)
    evaluated = phase_learned_eval()
    distilled = phase_learned_distill()
    log("learned", json.dumps({"query": query, "guided": guided["timed"],
                               "distill": distilled["timed"]}))
    return {"k1": guided["k1"] + evaluated["k1"],
            "k2": guided["k2"] + evaluated["k2"] + distilled["k2"],
            "query": query, "guided": guided["timed"], "distill": distilled["timed"],
            "k2_label_shapes": distilled["k2_label_shapes"]}


# ---------------------------------------------------------------- phase 10
DP_WORLD = 2   # ranks of the spawned runs, both on the one card
DP_B = 16      # the stage-2 step's global batch (8 a rank)
DP_S1_B = 32   # the stage-1 G+D step's (16 a rank)
# JAX's own N-vs-1 bars (`tests/test_train_infra.py`): the loss, and the
# parameters after one SGD step at lr 1e-2 from the same start
SGD_LR = 1e-2
DP_BARS = {"f32": dict(loss=1e-4, rtol=1e-4, atol=1e-6)}
N_GRAD = "52.9 M f32 parameters, 202 MiB"


def dp_compare(what, got, want, floor, bars) -> str:
    """Two runs' (loss, gradients, BatchNorm statistics, start) of one step
    from the same start: `got` the N-way run, `want` the 1-way one, `floor`
    the 1-way one again on the batch in reverse row order, the same sums in
    another order. The loss is held at bars["loss"]. The JAX package holds
    its N-vs-1 step elementwise, on the parameters after one SGD step (p -
    1e-2 g) at bars["rtol"] and bars["atol"]; at full width and the
    training init the f32 summation order alone moves far more elements
    than that (the reversed run shows how many), so each group (the
    ResNet's gradient, the other gradients, the running statistics) is
    held by its relative distance from the 1-way run: at most four times
    the reversed run's. Fails otherwise; returns a summary line."""
    (loss_a, grads_a, bn_a, p0), (loss_b, grads_b, bn_b, _), (_, grads_f, bn_f, _) = \
        got, want, floor
    rel = abs(loss_a - loss_b) / abs(loss_b)
    groups = {"the ResNet's gradient": [k for k in grads_b if k.startswith("backbone.")],
              "the other gradients": [k for k in grads_b if not k.startswith("backbone.")],
              "the running statistics": list(bn_b)}

    def beyond_jax_bar(grads, bn):
        n = 0
        for k, g in grads_b.items():
            gap = (SGD_LR * (grads[k] - g)).abs() - bars["rtol"] * (p0[k] - SGD_LR * g).abs()
            n += int((gap > bars["atol"]).sum())
        for k, v in bn_b.items():
            n += int(((bn[k] - v).abs() - bars["rtol"] * v.abs() > bars["atol"]).sum())
        return n

    def distance(this, ref, keys):
        d = torch.cat([(this[k] - ref[k]).double().reshape(-1) for k in keys])
        return float(d.norm() / torch.cat([ref[k].double().reshape(-1) for k in keys]).norm())

    parts, ok = [], rel <= bars["loss"]
    for name, keys in groups.items():
        a_all, f_all = {**grads_a, **bn_a}, {**grads_f, **bn_f}
        ref = {**grads_b, **bn_b}
        d_got, d_floor = distance(a_all, ref, keys), distance(f_all, ref, keys)
        ok &= d_got <= 4 * d_floor + 1e-7
        parts.append(f"{name} {d_got:.3e} (reversed {d_floor:.3e})")
    line = (f"{what}: loss {loss_a:.6f} vs {loss_b:.6f} (rel {rel:.2e}, bar {bars['loss']:.0e}); "
            f"relative distance from the 1-way run, bar 4x the reversed 1-way run's: "
            + ", ".join(parts) + f"; elements beyond JAX's SGD-step bar (rtol "
            f"{bars['rtol']:.0e}, atol {bars['atol']:.0e}): {beyond_jax_bar(grads_a, bn_a)}, "
            f"the reversed run {beyond_jax_bar(grads_f, bn_f)}")
    if not ok:
        fail(line)
    return line


def dp_compare_mixed(what, got, want, f32) -> str:
    """The bf16-mixed step: `got` the N-way run, `want` the 1-way one, `f32`
    the 1-way f32 step from the same start. At full width the bf16 rounding
    of the two runs' convolutions (other algorithms at batch 8 and 16)
    parts them far beyond any elementwise bar, as bf16 parts from f32
    (phase 7's gradient cosine, 0.07), so each is taken as a bf16 estimate
    of the f32 step and the N-way run is held to the f32 step as closely as
    the 1-way one is: its loss within twice the 1-way run's gap (plus 1e-3
    of the loss), its gradient's cosine to the f32 gradient, whole and
    outside the ResNet, at least the 1-way run's less phase 7's margins
    (0.03, 0.01), and its running statistics' relative distance from the
    f32 run's at most twice the 1-way run's. Fails otherwise."""
    (loss_a, grads_a, bn_a, _), (loss_b, grads_b, bn_b, _), (loss_f, grads_f, bn_f, _) = \
        got, want, f32
    gap_a, gap_b = abs(loss_a - loss_f), abs(loss_b - loss_f)
    ok = gap_a <= 2 * gap_b + 1e-3 * abs(loss_f)

    def cosine(grads, keys):
        a = torch.cat([grads[k].double().reshape(-1) for k in keys])
        b = torch.cat([grads_f[k].double().reshape(-1) for k in keys])
        return float(a @ b / (a.norm() * b.norm()))

    def distance(bn):
        d = torch.cat([(bn[k] - bn_f[k]).double().reshape(-1) for k in bn_f])
        return float(d.norm() / torch.cat([v.double().reshape(-1) for v in bn_f.values()]).norm())

    parts = []
    for name, keys, margin in (("whole", list(grads_f), 0.03),
                               ("outside the ResNet",
                                [k for k in grads_f if not k.startswith("backbone.")], 0.01)):
        c_a, c_b = cosine(grads_a, keys), cosine(grads_b, keys)
        ok &= c_a >= c_b - margin
        parts.append(f"{name} {c_a:.4f} (1-way {c_b:.4f}, margin {margin})")
    d_a, d_b = distance(bn_a), distance(bn_b)
    ok &= d_a <= 2 * d_b + 1e-7
    line = (f"{what}: loss {loss_a:.6f}, 1-way {loss_b:.6f}, f32 {loss_f:.6f}; the gradient's "
            f"cosine to the f32 step's: " + ", ".join(parts) + f"; the running statistics "
            f"{d_a:.3e} from the f32 run's (1-way {d_b:.3e}, bar 2x)")
    if not ok:
        fail(line)
    return line


def flip_rows(tree):
    """A batch tree in reverse row order."""
    if isinstance(tree, dict):
        return {k: flip_rows(v) for k, v in tree.items()}
    return tree.flip(0)


def s2_snapshot(model, terms, p0) -> tuple:
    from egohmr_tpu_torch.train import trainable_tensors

    grads = {k: t.grad.detach().clone() for k, t in trainable_tensors(model).items()}
    bn = {k: v.detach().clone() for k, v in model.state_dict().items()
          if k.endswith(("running_mean", "running_var"))}
    return float(terms["loss"]), grads, bn, p0


def s2_fresh(cfg, init, dev, dp=None, **kw):
    """A stage-2 model from `init`, its AdamW and step on `dev`, and its
    trained tensors' starting values."""
    from egohmr_tpu_torch.diffusion import make_schedule
    from egohmr_tpu_torch.models import BodyRepStats, EgoHMR, LossWeights
    from egohmr_tpu_torch.smpl import make_synthetic_model
    from egohmr_tpu_torch.train import (TrainConfig, make_optimizer, make_train_step,
                                        trainable_tensors)

    smpl = make_synthetic_model(num_vertices=V_FULL, device=dev)
    stats = BodyRepStats(torch.zeros(144, device=dev), torch.ones(144, device=dev))
    model = EgoHMR(cfg)
    model.load_state_dict(init)
    model = model.to(dev, memory_format=torch.channels_last)
    tcfg = TrainConfig(**kw)
    opt = make_optimizer(model, tcfg)
    step = make_train_step(cfg, tcfg, LossWeights(), make_schedule(50, "cosine", "").to(dev),
                           stats, smpl, smpl, smpl, opt, dp=dp)
    p0 = {k: t.detach().clone() for k, t in trainable_tensors(model).items()}
    return model, step, p0


def dp_inputs(cfg, dev):
    """The stage-2 step's global batch and draws."""
    from egohmr_tpu_torch.data import synthetic_batch

    batch = synthetic_batch(DP_B, num_scene_points=P_FULL, seed=30, device=dev)
    draws = dict(zip(("t", "noise", "drop"), (torch.from_numpy(a).to(dev) for a in
                                              train_draws(DP_B, cfg.cond_mask_prob))))
    return batch, draws


def step_ms(step, model, batch, reps=5, **kw) -> float:
    """Median CUDA-event ms of `reps` steps (after one)."""
    step(model, batch, **kw)
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        step(model, batch, **kw)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_parallel_nccl(cfg, init, tmp) -> dict:
    """(a) The stage-2 DP step with NCCL at world 1, in this process,
    against the plain step on the same draws: loss, gradients and
    BatchNorm statistics bit for bit (a world-1 all-reduce is the
    identity), f32 (TF32 off) and bf16-mixed; both steps' ms."""
    import torch.distributed as dist

    from egohmr_tpu_torch.parallel import init_data_parallel

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_store", rank=0, world_size=1)
    dp = init_data_parallel("cuda")
    if dp is None or dp.size != 1 or dist.get_backend() != "nccl":
        fail(f"NCCL at world 1: record {dp}")
    batch, draws = dp_inputs(cfg, dev)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the same algorithms in both runs
    out = {}
    try:
        for name, mp in (("f32", False), ("bf16-mixed", True)):
            runs = {}
            for tag, rec in (("plain", None), ("plain again", None), ("dp", dp)):
                model, step, p0 = s2_fresh(cfg, init, dev, dp=rec, mixed_precision=mp)
                runs[tag] = s2_snapshot(model, step(model, batch, **draws), p0)
                if tag != "plain again":
                    out[f"{name} {tag} ms"] = step_ms(step, model, batch, **draws)
                del model, step
            for tag in ("plain again", "dp"):
                a, b = runs[tag], runs["plain"]
                same = (a[0] == b[0] and all(torch.equal(a[1][k], g) for k, g in b[1].items())
                        and all(torch.equal(a[2][k], v) for k, v in b[2].items()))
                log("parallel", f"(a) {name}, batch {DP_B}: {tag} step against the plain one, "
                                f"loss {a[0]:.9f} vs {b[0]:.9f}, gradients and running "
                                f"statistics {'equal bit for bit' if same else 'DIFFER'}")
                if not same:
                    fail(f"(a) NCCL world 1, {name}: the {tag} step is not the plain step "
                         "bit for bit")
            log("parallel", f"(a) {name} step, median CUDA-event ms of 5: plain "
                            f"{out[f'{name} plain ms']:.2f}, through the DP code at world 1 "
                            f"{out[f'{name} dp ms']:.2f} (62 BatchNorm all-reduces forward, 62 "
                            f"backward, one gradient all-reduce)")
        flat = torch.randn(52_900_000, device=dev)
        out["nccl world-1 all-reduce ms"] = time_ms(lambda: dist.all_reduce(flat), reps=5)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()
    return out


def dp_rank_main(rank, tmp, cfg, cfg1):
    """One of the two ranks of (b) and (c), both on the one card, over
    gloo: its results go to `<tmp>/rank<r>.json`."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DP_WORLD), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(DP_WORLD))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from egohmr_tpu_torch.parallel import init_data_parallel

    dp = init_data_parallel("cuda", init_method=f"file://{tmp}/gloo_store")
    if dist.get_backend() != "gloo" or dp.device != torch.device("cuda", 0):
        fail(f"two ranks on one card: backend {dist.get_backend()}, device {dp.device}")
    res = {"rank": rank}
    try:
        res.update(dp_rank_steps(dp, tmp, cfg, cfg1))
        res.update(dp_rank_eval(dp, tmp))
    finally:
        with open(f"{tmp}/rank{rank}.json", "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()


def dp_flat_state(model) -> torch.Tensor:
    return torch.cat([v.detach().float().reshape(-1) for v in model.state_dict().values()
                      if v.is_floating_point()])


def dp_rank_steps(dp, tmp, cfg, cfg1) -> dict:
    """(b): the stage-2 step at batch 16 against the 1-way step (rank 0),
    f32 and bf16-mixed, then three steps with the generator's draws and
    every rank's state against rank 0's; one step with the collision loss
    (K2 once a rank, held to its plain version); the stage-1 G+D step at
    batch 32 against the 1-way one; the point-sharded encoder on 20,000
    points; the gradient all-reduce's ms."""
    import torch.distributed as dist

    from egohmr_tpu_torch.collision import knn as k2
    from egohmr_tpu_torch.collision import sdf
    from egohmr_tpu_torch.data import synthetic_batch, to_torch
    from egohmr_tpu_torch.models import (Discriminator, ProHMR, ProHMRLossWeights,
                                         init_discriminator_)
    from egohmr_tpu_torch.models import prohmr
    from egohmr_tpu_torch.nn import pointnet_forward, pointnet_forward_point_sharded
    from egohmr_tpu_torch.parallel import gather_rows, rows, shard_batch
    from egohmr_tpu_torch.smpl import make_synthetic_model
    from egohmr_tpu_torch.train.prohmr_loop import make_optimizers, make_prohmr_train_step

    dev, rank = dp.device, dp.rank
    res, lines = {}, []
    init = torch.load(f"{tmp}/init.pt", weights_only=True)
    batch, draws = dp_inputs(cfg, dev)
    mine = rows(dp, DP_B)
    local, local_draws = shard_batch(dp, batch), {k: v[mine] for k, v in draws.items()}
    for name, mp in (("f32", False), ("bf16-mixed", True)):
        model, step, p0 = s2_fresh(cfg, init, dev, dp=dp, mixed_precision=mp)
        got = s2_snapshot(model, step(model, local, **local_draws), p0)
        if rank == 0:
            ref, ref_step, _ = s2_fresh(cfg, init, dev, mixed_precision=mp)
            want = s2_snapshot(ref, ref_step(ref, batch, **draws), p0)
            res[f"{name} 1-way ms"] = step_ms(ref_step, ref, batch, **draws)
            what = f"(b) {name} step, 2 ranks x {DP_B // DP_WORLD} against 1 x {DP_B}"
            if mp:
                lines.append(dp_compare_mixed(what, got, want, f32_want))
                del f32_want
            else:
                ref, ref_step, _ = s2_fresh(cfg, init, dev, mixed_precision=mp)
                floor = s2_snapshot(ref, ref_step(ref, flip_rows(batch), **flip_rows(draws)), p0)
                lines.append(dp_compare(what, got, want, floor, DP_BARS[name]))
                f32_want = want
                del floor
            del ref, ref_step, want
        dist.barrier()
        # three steps more with the generator's draws, each made for the
        # whole batch on both ranks; their time; then the replicas
        gen = torch.Generator(device=dev).manual_seed(4)
        res[f"{name} 2-rank ms"] = step_ms(step, model, local, reps=2, generator=gen)
        flat = dp_flat_state(model)
        both = gather_rows(dp, flat[None])
        res[f"{name} replicas equal"] = bool(torch.equal(both[0], both[1]))
        res[f"{name} replicas max gap"] = float((both[0] - both[1]).abs().max())
        del model, step, got, both, flat
        torch.cuda.empty_cache()
    # one step with the collision loss: K2 once on each rank, at [8, 4096] x 6890
    model, step, _ = s2_fresh(cfg, init, dev, dp=dp, use_collision_loss=True)
    seen, nearest = [], sdf.nearest_vertex_idx

    def spy(points, verts, **kw):
        idx = nearest(points, verts, **kw)
        seen.append((points.clone(), verts.clone(), idx.clone()))
        return idx

    sdf.nearest_vertex_idx = spy
    k2.launches = 0  # main path starts: count launches from here
    try:
        terms = step(model, local, torch.Generator(device=dev).manual_seed(6))
    finally:
        sdf.nearest_vertex_idx = nearest
    res["k2_collision"] = k2.launches  # main path ends
    pts, verts, got_idx = seen[0]
    differ, err, ok = k2_agrees(pts, verts, got_idx, k2.nearest_vertex_idx_reference(pts, verts))
    res["k2_collision_shape"] = [int(pts.shape[0]), int(pts.shape[1]), int(verts.shape[1])]
    lines.append(f"(b) collision step on rank {rank}: K2 launches {res['k2_collision']}, "
                 f"shape {res['k2_collision_shape']}, {differ} indices differ from the plain "
                 f"version, max |d_kernel - d_plain| {err:.3e}; loss_coap_penetration "
                 f"{float(terms['loss_coap_penetration']):.6e}")
    if (res["k2_collision"] != 1 or not ok or len(seen) != 1
            or res["k2_collision_shape"] != [DP_B // DP_WORLD, 4096, V_FULL]):
        fail(lines[-1])
    # the gradient all-reduce alone, gloo on CUDA tensors
    flat = torch.randn(52_900_000, device=dev)
    t = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(flat)
        torch.cuda.synchronize()
        t.append((time.perf_counter() - t0) * 1e3)
    res["gloo all-reduce ms"] = float(np.median(t))
    # the point-sharded encoder: 10,000 + 10,000 of 20,000 points
    pts = synthetic_batch(8, num_scene_points=P_FULL, seed=40, device=dev)["scene_pcd_verts_full"]
    enc = init_random_s2(cfg).scene_enc.to(dev).eval()  # fc_1 is 0 in the training init
    with torch.no_grad():
        sharded = pointnet_forward_point_sharded(enc, pts[:, rows(dp, P_FULL)].contiguous(), dp)
        whole = pointnet_forward(enc, pts)
    enc_ok = torch.allclose(sharded, whole, rtol=1e-5, atol=1e-6)
    lines.append(f"(b) point-sharded encoder on rank {rank}, 8 clouds of {P_FULL} points, "
                 f"{P_FULL // DP_WORLD} a rank: max |sharded - whole| "
                 f"{float((sharded - whole).abs().max()):.3e} (rtol 1e-5, atol 1e-6)")
    if not enc_ok:
        fail(lines[-1])
    del model, step, seen, flat
    torch.cuda.empty_cache()
    # the stage-1 G+D step at batch 32, f32, against the 1-way step
    smpl = make_synthetic_model(num_vertices=V_FULL, device=dev)
    tb = synthetic_batch(DP_S1_B, num_scene_points=P_FULL, seed=50, device=dev)
    rng = np.random.RandomState(0)
    mocap = to_torch({"body_pose": rng.randn(DP_S1_B, 69).astype(np.float32) * 0.3,
                      "betas": rng.randn(DP_S1_B, 10).astype(np.float32) * 0.5}, dev)

    def s1_fresh(rec):
        model = prohmr.init_random_(ProHMR(cfg1), seed=0, training=True)
        model = model.to(dev, memory_format=torch.channels_last)
        disc = init_discriminator_(Discriminator(), seed=10).to(dev)
        prohmr.initialize(model, cfg1, tb)  # the ActNorms from the whole batch
        opt, dopt = make_optimizers(model, disc)
        step = make_prohmr_train_step(cfg1, ProHMRLossWeights(), smpl, smpl, smpl, opt, dopt,
                                      dp=rec)
        p0 = {k: t.detach().clone() for k, t in model.named_parameters()}
        return model, disc, step, p0

    def s1_snapshot(model, terms, p0):
        grads = {k: t.grad.detach().clone() for k, t in model.named_parameters()}
        bn = {k: v.detach().clone() for k, v in model.state_dict().items()
              if k.endswith(("running_mean", "running_var"))}
        return float(terms["loss"]), grads, bn, p0

    model, disc, step, p0 = s1_fresh(dp)
    got = s1_snapshot(model, step(model, disc, shard_batch(dp, tb), shard_batch(dp, mocap),
                                  torch.Generator(device=dev).manual_seed(7)), p0)
    del model, disc, step
    if rank == 0:
        model, disc, step, _ = s1_fresh(None)
        want = s1_snapshot(model, step(model, disc, tb, mocap,
                                       torch.Generator(device=dev).manual_seed(7)), p0)
        # the floor: the draws the 1-way step made, handed in in reverse order
        g = torch.Generator(device=dev).manual_seed(7)
        z = torch.zeros(DP_S1_B, cfg1.num_train_samples, cfg1.flow_dim, device=dev)
        z[:, 1:] = torch.randn((DP_S1_B, cfg1.num_train_samples - 1, cfg1.flow_dim),
                               generator=g, device=dev)
        nll = torch.randn((DP_S1_B, cfg1.flow_dim), generator=g, device=dev)
        model, disc, step, _ = s1_fresh(None)
        floor = s1_snapshot(model, step(model, disc, flip_rows(tb), flip_rows(mocap),
                                        z=z.flip(0), nll_noise=nll.flip(0)), p0)
        lines.append(dp_compare(f"(b) stage-1 G+D step, f32, 2 ranks x {DP_S1_B // DP_WORLD} "
                                f"against 1 x {DP_S1_B}", got, want, floor, DP_BARS["f32"]))
        del model, disc, step, want, floor
    del got
    torch.cuda.empty_cache()
    dist.barrier()
    res["lines"] = lines
    return res


@contextlib.contextmanager
def kernel_calls():
    """Every K1 and K2 call made inside, with its inputs and its output
    ({"k1": [(encoder, points, feature)], "k2": [(points, verts, idx)]}), to
    hold each against its plain version after the run."""
    from egohmr_tpu_torch.collision import sdf
    from egohmr_tpu_torch.nn import pointnet_fused as k1

    seen = {"k1": [], "k2": []}
    feature, nearest = k1.pointnet_fused_feature, sdf.nearest_vertex_idx

    def k1_spy(enc, points):
        out = feature(enc, points)
        seen["k1"].append((enc, points.detach().clone(), out.clone()))
        return out

    def k2_spy(points, verts, **kw):
        idx = nearest(points, verts, **kw)
        seen["k2"].append((points.detach().clone(), verts.detach().clone(), idx.clone()))
        return idx

    k1.pointnet_fused_feature, sdf.nearest_vertex_idx = k1_spy, k2_spy
    try:
        yield seen
    finally:
        k1.pointnet_fused_feature, sdf.nearest_vertex_idx = feature, nearest


def hold_kernel_calls(seen, what: str) -> str:
    """Each recorded call's output against the plain version on the same
    inputs, K1 at phase 3's bar and K2 by `k2_agrees`, or, where an index
    misses that distance bar, by `k2_score_gap` (a near-tie within the
    f32 score's rounding); fails on the first that disagrees. One line: the
    shapes, the calls and the worst gaps."""
    from egohmr_tpu_torch.collision import knn as k2
    from egohmr_tpu_torch.nn import pointnet_fused as k1

    k1_err, k1_cos, k2_differ, k2_err = 0.0, 1.0, 0, 0.0
    k1_shapes, k2_shapes = set(), set()
    for enc, pts, got in seen["k1"]:
        err, bar, cos, ok = k1_agrees(got, k1.pointnet_fused_reference(enc, pts))
        if not ok:
            fail(f"{what}: K1 disagrees with its plain version on [{pts.shape[0]}, "
                 f"{pts.shape[1]}]: max_abs_err {err:.3e} (bar {bar:.3e}), min cosine {cos:.7f}")
        k1_err, k1_cos = max(k1_err, err), min(k1_cos, cos)
        k1_shapes.add(tuple(pts.shape[:2]))
    ties, tie_ratio, tie_d64 = 0, -float("inf"), -float("inf")
    for pts, verts, got in seen["k2"]:
        ref = k2.nearest_vertex_idx_reference(pts, verts)
        differ, err, ok = k2_agrees(pts, verts, got, ref)
        if not ok:  # within the f32 rounding of the score both argmin?
            in_range = (got.dtype == torch.int64 and 0 <= int(got.min())
                        and int(got.max()) < verts.shape[1])
            ratio, d64 = k2_score_gap(pts, verts, got, ref)
            ties, tie_ratio, tie_d64 = ties + 1, max(tie_ratio, ratio), max(tie_d64, d64)
            if not (in_range and ratio <= 1.0):
                fail(f"{what}: K2 disagrees with its plain version on [{pts.shape[0]}, "
                     f"{pts.shape[1]}] x {verts.shape[1]}: {differ} indices differ, max "
                     f"|d_kernel - d_plain| {err:.3e}, score gap {ratio:.3f} x its f32 "
                     "rounding bound")
        k2_differ, k2_err = k2_differ + differ, max(k2_err, err)
        k2_shapes.add((pts.shape[0], pts.shape[1], verts.shape[1]))
    return (f"{what}: every kernel call against its plain version on its inputs: K1 "
            f"{len(seen['k1'])} calls at {sorted(k1_shapes)}, max_abs_err {k1_err:.3e}, "
            f"min cosine {k1_cos:.7f}; K2 {len(seen['k2'])} calls at {sorted(k2_shapes)}, "
            f"{k2_differ} indices differ, max |d_kernel - d_plain| {k2_err:.3e}; {ties} "
            f"calls beyond k2_agrees' distance bar" + (
                f", their f64 score gaps at most {tie_ratio:.3e} x the f32 rounding bound "
                f"(<= 0: the kernel's pick scores no worse), f64 distances at most "
                f"{tie_d64:.3e} beyond the plain pick's" if ties else ""))


def dp_rank_eval(dp, tmp) -> dict:
    """(c) on this rank: the evaluation CLI on the process group of (b),
    which its `init_data_parallel` takes as it is, f32 plain and at its
    defaults (bf16, K1, guided DDPM-50), with K1's and K2's launches, each
    call held against its plain version on the rank's own inputs."""
    from egohmr_tpu_torch.collision import knn as k2
    from egohmr_tpu_torch.eval import test_egohmr as cli
    from egohmr_tpu_torch.nn import pointnet_fused as k1

    cli.synthetic_batch = edge_batch
    res = {"eval lines": []}
    for name, extra in DP_EVAL_RUNS.items():
        with kernel_calls() as seen:
            k1.launches = k2.launches = 0  # main path starts: count launches from here
            fused_starts()
            t = time.perf_counter()
            res[f"eval {name}"] = cli.main(EVAL_ARGS + extra)
            torch.cuda.synchronize()
            res[f"eval {name} s"] = time.perf_counter() - t
            res[f"eval {name} k1"], res[f"eval {name} k2"] = k1.launches, k2.launches  # ends
            res[f"eval {name} gconv"], res[f"eval {name} resnet"] = fused_ends("parallel")
        if (len(seen["k1"]), len(seen["k2"])) != (k1.launches, k2.launches):
            fail(f"(c) eval {name} on rank {dp.rank}: {len(seen['k1'])} K1 and "
                 f"{len(seen['k2'])} K2 calls recorded for {k1.launches} and {k2.launches} "
                 "launches")
        res["eval lines"].append(hold_kernel_calls(seen, f"(c) eval {name}, rank {dp.rank}"))
        del seen
    return res


# the evaluation CLI's runs at two ranks and at one: f32 plain, and its
# defaults (bf16, K1, guided DDPM-50), each over EVAL_ARGS' 8 images x 5
# samples x 2 batches
DP_EVAL_RUNS = {"f32 plain": F32_PLAIN, "defaults": []}
DP_EVAL_GUIDED_STEPS = 11


def dp_guided_gradient(cfg) -> str:
    """Item of (c): the guided gradient of one rank's shard, its batch mean
    taken over the whole batch, against the same rows of the whole batch's
    gradient (rtol 1e-4); the shard's own mean would be twice as strong."""
    from egohmr_tpu_torch.eval.pipeline import tile_condition
    from egohmr_tpu_torch.models import BodyRepStats, compute_condition, make_guidance_fn
    from egohmr_tpu_torch.smpl import make_synthetic_model

    dev = torch.device("cuda")
    B, S = 8, 5
    model = init_random_s2(cfg).to(dev, memory_format=torch.channels_last).eval()
    smpl = make_synthetic_model(num_vertices=V_FULL, device=dev)
    stats = BodyRepStats(torch.zeros(144, device=dev), torch.ones(144, device=dev))
    batch = edge_batch(B, seed=100, device=dev)
    with torch.no_grad():
        cond = tile_condition(compute_condition(model, cfg, batch), S)
    x = torch.randn(B * S, 144, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    t = torch.zeros(B * S, dtype=torch.int64, device=dev)
    whole = make_guidance_fn(model, cfg, smpl, cond, stats)(x, t)
    half = slice(0, B * S // 2)
    shard_cond = type(cond)(*(v[half] for v in cond))
    shard = make_guidance_fn(model, cfg, smpl, shard_cond, stats, global_rows=B * S)(x[half], t[half])
    own = make_guidance_fn(model, cfg, smpl, shard_cond, stats)(x[half], t[half])
    ok = torch.allclose(shard, whole[half], rtol=1e-4, atol=1e-6 * float(whole.abs().max()))
    moving = int((whole[half].abs().amax(-1) > 0).sum())
    line = (f"(c) guided gradient of rank 0's {B * S // 2} of {B * S} bodies, mean over the "
            f"whole batch, against the same rows of the whole batch's: max |diff| "
            f"{float((shard - whole[half]).abs().max()):.3e} of max {float(whole.abs().max()):.3e} "
            f"(rtol 1e-4), {moving} bodies with a gradient; the shard's own mean: "
            f"{float(own.abs().max() / whole[half].abs().max().clamp_min(1e-30)):.3f} x")
    if not ok or moving == 0:
        fail(line)
    return line


def init_random_s2(cfg):
    from egohmr_tpu_torch.models import EgoHMR, init_random_

    return init_random_(EgoHMR(cfg), seed=0)


def dp_predictor(cfg) -> dict:
    """(d) `Predictor([cuda:0, cuda:0])` against the one-device `Predictor`
    at batch 64, unguided DDIM-5, on the same seed: f32 plain within rtol
    2e-4, atol 2e-4, bf16 + K1 within a mean abs of 0.05, K1 twice a
    request, each call held against its plain version on the replica's
    clouds; request ms."""
    import copy

    from egohmr_tpu_torch.data import synthetic_batch
    from egohmr_tpu_torch.diffusion import make_schedule
    from egohmr_tpu_torch.models import BodyRepStats
    from egohmr_tpu_torch.nn import pointnet_fused as k1
    from egohmr_tpu_torch.serving import Predictor
    from egohmr_tpu_torch.smpl import make_synthetic_model

    dev = torch.device("cuda", 0)
    model = init_random_s2(cfg).eval()
    smpl = make_synthetic_model(num_vertices=V_FULL)
    stats = BodyRepStats(torch.zeros(144), torch.ones(144))
    schedule = make_schedule(50, "cosine", "ddim5")
    batch = synthetic_batch(B_TIME, num_scene_points=P_FULL, seed=10)
    res, lines = {"k1": 0}, []
    for name, kw in (("f32 plain", dict(bf16=False, pointnet_impl="xla")),
                     ("bf16 + K1", dict(bf16=True, pointnet_impl="fused"))):
        outs = {}
        for tag, device in (("1 device", dev), ("2 replicas", [dev, dev])):
            pred = Predictor(copy.deepcopy(model), cfg, smpl, stats, schedule, device=device,
                             batch_size=B_TIME, **kw)
            pred.warmup(batch)  # captures each replica's request program
            # the kernel calls are watched in an eager request; the replayed
            # ones are held to them through replay's equality with eager
            with kernel_calls() as seen:
                eager = pred.eager(batch, seed=1)
            k1.launches = 0  # main path starts: count launches from here
            fused_starts()
            # one replayed request under the profiler: the replay accounting
            # against the device's kernels and the eager request's calls
            profiled_launches(lambda: pred(batch, seed=1), f"(d) {name}, {tag}",
                              want={"k1": len(seen["k1"]), "k2": 0})
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[tag] = pred(batch, seed=1)
                times.append((time.perf_counter() - t0) * 1e3)
            launched = k1.launches  # main path ends
            fused_ends("parallel")
            if 4 * len(seen["k1"]) != launched or seen["k2"]:
                fail(f"(d) {name}, {tag}: {len(seen['k1'])} K1 calls recorded in an eager "
                     f"request for {launched} launches in 4 replayed ones, "
                     f"{len(seen['k2'])} K2 calls (want 0)")
            if seen["k1"]:
                lines.append(hold_kernel_calls(seen, f"(d) {name}, {tag}"))
            replay_gap = max_gap(outs[tag], eager)
            if replay_gap != 0:
                fail(f"(d) {name}, {tag}: a replayed request differs from the eager one by "
                     f"{replay_gap:.3e}")
            del seen
            if tag == "2 replicas":
                res["k1"] += launched
            res[f"{name} {tag} ms"] = float(np.median(times))
            want_k1 = 0 if name == "f32 plain" else 4 * (2 if tag == "2 replicas" else 1)
            if launched != want_k1:
                fail(f"(d) {name}, {tag}: K1 launched {launched} times in 4 requests "
                     f"(want {want_k1})")
            del pred
        a, b = outs["2 replicas"], outs["1 device"]
        for k in b:
            if a[k].shape != b[k].shape or not np.isfinite(a[k]).all():
                fail(f"(d) {name}: {k} shape {a[k].shape} or non-finite")
        gap = max(float(np.abs(a[k] - b[k]).max()) for k in b)
        mean_gap = float(np.mean(np.abs(a["pred_keypoints_3d"] - b["pred_keypoints_3d"])))
        if name == "f32 plain":
            ok = all(np.allclose(a[k], b[k], rtol=2e-4, atol=2e-4) for k in b)
            bar = "rtol 2e-4, atol 2e-4"
        else:
            ok = mean_gap < 0.05
            bar = "mean abs of pred_keypoints_3d < 0.05"
        lines.append(f"(d) {name}, batch {B_TIME}, DDIM-5: 2 replicas on one card against 1 "
                     f"device, max |diff| {gap:.3e}, mean |diff| pred_keypoints_3d "
                     f"{mean_gap:.3e} ({bar}); request, host clock, median of 3: 1 device "
                     f"{res[f'{name} 1 device ms']:.1f} ms, 2 replicas "
                     f"{res[f'{name} 2 replicas ms']:.1f} ms")
        if not ok:
            fail(lines[-1])
    res["lines"] = lines
    return res


def phase_parallel(cfg) -> dict:
    """Phase 10: data parallelism at full width, (a)-(d)."""
    import tempfile

    import torch.multiprocessing as mp

    from egohmr_tpu_torch.collision import knn as k2
    from egohmr_tpu_torch.eval import test_egohmr as cli
    from egohmr_tpu_torch.models import EgoHMR, ProHMRConfig, init_random_
    from egohmr_tpu_torch.nn import pointnet_fused as k1

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dp_")
    init = init_random_(EgoHMR(cfg), seed=0, training=True).state_dict()
    torch.save(init, f"{tmp}/init.pt")
    # (a) NCCL at world 1
    nccl = phase_parallel_nccl(cfg, init, tmp)
    # the 1-way evaluation runs that (c) compares with, and (c)'s gradient
    saved_batch = cli.synthetic_batch
    cli.synthetic_batch = edge_batch
    one, counts = {}, {"k1": 0, "k2": 0}
    try:
        for name, extra in DP_EVAL_RUNS.items():
            with kernel_calls() as seen:
                k1.launches = k2.launches = 0  # main path starts: count launches from here
                fused_starts()
                t = time.perf_counter()
                one[name] = cli.main(EVAL_ARGS + extra)
                torch.cuda.synchronize()
                one[f"{name} s"] = time.perf_counter() - t
                counts["k1"] += k1.launches  # main path ends
                counts["k2"] += k2.launches
                fused_ends("parallel")
            log("parallel", hold_kernel_calls(seen, f"(c) eval {name}, 1-way"))
            del seen
    finally:
        cli.synthetic_batch = saved_batch
    log("parallel", dp_guided_gradient(cfg))
    # (d) the Predictor over two replicas
    pred = dp_predictor(cfg)
    for line in pred["lines"]:
        log("parallel", line)
    counts["k1"] += pred["k1"]
    torch.cuda.empty_cache()
    # (b) and (c): two ranks on the one card, over gloo
    t = time.perf_counter()
    mp.spawn(dp_rank_main, args=(tmp, cfg, ProHMRConfig()),
             nprocs=DP_WORLD, join=True)
    spawned_s = time.perf_counter() - t
    ranks = []
    for r in range(DP_WORLD):
        with open(f"{tmp}/rank{r}.json") as f:
            ranks.append(json.load(f))
    for line in [*ranks[0]["lines"], *ranks[1]["lines"], *ranks[0]["eval lines"],
                 *ranks[1]["eval lines"]]:
        log("parallel", line)
    for name in ("f32", "bf16-mixed"):
        eq = [r[f"{name} replicas equal"] for r in ranks]
        log("parallel", f"(b) {name}: after the compared step and 3 more, rank 1's parameters "
                        f"and running statistics against rank 0's: "
                        f"{'equal bit for bit' if all(eq) else 'DIFFER'} (max gap "
                        f"{ranks[0][f'{name} replicas max gap']:.3e})")
        if not all(eq):
            fail(f"(b) {name}: the replicas parted after 4 steps")
    # (c) the evaluation CLI at two ranks against one
    for name in DP_EVAL_RUNS:
        guided = DP_EVAL_GUIDED_STEPS
        want_k1 = 2 if name == "defaults" else 0
        for r in ranks:
            d1, d2 = r[f"eval {name} k1"], r[f"eval {name} k2"]
            counts["k1"] += d1
            counts["k2"] += d2
            GCONV["parallel"] = GCONV.get("parallel", 0) + r[f"eval {name} gconv"]
            RESNET["parallel"] = RESNET.get("parallel", 0) + r[f"eval {name} resnet"]
            if d1 != want_k1 or d2 != 2 * (2 + guided):
                fail(f"(c) eval {name} on rank {r['rank']}: K1 {d1} launches (want {want_k1}), "
                     f"K2 {d2} (want {2 * (2 + guided)}: 2 per batch and {guided} guided steps "
                     "per batch)")
        a, b = ranks[0][f"eval {name}"], one[name]
        if a != ranks[1][f"eval {name}"] or set(a) != set(b):
            fail(f"(c) eval {name}: the ranks' summaries differ, or their keys from the 1-way run's")
        worst, bad = 0.0, []
        for key in sorted(b):
            v, w = a[key], b[key]
            if np.isnan(v) != np.isnan(w) or np.isinf(v):
                bad.append(f"{key} {v} vs {w}")
                continue
            if np.isnan(v):
                continue
            if name == "f32 plain":
                rel = abs(v - w) / max(abs(w), 1e-12)
                worst = max(worst, rel)
                if rel > 1e-4 and abs(v - w) > 1e-9:
                    bad.append(f"{key} {v} vs {w}")
            elif ("mpjpe" in key or "v2v" in key) and abs(v - w) > 5.0:
                bad.append(f"{key} {v:.3f} vs {w:.3f} mm")
        log("parallel", f"(c) evaluation CLI, {name}, 8 images x 5 samples x 2 batches: 2 ranks "
                        f"in {ranks[0][f'eval {name} s']:.1f} s against 1 in "
                        f"{one[f'{name} s']:.1f} s (model set-up included); K1 "
                        f"{ranks[0][f'eval {name} k1']} and K2 {ranks[0][f'eval {name} k2']} "
                        f"launches a rank; " + (f"largest relative gap {worst:.2e} (bar 1e-4)"
                                                if name == "f32 plain" else
                                                "error keys within 5 mm, NaN in the same places"))
        if bad:
            fail(f"(c) eval {name}, 2 ranks against 1: " + "; ".join(bad))
    r0 = ranks[0]
    timed = {"nccl world 1": nccl, "2 ranks on one card": {
        k: r0[k] for k in ("f32 1-way ms", "f32 2-rank ms", "bf16-mixed 1-way ms",
                           "bf16-mixed 2-rank ms", "gloo all-reduce ms")},
        "predictor": {k: v for k, v in pred.items() if k.endswith("ms")}}
    log("parallel", f"stage-2 step, batch {DP_B}, CUDA-event ms: 1-way f32 {r0['f32 1-way ms']:.2f}, "
                    f"bf16-mixed {r0['bf16-mixed 1-way ms']:.2f}; 2 ranks on one card, 8 a rank, "
                    f"f32 {r0['f32 2-rank ms']:.2f}, bf16-mixed {r0['bf16-mixed 2-rank ms']:.2f}; "
                    f"gradient all-reduce ({N_GRAD}): NCCL at world 1 "
                    f"{nccl['nccl world-1 all-reduce ms']:.2f} ms (CUDA events), gloo over 2 "
                    f"ranks on CUDA tensors {r0['gloo all-reduce ms']:.1f} ms (host clock)")
    log("parallel", "two ranks share one card; no scaling figure")
    log("parallel", f"phase 10 in {time.perf_counter() - t_phase:.1f} s, of which the spawned "
                    f"ranks {spawned_s:.1f} s")
    log("parallel", json.dumps(timed))
    counts["k2"] += sum(r["k2_collision"] for r in ranks)
    counts["timed"] = timed
    counts["k2_collision_shape"] = ranks[0]["k2_collision_shape"]
    return counts

# phase 11: a dp x tp grid of devices on the one card, every shard on it
TP_DP, TP_TP = 2, 2
TP_REQUESTS = 3  # timed requests a run, after one warm-up
TP_F32_BARS = dict(rtol=2e-4, atol=2e-4)  # phase 10 (d)'s
# (c)'s guidance weight: the reference's times the batch times 1e4. At
# phase 5's 1e5 the guided step amplifies the f32 rounding of ANY split of
# the work beyond (a)'s bar, the flat two-replica Predictor's (no model
# split) as much as the grid's: this phase prints both. At 1e4 the grid
# holds the bar and the guidance still moves the vertices by millimetres.
TP_GUIDED = dict(ddim_scale=1.0 * 64 * 1e4)
TP_RUNS = {  # name: (Predictor options, grid's K2 launches a request)
    "(a) unguided, f32": (dict(bf16=False, pointnet_impl="xla"), 0),
    "(b) unguided, bf16": (dict(bf16=True, pointnet_impl="fused"), 0),
    "(c) guided, f32, weights x1e4": (dict(bf16=False, pointnet_impl="xla", with_guidance=True,
                                           guidance_kw=TP_GUIDED), 4 * TP_DP),
}


def phase_tp(cfg, dev=None) -> dict:
    """Phase 11: tensor parallelism at full width. `Predictor` over a 2 x 2
    grid, every shard on the one card, against the one-device `Predictor`
    on the same seed, batch 64, DDIM-5, on phase 5's closed body and a
    scene that its unguided legs penetrate: (a) unguided f32 (TF32 off)
    within rtol/atol 2e-4, (b) unguided bf16 (the grid's K1 switched to the
    split plain encoder, the one device at its K1 default) within a mean
    abs of 0.05 of pred_keypoints_3d, (c) guided f32 at `TP_GUIDED` within
    (a)'s bar, and apart from (a)'s bodies by more than it; then, printed
    only, the grid and the flat two-replica `Predictor` against one device
    at phase 5's raised weights, where the guided step amplifies any
    split's rounding.
    In the grid's requests K1 launches never and K2 once per guided step on
    each data row, each call held to its plain version on its inputs.
    Host-clock and CUDA-event ms per request, grid and one device; one card
    cannot show the split's gain."""
    import copy

    from egohmr_tpu_torch.collision import knn as k2
    from egohmr_tpu_torch.data import synthetic_batch
    from egohmr_tpu_torch.diffusion import GuidanceConfig, make_schedule
    from egohmr_tpu_torch.geometry import rotmat_to_rot6d
    from egohmr_tpu_torch.models import BodyRepStats
    from egohmr_tpu_torch.nn import pointnet_fused as k1
    from egohmr_tpu_torch.parallel import make_dp_tp_grid
    from egohmr_tpu_torch.serving import MESH_OUTPUT_KEYS, Predictor

    t_phase = time.perf_counter()
    dev = dev or torch.device("cuda", 0)
    grid = make_dp_tp_grid(TP_DP, TP_TP, [dev] * (TP_DP * TP_TP))
    model = init_random_s2(cfg).eval()
    smpl = closed_body_model()
    leg = np.isin(smpl.lbs_weights.numpy().argmax(1), LEG_JOINTS)
    rest = rotmat_to_rot6d(torch.eye(3).expand(24, 3, 3)).reshape(144)
    stats = BodyRepStats(rest, torch.full((144,), 0.2))
    schedule = make_schedule(50, "cosine", "ddim5")

    def predictor(device, guidance_kw=None, **kw):
        if guidance_kw is not None:
            kw["guidance"] = GuidanceConfig(**guidance_kw)
        return Predictor(copy.deepcopy(model), cfg, smpl, stats, schedule, device=device,
                         batch_size=B_TIME, num_samples=1, sampler="ddim",
                         output_keys=MESH_OUTPUT_KEYS, **kw)

    free = predictor(dev)
    batch = synthetic_batch(B_TIME, num_scene_points=P_FULL, seed=20)
    batch = penetrated(batch, free(batch, seed=1), leg)
    del free

    def serve(pred):
        """One warm-up, then TP_REQUESTS requests: (last output, median
        host-clock ms, median CUDA-event ms)."""
        pred(batch, seed=1)
        host, event = [], []
        for _ in range(TP_REQUESTS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t = time.perf_counter()
            start.record()
            out = pred(batch, seed=1)
            end.record()
            end.synchronize()
            host.append((time.perf_counter() - t) * 1e3)
            event.append(start.elapsed_time(end))
        return out, float(np.median(host)), float(np.median(event))

    res, outs, counts = {"k1": 0, "k2": 0}, {}, []
    for name, (kw, want_k2) in TP_RUNS.items():
        one, one_host, one_event = serve(predictor(dev, **kw))
        torch.cuda.empty_cache()
        pred = predictor(grid, **kw)
        placed = pred._replicas[0][-1]
        if pred.cfg.pointnet_impl != "xla" or placed is None:
            fail(f"{name}: the grid runs pointnet_impl {pred.cfg.pointnet_impl!r}, placement "
                 f"{placed}")
        w = "scene_enc.block_1.fc_0.weight"
        shapes = [tuple(sh[w].shape) for sh in placed.shards]
        if placed.module.get_parameter(w).numel() or len(set(shapes)) != 1:
            fail(f"{name}: {w} is not cut into {TP_TP} shards on the grid: {shapes}")
        with kernel_calls() as seen:
            k1.launches = k2.launches = 0  # main path starts: count launches from here
            fused_starts()
            grid_out, grid_host, grid_event = serve(pred)
            d1, d2 = k1.launches, k2.launches  # main path ends
            fused_ends("tp")
        n_req = TP_REQUESTS + 1
        if d1 or len(seen["k1"]) or d2 != want_k2 * n_req or len(seen["k2"]) != d2:
            fail(f"{name}: on the grid K1 launched {d1} times (want 0), K2 {d2} (want "
                 f"{want_k2 * n_req}: {want_k2 // TP_DP} guided steps on each of {TP_DP} data "
                 f"rows, {n_req} requests), {len(seen['k2'])} K2 calls recorded")
        res["k2"] += d2
        if d2:
            counts.append(hold_kernel_calls(seen, f"{name}, {TP_DP}x{TP_TP} grid"))
        del seen, pred
        torch.cuda.empty_cache()
        for k in one:
            if grid_out[k].shape != one[k].shape or not np.isfinite(grid_out[k]).all():
                fail(f"{name}: {k} shape {grid_out[k].shape} (want {one[k].shape}) or non-finite")
        gap = max(float(np.abs(grid_out[k] - one[k]).max()) for k in one)
        mean_gap = float(np.mean(np.abs(grid_out["pred_keypoints_3d"] - one["pred_keypoints_3d"])))
        if kw["bf16"]:
            ok, bar = mean_gap < 0.05, "mean abs of pred_keypoints_3d < 0.05"
        else:
            ok = all(np.allclose(grid_out[k], one[k], **TP_F32_BARS) for k in one)
            bar = "rtol 2e-4, atol 2e-4"
        log("tp", f"{name}, batch {B_TIME}, DDIM-5, {TP_DP}x{TP_TP} grid on one card "
                  f"({w} in shards of {shapes[0]}) against 1 device: max |diff| {gap:.3e}, "
                  f"mean |diff| pred_keypoints_3d {mean_gap:.3e} ({bar}); K1 {d1}, K2 {d2} "
                  f"launches in {n_req} grid requests; request ms, median of {TP_REQUESTS}, "
                  f"host clock / CUDA events: grid {grid_host:.1f} / {grid_event:.1f}, 1 device "
                  f"{one_host:.1f} / {one_event:.1f}")
        if not ok:
            fail(f"{name}: the grid's bodies stray from one device's")
        res[name] = {"grid host ms": grid_host, "grid event ms": grid_event,
                     "1 device host ms": one_host, "1 device event ms": one_event,
                     "max abs diff": gap, "mean abs diff kp3d": mean_gap, "k2": d2}
        outs[name] = grid_out
    a, c = outs["(a) unguided, f32"], outs["(c) guided, f32, weights x1e4"]
    moved = float(np.abs(c["pred_vertices"] - a["pred_vertices"]).max())
    apart = not all(np.allclose(c[k], a[k], **TP_F32_BARS) for k in a)
    log("tp", f"(c) against (a) on the grid: vertices moved by up to {moved:.3e} m "
              f"({'beyond' if apart else 'WITHIN'} rtol/atol 2e-4)")
    if not apart:
        fail("(c): the guidance did not move the grid's bodies beyond the bar")
    raised = dict(bf16=False, pointnet_impl="xla", with_guidance=True,
                  guidance_kw=RAISED["ddim"])
    one = predictor(dev, **raised)(batch, seed=1)
    gaps = {}
    for tag, device in (("grid", grid), ("flat 2 replicas", [dev] * TP_DP)):
        out = predictor(device, **raised)(batch, seed=1)
        gaps[tag] = max(float(np.abs(out[k] - one[k]).max()) for k in one)
        torch.cuda.empty_cache()
    log("tp", f"guided f32 at phase 5's raised weights {RAISED['ddim']}, against 1 device: "
              f"{TP_DP}x{TP_TP} grid max |diff| {gaps['grid']:.3e}, flat {TP_DP} replicas (no "
              f"model split) {gaps['flat 2 replicas']:.3e}: the guided step amplifies any "
              "split's rounding there (printed, not held to a bar)")
    for line in counts:
        log("tp", line)
    log("tp", "one card holds every shard: no latency claim")
    log("tp", f"phase 11 in {time.perf_counter() - t_phase:.1f} s")
    log("tp", json.dumps({k: v for k, v in res.items() if isinstance(v, dict)}))
    return res


# phase 12: (name, entry point, arguments, metric, the JSON key that must be
# non-null, the kernels that must launch)
BENCH_RUNS = (
    ("default", "bench", [], "ddim5_samples_per_sec_per_chip", "value", ("k1",)),
    ("guided-ddim", "bench", ["--guided-ddim"], "guided_ddim5_samples_per_sec_per_chip",
     "value", ("k1", "k2")),
    ("guided", "bench", ["--guided"], "guided_ddpm50_samples_per_sec_per_chip", "value",
     ("k1", "k2")),
    ("serving", "bench", ["--serving"], "serving_predictor_samples_per_sec_per_chip",
     "value", ("k1",)),
    ("train", "bench", ["--train"], "train_step_imgs_per_sec_per_chip", "value", ("k2",)),
    ("profile_serving", "tools.profile_serving",
     ["--sweep", "4", "--stream", "9", "--reps", "1"], "serving_profile", "device_ms",
     ("k1",)),
)
BENCH_ITERS = 1  # the shortest chains of the bench's method: 3 and 9 requests


def phase_bench() -> dict:
    """Phase 12: every measurement entry point of the port at full width,
    in process: each run's one JSON line parsed and checked (metric name, a
    non-null result), its K1 and K2 launches counted from 0 by the
    wrappers, and, through the entry points' request hook, one untimed
    request of every request program it times recorded and each of its K1
    and K2 calls held to the plain version; where the program is captured,
    its replay held to that eager request (bit for bit, or within twice
    the gap of two eager runs) and its launches, under the profiler, to
    the eager request's calls."""
    import importlib
    import io

    from egohmr_tpu_torch.collision import knn as k2
    from egohmr_tpu_torch.nn import pointnet_fused as k1

    totals, res = {"k1": 0, "k2": 0}, {}
    for name, module, argv, metric, key, needs in BENCH_RUNS:
        entry = importlib.import_module(f"egohmr_tpu_torch.{module}")
        held, recorded = [], {"k1": 0, "k2": 0}

        def hold(request_name, request):
            with kernel_calls() as seen:
                want = request()
                torch.cuda.synchronize()
            for k in recorded:
                recorded[k] += len(seen[k])
            held.append(hold_kernel_calls(seen, f"{name}, {request_name}"))
            if request.replay is None:  # a mode that runs eagerly
                return
            # the replayed request against the eager one: bit for bit where
            # two eager runs agree, else within twice their gap; its launches
            # by the replay accounting against the device's kernels and the
            # eager request's calls
            eager_gap = max_gap(request(), want)
            request.replay()  # the first replay captures, outside the profiler
            got, _ = profiled_launches(request.replay, f"bench {name}, {request_name}",
                                       want={k: len(v) for k, v in seen.items()})
            gap = max_gap(got, want)
            bar = 0.0 if eager_gap == 0 else 2 * eager_gap
            held.append(f"{name}, {request_name}: replayed against eager max |diff| {gap:.3e}, "
                        f"eager against eager {eager_gap:.3e} (bar {bar:.3e}); launches by the "
                        f"replay accounting and by the device's kernels K1 {len(seen['k1'])}, "
                        f"K2 {len(seen['k2'])}")
            if gap > bar:
                fail(held[-1])

        out = io.StringIO()
        t0 = time.perf_counter()
        k1.launches = k2.launches = 0  # this run's main path starts
        fused_starts()
        with contextlib.redirect_stdout(out):
            rc = entry.main(argv + ["--iters", str(BENCH_ITERS)], request_hook=hold)
        launches = {"k1": k1.launches, "k2": k2.launches}  # and ends
        fused_ends("bench")
        lines = [line for line in out.getvalue().splitlines() if line.startswith("{")]
        if rc != 0 or len(lines) != 1:
            fail(f"bench {name}: exit {rc}, {len(lines)} JSON lines: {out.getvalue()[-2000:]}")
        d = json.loads(lines[0])
        if d.get("metric") != metric or d.get(key) is None:
            fail(f"bench {name}: metric {d.get('metric')!r} (want {metric!r}), {key} "
                 f"{d.get(key)!r}")
        for k in needs:
            if launches[k] < 1 or recorded[k] < 1:
                fail(f"bench {name}: {k.upper()} launched {launches[k]} times, {recorded[k]} "
                     "calls recorded in its untimed requests (want both > 0)")
        for line in held:
            log("bench", line)
        extra = d.get("extra", d)
        per_request = (extra.get("launches_per_request") or extra.get("launches_per_step")
                       or d.get("launches_per_request"))
        log("bench", f"{name}: {metric} {key}={d[key]!r}, launches K1 {launches['k1']} "
                     f"K2 {launches['k2']} (per request {per_request}), "
                     f"{time.perf_counter() - t0:.1f} s")
        log("bench", lines[0])
        res[name] = {"value": d[key], "launches": launches, "per_request": per_request}
        for k in totals:
            totals[k] += launches[k]
    res.update(totals)
    return res


# phase 13: the JAX repo's last entry points, in process
TOOLS_IMAGES = 20       # the written EgoBody test split: two batches of the tools' 10
TOOLS_RECORDING = "recording_20210907_S02_S01_01"
TOOLS_HOLO_TIME = "2021-09-07-155421"
TOOLS_SCENE = "seminar_d78"
TOOLS_TRAIN_STEPS, TOOLS_TRAIN_EVAL = 200, 100
REUSE_GUIDED_STEPS = {"ddim5": 4, "ddpm50": 11}  # guided steps a request, refresh every r
REUSE_REFRESH = (2, 4)  # the tool's default --refresh


def write_egobody_root(root: str, n: int = TOOLS_IMAGES, points: int = P_FULL,
                       seed: int = 0) -> None:
    """An EgoBody release layout under `root`, as `tests/test_egobody_dataset.py`
    writes it (one recording, identity transforms), with `n` 480x270 JPEG
    frames, the test annotations at the CLIs' default path, the whole-scene
    cloud and per-frame scene cubes (from the GT and from stage 1's
    translations) of `points` points around the bodies 2.5 m ahead."""
    import pickle

    from PIL import Image

    rng = np.random.RandomState(seed)
    rel = f"egocentric_color/{TOOLS_RECORDING}/{TOOLS_HOLO_TIME}/PV"
    os.makedirs(os.path.join(root, rel))
    names, stamps = [], []
    for i in range(n):
        ts = str(132754997786014666 + i)
        name = f"{ts}_frame_{i:05d}.jpg"
        Image.fromarray((rng.rand(270, 480, 3) * 255).astype(np.uint8)).save(
            os.path.join(root, rel, name))
        names.append(f"{rel}/{name}")
        stamps.append(ts)
    ann = os.path.join(root, "annotation_egocentric_smpl_npz", "egocapture_test_smpl.npz")
    os.makedirs(os.path.dirname(ann))
    np.savez(
        ann, imgname=np.array(names),
        center=rng.rand(n, 2).astype(np.float32) * 200 + 140,
        scale=np.full(n, 1.0, np.float32),
        pose=rng.randn(n, 69).astype(np.float32) * 0.2,
        shape=rng.randn(n, 10).astype(np.float32) * 0.5,
        global_orient_pv=rng.randn(n, 3).astype(np.float32) * 0.3,
        transl_pv=np.array([[0.1, 0.2, 2.5]] * n, np.float32),
        cx=np.full(n, 240.0), cy=np.full(n, 135.0), fx=np.full(n, 750.0), fy=np.full(n, 750.0),
        valid_keypoints=np.concatenate([rng.rand(n, 25, 2) * 400, np.ones((n, 25, 1))],
                                       axis=-1).astype(np.float32),
        **{"3d_joints_pv": rng.randn(n, 25, 3).astype(np.float32) * 0.3 + [0.1, 0.2, 2.5]},
        gender=np.array(["m", "f"] * (n // 2)))
    with open(os.path.join(root, "transf_matrices_all_seqs.pkl"), "wb") as f:
        pickle.dump({TOOLS_RECORDING: {"trans_kinect2holo": np.eye(4, dtype=np.float32),
                                       "trans_world2pv": {ts: np.eye(4, dtype=np.float32)
                                                          for ts in stamps}}}, f)
    with open(os.path.join(root, "data_info_release.csv"), "w") as f:
        f.write(f"recording_name,scene_name\n{TOOLS_RECORDING},{TOOLS_SCENE}\n")
    calib = os.path.join(root, "calibrations", TOOLS_RECORDING, "cal_trans", "kinect12_to_world")
    os.makedirs(calib)
    with open(os.path.join(calib, f"{TOOLS_SCENE}.json"), "w") as f:
        json.dump({"trans": np.eye(4).tolist()}, f)
    for src in ("gt", "pred"):
        d = os.path.join(root, f"Egohmr_scene_preprocess_cube_s2_from_{src}_release", "test",
                         TOOLS_RECORDING, TOOLS_HOLO_TIME)
        os.makedirs(d)
        for i, ts in enumerate(stamps):
            cloud = rng.randn(points, 3).astype(np.float32) * [0.6, 0.8, 0.6] + [0.1, 0.2, 2.5]
            np.save(os.path.join(d, f"{ts}_frame_{i:05d}.npy"), cloud)
    s1 = os.path.join(root, "Egohmr_scene_preprocess_s1_release")
    os.makedirs(s1)
    with open(os.path.join(s1, "pcd_verts_dict_test.pkl"), "wb") as f:
        pickle.dump({names[0]: rng.randn(points, 3) * [1.5, 0.8, 1.5] + [0.1, 0.2, 2.5]}, f)
    with open(os.path.join(s1, "map_dict_test.pkl"), "wb") as f:
        pickle.dump({name: names[0] for name in names}, f)


def write_smpl_pkls(path: str) -> None:
    """SMPL_{NEUTRAL,MALE,FEMALE}.pkl in the official files' layout from the
    synthetic 6890-vertex bodies of seeds 0, 1 and 2."""
    import pickle

    from egohmr_tpu_torch.smpl import make_synthetic_model

    os.makedirs(path)
    for seed, gender in enumerate(("NEUTRAL", "MALE", "FEMALE")):
        m = make_synthetic_model(seed=seed, num_vertices=V_FULL)
        with open(os.path.join(path, f"SMPL_{gender}.pkl"), "wb") as f:
            pickle.dump({
                "v_template": m.v_template.double().numpy(),
                "shapedirs": m.shapedirs.double().numpy(),
                "posedirs": m.posedirs.double().numpy().T.reshape(V_FULL, 3, 207),
                "J_regressor": m.j_regressor.double().numpy(),
                "weights": m.lbs_weights.double().numpy(),
                "f": m.faces.numpy().astype(np.uint32),
                "kintree_table": np.zeros((2, 24), np.int64)}, f, protocol=2)


def run_tool(name: str, argv, counts: dict, held: list):
    """One entry point of `egohmr_tpu_torch.tools`, in process: K1 and K2
    counted from 0 by their wrappers over its run (its main path) and every
    call of either recorded and held to the plain version after it. Returns
    (its return value, what it printed, seconds)."""
    import importlib
    import io

    from egohmr_tpu_torch.collision import knn as k2
    from egohmr_tpu_torch.nn import pointnet_fused as k1

    entry = importlib.import_module(f"egohmr_tpu_torch.tools.{name}")
    out = io.StringIO()
    t0 = time.perf_counter()
    with kernel_calls() as seen:
        k1.launches = k2.launches = 0  # this tool's main path starts
        fused_starts()
        try:
            with contextlib.redirect_stdout(out):
                ret = entry.main(argv)
        except BaseException:
            print(out.getvalue()[-4000:], file=sys.stderr)
            raise
        torch.cuda.synchronize()
        launches = {"k1": k1.launches, "k2": k2.launches}  # and ends
        fused_ends("tools")
    secs = time.perf_counter() - t0
    for k in ("k1", "k2"):
        if len(seen[k]) != launches[k]:
            fail(f"{name}: {launches[k]} {k.upper()} launches, {len(seen[k])} calls recorded")
        counts[k] += launches[k]
    held.append(hold_kernel_calls(seen, name))
    log("tools", f"{name} {' '.join(argv)}: {secs:.1f} s, K1 {launches['k1']} and K2 "
                 f"{launches['k2']} launches")
    counts[name] = launches
    return ret, out.getvalue(), secs


def last_json(printed: str) -> dict:
    lines = [x for x in printed.splitlines() if x.startswith("{")]
    if not lines:
        fail(f"no JSON line in: {printed[-2000:]}")
    return json.loads(lines[-1])


def phase_tools() -> dict:
    """Phase 13: the JAX repo's last five entry points, ported to
    `egohmr_tpu_torch/tools/`, at full width on the card, in process, on an
    EgoBody-layout root written here (20 frames, 20,000-point clouds,
    synthetic SMPL pickles, zero/one stats, random `ProHMR` and `EgoHMR`
    checkpoints in the reference layout): `real_weights_eval` at its
    defaults against the same command with `--bf16 false`;
    `measure_guidance_reuse_deviation --batch 16 --points 20000` with K2's
    launches per request held to ceil(g / r); `compare_train_precision
    --steps 200 --eval_every 100`, both runs' losses falling; `probe_gcn` at
    its defaults; `visualize_results` on the stage-2 `results.pkl`. Every K1
    and K2 call of these runs is held to its plain version."""
    import math
    import pickle
    import tempfile

    from PIL import Image

    from egohmr_tpu_torch.data import save_stats
    from egohmr_tpu_torch.eval import test_egohmr as s2cli
    from egohmr_tpu_torch.models import EgoHMR, EgoHMRConfig, ProHMR, ProHMRConfig
    from egohmr_tpu_torch.models import init_random_
    from egohmr_tpu_torch.models.prohmr import init_random_ as init_prohmr_

    t_phase = time.perf_counter()
    counts, held, res = {"k1": 0, "k2": 0}, [], {}
    with tempfile.TemporaryDirectory() as tmp:
        root, smpl_dir = os.path.join(tmp, "egobody"), os.path.join(tmp, "smpl")
        write_egobody_root(root)
        write_smpl_pkls(smpl_dir)
        ck1, ck2 = os.path.join(tmp, "s1", "53618.pt"), os.path.join(tmp, "s2", "91453.pt")
        for path, model in ((ck1, init_prohmr_(ProHMR(ProHMRConfig()), seed=3)),
                            (ck2, init_random_(EgoHMR(EgoHMRConfig()), seed=1))):
            os.makedirs(os.path.dirname(path))
            torch.save({"state_dict": model.state_dict()}, path)
        stats = os.path.join(tmp, "stats", "preprocess_stats.npz")
        save_stats(stats, np.zeros(144, np.float32), np.ones(144, np.float32))
        log("tools", f"EgoBody root of {TOOLS_IMAGES} frames and {P_FULL}-point clouds, SMPL "
                     f"pickles, stats and both checkpoints written in "
                     f"{time.perf_counter() - t_phase:.1f} s")

        # ---- real_weights_eval at its defaults, and with --bf16 false; the
        # first run's stage-2 CLI also saves its results.pkl for the viewer
        argv = ["--stage1_checkpoint", ck1, "--stage2_checkpoint", ck2,
                "--smpl_model_path", smpl_dir, "--dataset_root", root,
                "--body_rep_stats", stats]
        s2_main = s2cli.main
        s2_saved = os.path.join(tmp, "s2_results")
        s2cli.main = lambda a: s2_main(a + ["--save_results", "true", "--save_root", s2_saved])
        try:
            report, _, secs = run_tool("real_weights_eval", argv + [
                "--save_root", os.path.join(tmp, "rwe")], counts, held)
        finally:
            s2cli.main = s2_main
        n_batches = TOOLS_IMAGES // 10
        want = {"k1": 2 * n_batches, "k2": n_batches * (2 + 11)}
        if counts["real_weights_eval"] != want:
            fail(f"real_weights_eval: launches {counts['real_weights_eval']}, want {want} (K1 "
                 "once a batch in each stage, K2 twice a batch and 11 times a guided batch)")
        f32, _, secs32 = run_tool("real_weights_eval", argv + [
            "--save_root", os.path.join(tmp, "rwe32"), "--bf16", "false"], counts, held)
        if counts["real_weights_eval"] != want:
            fail(f"real_weights_eval --bf16 false: launches {counts['real_weights_eval']}, "
                 f"want {want}")
        with open(os.path.join(tmp, "rwe", "report.json")) as f:
            if json.load(f) != report:
                fail("real_weights_eval: report.json is not the returned report")
        for part in ("stage1_metrics_mm", "stage2_metrics"):
            a, b = report[part], f32[part]
            if list(a) != list(b):
                fail(f"real_weights_eval: {part} keys differ between bf16 and f32")
            for key in a:
                diff = abs(a[key] - b[key])
                log("tools", f"real_weights_eval {part} {key}: bf16 {a[key]:.4f}, f32 "
                             f"{b[key]:.4f}, |diff| {diff:.4f}")
                if np.isnan(a[key]) != np.isnan(b[key]) or np.isinf(a[key]):
                    fail(f"real_weights_eval {part} {key}: {a[key]} (f32 run {b[key]})")
                if ("mpjpe" in key or "v2v" in key) and not diff <= 5.0:
                    fail(f"real_weights_eval {part} {key}: bf16 {diff:.2f} mm from f32 (bar 5)")
        res["real_weights_eval"] = {"s": secs, "s_f32": secs32,
                                    "stage2_g_mpjpe": report["stage2_metrics"]["g_mpjpe"]}

        # ---- the reuse deviation, K2 launches per request verified
        _, printed, secs = run_tool("measure_guidance_reuse_deviation",
                                    ["--batch", "16", "--points", str(P_FULL)], counts, held)
        d = last_json(printed)
        log("tools", f"measure_guidance_reuse_deviation: {json.dumps(d)}")
        want = {}
        for mode, g in REUSE_GUIDED_STEPS.items():
            want.update({f"{mode}_unguided": 0, f"{mode}_exact": g},
                        **{f"{mode}_reuse{r}": math.ceil(g / r) for r in REUSE_REFRESH})
        if d["extra"]["k2_launches"] != want:
            fail(f"measure_guidance_reuse_deviation: K2 launches {d['extra']['k2_launches']}, "
                 f"want {want}")
        for mode, entry in d["modes"].items():
            for key, figs in entry.items():
                if not all(np.isfinite(v) and v >= 0 for v in figs.values()):
                    fail(f"measure_guidance_reuse_deviation {mode} {key}: {figs}")
        res["measure_guidance_reuse_deviation"] = {"s": secs, "modes": d["modes"]}

        # ---- bf16 against f32 training, both losses falling
        overlay = os.path.join(tmp, "overlay.json")
        rc, printed, secs = run_tool("compare_train_precision", [
            "--steps", str(TOOLS_TRAIN_STEPS), "--eval_every", str(TOOLS_TRAIN_EVAL),
            "--out", overlay], counts, held)
        summary = last_json(printed)
        log("tools", f"compare_train_precision (exit {rc}): {json.dumps(summary)}")
        if counts["compare_train_precision"] != {"k1": 0, "k2": 2 * TOOLS_TRAIN_STEPS}:
            fail(f"compare_train_precision: launches {counts['compare_train_precision']}, "
                 f"want K1 0 and K2 {2 * TOOLS_TRAIN_STEPS} (one a step with the collision loss)")
        with open(overlay) as f:
            curves = json.load(f)["train_loss"]
        for tag, losses in curves.items():
            first, last = np.mean(losses[:5]), np.mean(losses[-5:])
            log("tools", f"compare_train_precision {tag}: first 5 steps {first:.4f}, last 5 "
                         f"{last:.4f} ({last / first:.3f} x)")
            if not (len(losses) == TOOLS_TRAIN_STEPS and np.isfinite(losses).all()
                    and last < 0.8 * first):
                fail(f"compare_train_precision {tag}: the loss does not fall below 0.8 x its "
                     f"start ({first:.4f} -> {last:.4f})")
        res["compare_train_precision"] = {"s": secs, "exit": rc, "summary": summary}

        # ---- the denoiser by variant
        _, printed, secs = run_tool("probe_gcn", [], counts, held)
        d = last_json(printed)
        log("tools", f"probe_gcn: {json.dumps(d)}")
        if set(d["results"]) != {"full", "fused", "skeleton", "wcat", "wcat_skel"} or \
                any(v is None for v in d["kernel_ms"].values()):
            fail(f"probe_gcn: {d}")
        res["probe_gcn"] = {"s": secs, **{k: d[k] for k in (
            "results", "event_ms", "kernel_ms", "launches_per_call", "roofline_ms")}}

        # ---- the stage-2 results rendered in the scene of frame 0
        pkl = os.path.join(s2_saved, "output_egohmr_s2", "results_seed_0.pkl")
        with open(pkl, "rb") as f:
            n_rows = len(pickle.load(f)["pred_betas_list"])
        scene = os.path.join(tmp, "scene.npy")
        cube = sorted(os.listdir(os.path.join(
            root, "Egohmr_scene_preprocess_cube_s2_from_pred_release", "test", TOOLS_RECORDING,
            TOOLS_HOLO_TIME)))[0]
        np.save(scene, np.load(os.path.join(
            root, "Egohmr_scene_preprocess_cube_s2_from_pred_release", "test", TOOLS_RECORDING,
            TOOLS_HOLO_TIME, cube)))
        written, _, secs = run_tool("visualize_results", [
            "--results", pkl, "--smpl_model_path", smpl_dir, "--scene", scene,
            "--out_dir", os.path.join(tmp, "vis")], counts, held)
        for path in written:
            img = np.asarray(Image.open(path)).astype(int)
            # the body's cyan, shaded: green and blue alike, both well above red
            # (the scene is grey, the axes red, green and blue)
            r, g, b = img[..., 0], img[..., 1], img[..., 2]
            body = (g > r + 40) & (b > r + 40) & (np.abs(g - b) < 30)
            log("tools", f"visualize_results: {os.path.basename(path)} {img.shape}, "
                         f"{int(body.sum())} body-coloured pixels")
            # the orbit views look at the body; the camera's may not see it
            if img.shape != (540, 960, 3) or ("camera" not in path and not body.any()):
                fail(f"visualize_results: {path} is {img.shape}, {int(body.sum())} body pixels")
        if n_rows != TOOLS_IMAGES or len(written) != 3:
            fail(f"visualize_results: {len(written)} renders of a {n_rows}-image results.pkl")
        res["visualize_results"] = {"s": secs}
    for line in held:
        log("tools", line)
    secs = time.perf_counter() - t_phase
    log("tools", f"phase 13 in {secs:.1f} s; K1 {counts['k1']} and K2 {counts['k2']} launches")
    res.update(k1=counts["k1"], k2=counts["k2"], s=secs,
               launches={k: v for k, v in counts.items() if k not in ("k1", "k2")})
    return res


# phase 14: the captured request programs
GRAPH_SEEDS = (1, 2, 3)
GRAPH_ROUNDS = 3
# requests in the short and the long stream of (d): an eager guided DDPM-50
# request takes some 0.7 s, a replayed one some 60 ms
GRAPH_STREAM = {"eager": (2, 4), "graphed": (4, 12)}


def graph_stream(pred, batch, n: int, eager: bool, seed0: int) -> float:
    """`map_batches`' window over `n` requests of `batch`, through the
    captured program or eagerly: host seconds to the last result."""
    from collections import deque

    t0 = time.perf_counter()
    window = deque()
    for i in range(n):
        window.append(pred._submit(batch, seed0 + i, eager))
        if len(window) >= pred.max_inflight:
            pred.result(window.popleft())
    while window:
        pred.result(window.popleft())
    return time.perf_counter() - t0


def graph_times(pred, batch) -> dict:
    """(d): per request, eager against graphed, GRAPH_ROUNDS rounds each in
    turns: the host's submit ms (queueing only, p50 of 3), blocking ms
    (p50 of 3) and steady-state ms by stream-length differencing (streams
    of GRAPH_STREAM requests, `max_inflight` 4)."""
    out = {"eager": [], "graphed": []}
    for r in range(GRAPH_ROUNDS):
        for mode in ("eager", "graphed"):
            eager = mode == "eager"
            n1, n2 = GRAPH_STREAM[mode]
            torch.cuda.synchronize()
            sub = []
            for i in range(3):
                t0 = time.perf_counter()
                pending = pred._submit(batch, 100 + i, eager)
                sub.append((time.perf_counter() - t0) * 1e3)
                pred.result(pending)
            block = []
            for i in range(3):
                t0 = time.perf_counter()
                pred.result(pred._submit(batch, 200 + i, eager))
                block.append((time.perf_counter() - t0) * 1e3)
            t1 = graph_stream(pred, batch, n1, eager, 300)
            t2 = graph_stream(pred, batch, n2, eager, 400)
            out[mode].append({"submit_ms": float(np.median(sub)),
                              "blocking_ms": float(np.median(block)),
                              "steady_ms": (t2 - t1) / (n2 - n1) * 1e3})
    return out


def graph_profile(request) -> dict:
    """One blocking request under the profiler: the host's launch calls
    (graph launches, kernel launches, copies), the device's kernels and
    copies and their ms, and K1's and K2's launches counted from them (the
    lead-in markers of `traced` left out)."""
    from egohmr_tpu_torch.utils.profiling import device_kernels, host_launches

    with traced("a profiled request", cpu=True) as prof:
        request()
    kernels, host = device_kernels(prof), host_launches(prof)
    n, ms = markers_in(prof)
    host["kernel_launches"] -= MARKERS
    host["total"] -= MARKERS
    return {"host": host, "device_kernels": kernels["count"] - n,
            "kernel_ms": kernels["ms"] - ms, "launches": launches_on_device(prof)}


def phase_graphs(cfg, smi: str) -> dict:
    """Phase 14: the served request as one captured CUDA graph per shape
    (`utils/graphs.py`, behind `Predictor`), at full width. (a) unguided
    DDIM-5 at 64, bf16 and f32: replayed requests equal `Predictor.eager`
    on the same seeds bit for bit, also after a capture of another shape;
    K1 once per request by the replay accounting. (b) guided DDIM-5 at 64
    and guided DDPM-50 at 16, bf16, on phase 5's closed body and penetrated
    scenes at its raised weights (so that the guided steps move the
    bodies): two eager runs of one seed first; replay then equals eager bit
    for bit where those two do, else stays within twice their gap; K2 4
    and 11 per request by the replay accounting and by the profiler. (c)
    the profiler on one replayed and one eager request of each. (d) host
    submit, blocking and steady-state ms per request, eager against
    graphed, in turns; each program's capture seconds and pool bytes."""
    from egohmr_tpu_torch.collision import knn as k2
    from egohmr_tpu_torch.data import synthetic_batch
    from egohmr_tpu_torch.diffusion import GuidanceConfig, make_schedule
    from egohmr_tpu_torch.geometry import rotmat_to_rot6d
    from egohmr_tpu_torch.models import BodyRepStats, EgoHMR, init_random_
    from egohmr_tpu_torch.nn import pointnet_fused as k1
    from egohmr_tpu_torch.serving import MESH_OUTPUT_KEYS, Predictor
    from egohmr_tpu_torch.smpl import make_synthetic_model

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    model = init_random_(EgoHMR(cfg), seed=0).eval()
    res = {"k1": 0, "k2": 0, "runs": {}}
    log("graphs", smi)

    def record(name, pred, batch, extra):
        prof_graph = graph_profile(lambda: pred(batch, seed=7))
        prof_eager = graph_profile(lambda: pred.eager(batch, seed=7))
        times = graph_times(pred, batch)
        prog = pred._programs[0]
        run = {"capture_s": prog.capture_seconds, "pool_bytes": prog.pool_bytes,
               "programs": len(prog.programs), "profile_graphed": prof_graph,
               "profile_eager": prof_eager, "times": times, **extra}
        res["runs"][name] = run
        log("graphs", f"{name}: captured {run['programs']} program(s) in {run['capture_s']:.2f} s "
                      f"(warm-up runs included), pools {run['pool_bytes'] / 2 ** 20:.0f} MiB")
        for tag, p in (("replayed", prof_graph), ("eager", prof_eager)):
            log("graphs", f"{name}, one {tag} request under the profiler: host launch calls "
                          f"{p['host']}, device kernels and copies {p['device_kernels']} "
                          f"({p['kernel_ms']:.2f} ms), K1 and K2 launches by the device's "
                          f"kernels {p['launches']}")
        for mode, rounds in times.items():
            log("graphs", f"{name}, {mode}, ms per request over {GRAPH_ROUNDS} rounds: submit "
                          + ", ".join(f"{r['submit_ms']:.2f}" for r in rounds) + "; blocking "
                          + ", ".join(f"{r['blocking_ms']:.2f}" for r in rounds) + "; steady "
                          + ", ".join(f"{r['steady_ms']:.2f}" for r in rounds))
        return prof_graph

    # (a) unguided DDIM-5 at 64, bf16 and f32
    smpl = make_synthetic_model(num_vertices=V_FULL)
    stats = BodyRepStats(torch.zeros(144), torch.ones(144))
    schedule = make_schedule(50, "cosine", "ddim5")
    batch = synthetic_batch(B_TIME, num_scene_points=P_FULL, seed=10)
    other = synthetic_batch(B_TIME, num_scene_points=P_FULL // 2, seed=11)
    for bf16 in (True, False):
        name = f"(a) unguided DDIM-5, batch {B_TIME}, {'bf16' if bf16 else 'f32'}"
        pred = Predictor(model, cfg, smpl, stats, schedule, device=dev, batch_size=B_TIME,
                         bf16=bf16, pointnet_impl="fused")
        if not pred.captured:
            fail(f"{name}: the one-device Predictor on the card is not captured")
        pred.warmup(batch)
        k1.launches = k2.launches = 0  # main path starts: count launches from here
        fused_starts()
        # under the profiler: the replay accounting against the device's kernels
        got, _ = profiled_launches(lambda: [pred(batch, seed=s) for s in GRAPH_SEEDS], name,
                                   want={"k1": len(GRAPH_SEEDS), "k2": 0,
                                         "gconv": GCONV_PER_CALL * 5 * len(GRAPH_SEEDS) * bf16,
                                         "resnet": RESNET_PER_FORWARD * len(GRAPH_SEEDS) * bf16})
        d1, d2 = k1.launches, k2.launches  # main path ends
        fused_ends("graphs")
        res["k1"] += d1
        gaps = [max_gap(g, pred.eager(batch, seed=s)) for g, s in zip(got, GRAPH_SEEDS)]
        pred.warmup(other)  # a second shape, a second program
        after = max_gap(pred(batch, seed=4), pred.eager(batch, seed=4))
        n_prog = len(pred._programs[0].programs)
        log("graphs", f"{name}: replay against eager on seeds {GRAPH_SEEDS}: max |diff| "
                      f"{', '.join(f'{g:.3e}' for g in gaps)} (bar: 0, bit for bit); after "
                      f"capturing P={P_FULL // 2}: {after:.3e}, {n_prog} programs; K1 {d1} "
                      f"launches in {len(GRAPH_SEEDS)} replayed requests by the replay "
                      "accounting and by the device's kernels")
        if max(gaps) != 0 or after != 0 or n_prog != 2:
            fail(f"{name}: a replayed request differs from its eager run")
        record(name, pred, batch, {"replay_vs_eager": gaps, "after_other_shape": after})
        del pred
        torch.cuda.empty_cache()

    # (b) guided DDIM-5 at 64 and DDPM-50 at 16 on phase 5's scenes
    body = closed_body_model()
    leg = np.isin(body.lbs_weights.numpy().argmax(1), LEG_JOINTS)
    rest = rotmat_to_rot6d(torch.eye(3).expand(24, 3, 3)).reshape(144)
    gstats = BodyRepStats(rest, torch.full((144,), 0.2))
    for sampler, respacing, B, n_guided in (("ddim", "ddim5", 64, 4), ("ddpm", "", 16, 11)):
        schedule = make_schedule(50, "cosine", respacing)
        name = f"(b) guided {sampler.upper()}-{schedule.num_timesteps}, batch {B}, bf16"
        kw = dict(device=dev, batch_size=B, sampler=sampler, pointnet_impl="fused",
                  output_keys=MESH_OUTPUT_KEYS)
        free = Predictor(model, cfg, body, gstats, schedule, **kw)
        scene = synthetic_batch(B, num_scene_points=P_FULL, seed=20)
        scene = penetrated(scene, free.eager(scene, seed=1), leg)
        del free
        pred = Predictor(model, cfg, body, gstats, schedule, with_guidance=True,
                         guidance=GuidanceConfig(**RAISED[sampler]), **kw)
        e1, e2 = pred.eager(scene, seed=1), pred.eager(scene, seed=1)
        eager_gap = max_gap(e1, e2)
        pred.warmup(scene)
        k1.launches = k2.launches = 0  # main path starts: count launches from here
        fused_starts()
        # under the profiler: the replay accounting against the device's kernels
        got, _ = profiled_launches(lambda: pred(scene, seed=1), name,
                                   want={"k1": 1, "k2": n_guided,
                                         "gconv": GCONV_PER_CALL * schedule.num_timesteps,
                                         "resnet": RESNET_PER_FORWARD})
        d1, d2 = k1.launches, k2.launches  # main path ends
        fused_ends("graphs")
        res["k1"] += d1
        res["k2"] += d2
        gap = max_gap(got, e1)
        bar = 0.0 if eager_gap == 0 else 2 * eager_gap
        record(name, pred, scene, {"eager_vs_eager": eager_gap, "replay_vs_eager": gap,
                                   "k2_per_request": d2})
        log("graphs", f"{name}, raised weights {RAISED[sampler]}: eager against eager max "
                      f"|diff| {eager_gap:.3e}, replay against eager {gap:.3e} (bar "
                      f"{bar:.3e}: {'bit for bit' if bar == 0 else 'twice the eager gap'}); "
                      f"K1 {d1}, K2 {d2} launches by the replay accounting and by the "
                      f"device's kernels (want 1, {n_guided})")
        if gap > bar:
            fail(f"{name}: the replayed request strays from the eager one")
        del pred
        torch.cuda.empty_cache()
    log("graphs", f"phase 14 in {time.perf_counter() - t_phase:.1f} s")
    log("graphs", json.dumps(res["runs"]))
    return res


VOLSDF_REQUEST = dict(B=5, S=5, weight=30.0)  # the evaluation CLI's 5 x 5, its weight
BULK_HOST_CALLS = 22  # a replayed bulk request from NumPy: 1 graph launch, 1 kernel, 20 copies


def phase_served_volsdf(cfg, smi: str) -> dict:
    """Phase 15: EgoHMR-VolSMPL on the served path at full width (see the
    module's docstring): the learned-SDF guided request captured in
    `Predictor`, its replay against eager, its counters and record; the
    unguided bulk request's host calls."""
    from egohmr_tpu_torch.data import synthetic_batch
    from egohmr_tpu_torch.diffusion import GuidanceConfig, make_schedule
    from egohmr_tpu_torch.models import BodyRepStats, EgoHMR, init_random_
    from egohmr_tpu_torch.serving import GUIDANCE_RECORD, Predictor

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the field's f32, as served
    log("volsdf", smi)
    model = init_random_(EgoHMR(cfg), seed=0).eval()
    net, meta = load_learned(WIDE["volsdf"], dev)
    body = body_of(meta, "cpu")
    B, S = VOLSDF_REQUEST["B"], VOLSDF_REQUEST["S"]
    gcfg = GuidanceConfig(cond_grad_weight=VOLSDF_REQUEST["weight"])
    steps = gcfg.ddpm_threshold + 1
    schedule = make_schedule(50, "cosine", "")
    batch = numpy_batch(synthetic_batch(B, num_scene_points=P_FULL, seed=30))

    def predictor(**kw):
        return Predictor(model, cfg, body, BodyRepStats(torch.zeros(144), torch.ones(144)),
                         schedule, device=dev, batch_size=B,
                         num_samples=S, sampler="ddpm", pointnet_impl="fused",
                         with_guidance=True, guidance=gcfg, collision_backend="volsdf",
                         collision_net=net, guidance_scene_points=None, **kw)

    # (a) the captured request against eager, its counters and record
    pred = predictor(record_guidance=True)
    e1, e2 = pred.eager(batch, seed=1), pred.eager(batch, seed=1)
    eager_gap = max_gap(e1, e2)
    pred.warmup(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = (pred.guided_steps, pred.field_rows)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fused_starts()  # main path starts
    start.record()
    got = pred(batch, seed=1)
    end.record()
    torch.cuda.synchronize()
    fused, fused_resnet = fused_ends("volsdf")  # main path ends
    ms, peak = start.elapsed_time(end), torch.cuda.max_memory_allocated()
    counted = (pred.guided_steps - before[0], pred.field_rows - before[1])
    want_rows = steps * B * S * 24 * P_FULL
    gap = max_gap(got, e1)
    bar = 0.0 if eager_gap == 0 else 2 * eager_gap
    rec = got[GUIDANCE_RECORD]
    grad = np.abs(rec[:, :, :, 2])
    log("volsdf", f"(a) {B} x {S}, DDPM-50 guided at weight {gcfg.cond_grad_weight} over "
                  f"{P_FULL} points: eager against eager max |diff| {eager_gap:.3e}, replay "
                  f"against eager {gap:.3e} (bar {bar:.3e}); per replayed request guided steps "
                  f"{counted[0]}, field rows {counted[1]} (want {steps}, {want_rows}); "
                  f"{ms:.1f} ms on the card, peak {peak / 2 ** 30:.2f} GiB, capture "
                  f"{pred._programs[0].capture_seconds:.1f} s, pool "
                  f"{pred._programs[0].pool_bytes / 2 ** 30:.2f} GiB; record {rec.shape}, "
                  f"|g| max {grad.max():.3e}")
    if gap > bar:
        fail("volsdf (a): the replayed request strays from the eager one")
    want_fused = GCONV_PER_CALL * schedule.num_timesteps
    if (counted != (steps, want_rows) or fused != want_fused
            or fused_resnet != RESNET_PER_FORWARD):
        fail(f"volsdf (a): counters {counted}, {fused} fused graph convolutions and "
             f"{fused_resnet} fused ResNet passes, want {(steps, want_rows)}, {want_fused} "
             f"and {RESNET_PER_FORWARD}")
    if rec.shape[2] != steps or not np.all(np.isfinite(rec)) or grad.max() == 0:
        fail(f"volsdf (a): the record holds {rec.shape[2]} steps (want {steps}), or a "
             "non-finite value, or no gradient")
    # one more replayed request under the profiler: the accounting against
    # the device's kernels
    fused_starts()
    profiled_launches(lambda: pred(batch, seed=2), "volsdf (a): a replayed request",
                      want={"k1": 1, "k2": 0, "gconv": want_fused, "resnet": RESNET_PER_FORWARD})
    fused_ends("volsdf")
    log("volsdf", f"(a) a replayed request under the profiler: K1 1, {want_fused} fused graph "
                  f"convolutions, {RESNET_PER_FORWARD} fused ResNet passes by the replay "
                  "accounting and by the device's kernels")
    del pred
    torch.cuda.empty_cache()

    # (b) without the record
    plain = predictor()
    plain.warmup(batch)
    out = plain(batch, seed=1)
    if GUIDANCE_RECORD in out or max_gap(out, {k: got[k] for k in out}) > bar:
        fail("volsdf (b): a request without record_guidance returned a record, or other "
             "outputs")
    log("volsdf", "(b) without record_guidance: no record, the outputs of (a) "
                  f"(max |diff| {max_gap(out, {k: got[k] for k in out}):.3e})")
    del plain
    torch.cuda.empty_cache()

    # (c) the unguided bulk request's host calls and device kernels
    bulk = Predictor(model, cfg, body, BodyRepStats(torch.zeros(144), torch.ones(144)),
                     make_schedule(50, "cosine", "ddim5"), device=dev, batch_size=B_TIME,
                     pointnet_impl="fused")
    big = numpy_batch(synthetic_batch(B_TIME, num_scene_points=P_FULL, seed=31))
    bulk.warmup(big)
    prof = graph_profile(lambda: bulk(big, seed=2))
    log("volsdf", f"(c) the unguided bulk request, replayed: host launch calls "
                  f"{prof['host']}, device kernels and copies {prof['device_kernels']} "
                  f"({prof['kernel_ms']:.2f} ms)")
    if prof["host"]["total"] != BULK_HOST_CALLS:
        fail(f"volsdf (c): {prof['host']['total']} host calls, want {BULK_HOST_CALLS}")
    log("volsdf", f"phase 15 in {time.perf_counter() - t_phase:.1f} s")
    return {"replay_vs_eager": gap, "eager_vs_eager": eager_gap, "ms": ms, "peak": peak,
            "bulk_kernels": prof["device_kernels"]}


def numpy_batch(batch):
    """A batch's leaves as NumPy arrays (what a server receives)."""
    if isinstance(batch, dict):
        return {k: numpy_batch(v) for k, v in batch.items()}
    return batch.numpy() if isinstance(batch, torch.Tensor) else np.asarray(batch)


def main() -> None:
    smi = phase_device()
    from egohmr_tpu_torch.models import EgoHMRConfig

    cfg = EgoHMRConfig()  # full width: ResNet-50, H=256, GCN 1024x4
    seconds = {}

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    timed("build", phase_build)
    kernels = timed("kernel", lambda: [phase_kernel_k1(cfg), phase_kernel_k2(),
                                       phase_kernel_k3(), phase_kernel_gconv(cfg),
                                       phase_kernel_resnet()])
    unguided = timed("serve", phase_serve, cfg)
    guided = timed("guided", phase_guided, cfg)
    evaluated = timed("eval", phase_eval, cfg)
    trained = timed("train", phase_train, cfg)
    stage1 = timed("stage1", phase_stage1)
    learned = timed("learned", phase_learned, cfg)
    parallel = timed("parallel", phase_parallel, cfg)
    tensor_parallel = timed("tp", phase_tp, cfg)
    benched = timed("bench", phase_bench)
    tools = timed("tools", phase_tools)
    graphs = timed("graphs", phase_graphs, cfg, smi)
    timed("volsdf", phase_served_volsdf, cfg, smi)
    log("main", f"seconds per phase: {json.dumps(seconds)}")
    # launches: over the main paths, each counted from 0 just before it (K3's
    # main path is the probe's own entry point, counted in its phase)
    kernels[0].update(launches=(unguided + guided["k1"] + evaluated["k1"] + trained["k1"]
                                + stage1["launches"] + stage1["train_launches"] + learned["k1"]
                                + parallel["k1"] + tensor_parallel["k1"] + benched["k1"]
                                + tools["k1"] + graphs["k1"]),
                      launches_learned=learned["k1"], launches_parallel=parallel["k1"],
                      launches_tp=tensor_parallel["k1"], launches_bench=benched["k1"],
                      launches_tools=tools["k1"], launches_graphs=graphs["k1"],
                      launches_profiled=PROFILED["k1"],
                      launches_unguided=unguided, launches_guided=guided["k1"],
                      launches_eval=evaluated["k1"], launches_train=trained["k1"],
                      launches_stage1=stage1["launches"],
                      launches_stage1_train=stage1["train_launches"], stage1=stage1["k1"])
    kernels[1].update(launches=(guided["k2"] + evaluated["k2"] + trained["k2"] + learned["k2"]
                                + parallel["k2"] + tensor_parallel["k2"] + benched["k2"]
                                + tools["k2"] + graphs["k2"]),
                      launches_learned=learned["k2"], launches_parallel=parallel["k2"],
                      launches_tp=tensor_parallel["k2"], launches_bench=benched["k2"],
                      launches_tools=tools["k2"], launches_graphs=graphs["k2"],
                      launches_profiled=PROFILED["k2"],
                      parallel_collision_shape=parallel["k2_collision_shape"],
                      distill_label_shapes=learned["k2_label_shapes"],
                      launches_unguided=0, launches_guided=guided["k2"],
                      launches_eval=evaluated["k2"], launches_train=trained["k2"],
                      eval_shapes={k: evaluated[k] for k in
                                   ("k2_metric_ms", "k2_cloud_ms", "k2_bound_ms", "eval_ms")},
                      train_shape=trained["k2_train_shape"])
    kernels[3].update(launches=sum(GCONV.values()),
                      **{f"launches_{phase}": n for phase, n in GCONV.items()},
                      launches_profiled=PROFILED["gconv"])
    kernels[4].update(launches=sum(RESNET.values()),
                      **{f"launches_{phase}": n for phase, n in RESNET.items()},
                      launches_profiled=PROFILED["resnet"])
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
