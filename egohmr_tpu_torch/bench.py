"""Measurement CLI of the port: stage-2 body sampling (`eval.pipeline.
sample_bodies`, the served request's arithmetic), serving (`serving.
Predictor`), training and the host input pipeline on one NVIDIA GPU, with
the modes, flags and metric names of the JAX package's `bench.py`. The
port's benchmark, which judges it, is `hmrbench/` (`python3
hmrbench/run.py --workload <cell>`).

    python -m egohmr_tpu_torch.bench [--guided | --guided-ddim | --serving
        [--pack16] | --train | --host] [--batch-size N] [--iters K] [--f32]
        [--quick] [--cpu]

Prints ONE JSON line, `{"metric": ..., "value": N, "unit": ...,
"vs_baseline": null, "extra": {...}}`:

  (default)      ddim5_samples_per_sec_per_chip: unguided DDIM-5 through
                 `sample_bodies` (conditioning once, five GCN steps, SMPL),
                 batch 64, bf16 conditioning and denoiser with kernel K1;
                 and the paper setting (32 images x 5 samples);
  --guided       guided_ddpm50_samples_per_sec_per_chip, batch 16;
  --guided-ddim  guided_ddim5_samples_per_sec_per_chip, batch 64;
  --serving      serving_predictor_samples_per_sec_per_chip (`Predictor.
                 map_batches`, host readback included; `_pack16` with
                 --pack16);
  --train        train_step_imgs_per_sec_per_chip: the full training step,
                 batch 16, collision loss on, bf16-mixed (--f32: f32 with
                 TF32 off);
  --host         host_pipeline_imgs_per_sec: JPEG decode + crop warp +
                 normalise on 1920x1080 frames.

On the card each request program runs as one captured CUDA graph per
shape (`utils/graphs.py:CapturedProgram`), as the JAX bench jits its
programs: the sampling modes' `sample_bodies` and the serving layer's
request (`Predictor`). x_T and the steps' noise are drawn eagerly from the
request's generator and copied in. The request hook gets each program's
request eagerly (`program.eager`), so that every kernel call of it can be
watched, and replayed, so that the replay can be held to it. `--train`
runs eagerly. `extra.capture` holds the captures' seconds and the graphs'
pool bytes.

Throughput is steady state by chain-length differencing
(`_chain_throughput`). Every result names its device: the card's name and
power limit as `nvidia-smi` prints them, or "cpu". Without a CUDA device
and without --cpu the run prints the mode's metric with a null value and
an error, and exits 1: a measurement never falls back to the CPU, and a
--cpu run's numbers are no device metric. `--quick` runs tiny widths and
shapes, a smoke test.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .utils.graphs import CapturedProgram

# the tiny widths of --quick (ResNet-18: the port has no stub backbone)
QUICK = dict(resnet_layers=18, img_feat_dim=512, scene_feat_dim=32,
             pointnet_hidden_dim=32, transl_embed_dim=16, timestep_embed_dim=32,
             input_process_dim=32, gcn_hid_dim=64, gcn_layers=2)
QUICK_SHAPES = (4, 512, 256, 32)  # batch, scene points, vertices, image size
FULL_P, FULL_V, FULL_IMG = 20000, 6890, 224


class Request(NamedTuple):
    """One untimed request of a program a mode times, as the request hook
    gets it: `request()` runs it eagerly, each kernel call made in the
    caller's sight; `request.replay()` runs the same request, on the same
    inputs and draws, through its captured program (None where the mode
    runs eagerly)."""

    eager: Callable[[], object]
    replay: Optional[Callable[[], object]] = None

    def __call__(self):
        return self.eager()


RequestHook = Optional[Callable[[str, Request], None]]


class Chain(NamedTuple):
    """`_chain_throughput`'s result: seconds per call in steady state, the
    p50 blocking latency (None unless asked), the first call's seconds and
    the raw readings."""

    dt: float
    p50: Optional[float]
    first_s: float
    readings: Dict


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> tuple:
    from .collision import knn as k2
    from .nn import pointnet_fused as k1

    return k1.launches, k2.launches


def _chain_throughput(call, iters: int, device: torch.device, *,
                      measure_latency: bool = False, min_chain: int = 3) -> Chain:
    """Steady-state time per call by chained launches and a completion
    fence: `call(i)` queues one request keyed by the integer i (distinct
    seeds), a chain of n calls ends in `torch.cuda.synchronize(device)`,
    and dt = (t(n2) - t(n1)) / (n2 - n1) over the minimum of two chains of
    each length, which cancels the fence and the queue's fill. The first
    call (kernel builds, K1's weight preparation, cuDNN's algorithm
    choice) is timed on its own; with `measure_latency` the p50 of `iters`
    one-call chains is the blocking latency. On the card CUDA events
    bracket every chain: their milliseconds, the host clock's raw chain
    seconds and the K1 and K2 launches per call go into the readings.
    n1 = max(iters, `min_chain`); --quick smoke runs pass 1."""
    cuda = device.type == "cuda"
    k1_0, k2_0 = _launches()
    calls = 0

    def chain(n, key0):
        nonlocal calls
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else None
        t0 = time.perf_counter()
        if cuda:
            events[0].record()
        for i in range(n):
            call(key0 + i)
        if cuda:
            events[1].record()
        _sync(device)
        calls += n
        return (time.perf_counter() - t0,
                events[0].elapsed_time(events[1]) if cuda else None)

    first_s, _ = chain(1, 0)
    lat = None
    lat_s = []
    if measure_latency:
        lat_s = [chain(1, i + 1)[0] for i in range(iters)]
        lat = sorted(lat_s)[len(lat_s) // 2]
    n1 = max(iters, min_chain)
    n2 = 3 * n1
    r1 = [chain(n1, 100), chain(n1, 200)]
    r2 = [chain(n2, 300), chain(n2, 400)]
    d1, d2 = min(h for h, _ in r1), min(h for h, _ in r2)
    dt = max(d2 - d1, 1e-9) / (n2 - n1)
    k1_1, k2_1 = _launches()
    readings = {
        "first_call_s": first_s, "blocking_s": lat_s, "n1": n1, "n2": n2,
        "host_s_n1": [h for h, _ in r1], "host_s_n2": [h for h, _ in r2],
        "launches_per_call": {"k1": (k1_1 - k1_0) / calls, "k2": (k2_1 - k2_0) / calls},
    }
    if cuda:
        e1, e2 = min(e for _, e in r1), min(e for _, e in r2)
        readings.update(event_ms_n1=[e for _, e in r1], event_ms_n2=[e for _, e in r2],
                        event_ms_per_call=max(e2 - e1, 0.0) / (n2 - n1))
    return Chain(dt, lat, first_s, readings)


# ------------------------------------------------------------------ set-up
def resolve_device(args) -> Optional[torch.device]:
    """The card, or the CPU with --cpu; None when there is no card."""
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        return None
    return torch.device("cuda", torch.cuda.current_device())


def fail_no_device(metric: str, unit: str) -> int:
    print(json.dumps({
        "metric": metric, "value": None, "unit": unit, "vs_baseline": None,
        "error": "no CUDA device: torch.cuda.is_available() is False. This "
                 "benchmark measures the card; --cpu runs it on the CPU, "
                 "whose numbers are no device metric"}))
    return 1


def device_name(device: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
        return out.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def set_f32(f32: bool) -> None:
    """--f32: float32 in full float32 on the card, TF32 off in matmuls and
    in cuDNN. Otherwise PyTorch's defaults (TF32 off in matmuls, on in
    cuDNN's convolutions), as the reference runs."""
    if f32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def tf32_state() -> Dict[str, bool]:
    return {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}


def model_config(quick: bool, **overrides):
    """`EgoHMRConfig()` at full width, or the tiny widths of --quick."""
    from .models import EgoHMRConfig

    return EgoHMRConfig(**{**(QUICK if quick else {}), **overrides})


def random_model(cfg, device: torch.device, *, training: bool = False):
    """Stage 2 with random weights from seed 0, on `device` in channels_last
    (the serving layout)."""
    from .models import EgoHMR, init_random_

    model = init_random_(EgoHMR(cfg), seed=0, training=training)
    if not training:
        model = model.eval()
    return model.to(device, memory_format=torch.channels_last)


def unit_stats(device: torch.device):
    from .models import BodyRepStats

    return BodyRepStats(torch.zeros(144, device=device), torch.ones(144, device=device))


def generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def git_rev() -> Optional[str]:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            capture_output=True, text=True, timeout=10).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def min_chain(args) -> int:
    """The shortest chain n1: 3, as the JAX bench; 1 for --quick smokes."""
    return 1 if args.quick else 3


def _log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def _ms(s: Optional[float]) -> Optional[float]:
    return None if s is None else s * 1e3


def capture_extra(programs) -> Dict:
    """The captures behind a mode's programs: their seconds (warm-up runs
    included) and the bytes their graphs' private pools hold; zeros where
    nothing was captured (the CPU)."""
    return {"seconds": sum(p.capture_seconds for p in programs),
            "pool_bytes": sum(p.pool_bytes for p in programs),
            "programs": sum(len(p.programs) for p in programs)}


# ------------------------------------------------------------------- modes
def _sampling_bench(args, dev, hook: RequestHook) -> int:
    """Stage-2 body sampling through `eval.pipeline.sample_bodies`, the
    served request's arithmetic: unguided DDIM-5 at batch 64 and the paper
    setting, 32 images x 5 samples (default); guided DDPM-50 at batch 16
    (--guided, the paper's setting) or guided DDIM-5 at batch 64
    (--guided-ddim). bf16 conditioning and denoiser (the model cast once),
    f32 guidance, sampler and SMPL; --f32 all f32."""
    from .data import synthetic_batch
    from .diffusion import GuidanceConfig, draw_step_noise, make_schedule
    from .eval.pipeline import sample_bodies
    from .nn import cast_params_bf16
    from .smpl import make_synthetic_model

    use_bf16 = not args.f32
    guided = args.guided or args.guided_ddim
    cfg = model_config(args.quick, pointnet_impl=args.pointnet)
    if args.quick:
        B, P, V, img = QUICK_SHAPES
    else:
        default_b = 16 if guided and not args.guided_ddim else 64
        B, P, V, img = (args.batch_size if args.batch_size != 64 else default_b,
                        FULL_P, FULL_V, FULL_IMG)
    metric, unit = mode_metric(args)
    if args.guided_ddim:
        sampler, respacing, tag = "ddim", "ddim5", "guided-ddim5"
    elif args.guided:
        sampler, respacing, tag = "ddpm", "", "guided"
    else:
        sampler, respacing, tag = "ddim", "ddim5", "ddim5"
    refresh = max(1, args.guidance_refresh) if guided else 1
    if refresh > 1:
        tag += f"-selreuse{refresh}"
    model = random_model(cfg, dev)
    if use_bf16:
        model = cast_params_bf16(model)
    smpl = make_synthetic_model(num_vertices=V, device=dev)
    stats = unit_stats(dev)
    schedule = make_schedule(50, "cosine", respacing).to(dev)
    gcfg = GuidanceConfig(cond_grad_weight=2.0)
    programs = []

    def timed(name, n_images, num_samples, measure_latency):
        """Time the request of `n_images` x `num_samples` bodies as one
        captured program (the JAX bench's jitted request), x_T and the
        steps' noise drawn outside from the request's generator."""
        batch = synthetic_batch(n_images, num_scene_points=P, img_size=img, device=dev)
        rows = (n_images * num_samples, 144)

        def request(b, x_T, step_noise):
            outs, _ = sample_bodies(
                model, cfg, smpl, stats, schedule, b, None, num_samples, sampler=sampler,
                with_guidance=guided, guidance=gcfg, guidance_refresh_every=refresh,
                noise=x_T, step_noise=step_noise)
            return outs["pred_keypoints_3d"]

        program = CapturedProgram(
            request, name=f"{name} request ({n_images} images x {num_samples} samples)")
        programs.append(program)

        def call(i, run=program):
            gen = generator(dev, i)  # x_T, then the steps' noise, as sample_loop draws them
            x_T = torch.randn(rows, generator=gen, device=dev)
            return run(batch, x_T, draw_step_noise(schedule, gen, rows, sampler=sampler))

        if hook is not None:
            hook(name, Request(lambda: call(10 ** 6, run=program.eager),
                               lambda: call(10 ** 6)))
        ch = _chain_throughput(call, args.iters, dev, measure_latency=measure_latency,
                               min_chain=min_chain(args))
        latency = f"blocking p50 {ch.p50 * 1e3:.1f}ms, " if measure_latency else ""
        _log(f"{name}: first call {ch.first_s:.1f}s, {latency}pipelined "
             f"{ch.dt * 1e3:.1f}ms/batch -> {rows[0] / ch.dt:.1f} samples/s")
        return ch

    S = args.num_samples
    ch = timed(tag, B, S, True)
    readings = {tag: ch.readings}
    extra = {
        "batch_size": B,
        "num_samples_per_image": S,
        "scene_points": P,
        "p50_latency_ms_per_batch": _ms(ch.p50),
        "ms_per_batch": ch.dt * 1e3,
        "first_call_s": ch.first_s,
        "throughput_mode": "pipelined (launches queued, one synchronize at the end of "
                           "a chain, chain-length differencing); latency is the "
                           "blocking per-batch p50",
        "sampler": f"{sampler}{schedule.num_timesteps}",
        "conditioning_dtype": "bfloat16" if use_bf16 else "float32",
        "pointnet_impl": cfg.pointnet_impl,
        "tf32": tf32_state(),
        "batch_on_device": "the batch stays on the device between calls; the "
                           "--serving mode includes its upload",
    }
    if guided:
        extra.update(cond_grad_weight=gcfg.cond_grad_weight,
                     guidance_selection_refresh_every=refresh)
    else:
        paper_sps = None
        if not args.quick and S == 1:
            ch5 = timed("paper setting", 32, 5, False)
            paper_sps = 32 * 5 / ch5.dt
            readings["paper_setting"] = ch5.readings
        extra["paper_setting_samples_per_sec"] = paper_sps
    extra.update(launches_per_request=ch.readings["launches_per_call"],
                 capture=capture_extra(programs), readings=readings, platform=dev.type,
                 device=device_name(dev))
    print(json.dumps({
        "extra": extra,
        "companion_benchmarks": None,
        "metric": metric,
        "value": B * S / ch.dt,
        "unit": unit,
        "vs_baseline": None,
        "git_rev": git_rev(),
    }))
    return 0


def _serving_bench(args, dev, hook: RequestHook) -> int:
    """Steady state of the serving layer, `serving.Predictor.map_batches`
    (bounded in-flight window, one packed readback per request into pinned
    memory): fully read-back numpy outputs, the request's upload included,
    by stream-length differencing."""
    from .data import synthetic_batch
    from .diffusion import make_schedule
    from .serving import Predictor
    from .smpl import make_synthetic_model

    use_bf16 = not args.f32
    cfg = model_config(args.quick)
    B, P, V, img = QUICK_SHAPES if args.quick else (args.batch_size, FULL_P, FULL_V, FULL_IMG)
    model = random_model(cfg, torch.device("cpu"))
    smpl = make_synthetic_model(num_vertices=V)
    schedule = make_schedule(50, "cosine", "ddim5")
    pred = Predictor(model, cfg, smpl, unit_stats(torch.device("cpu")), schedule, device=dev,
                     batch_size=B, num_samples=args.num_samples, sampler="ddim",
                     bf16=use_bf16,
                     pack_dtype=torch.float16 if args.pack16 else torch.float32,
                     pointnet_impl=args.pointnet)
    batch = synthetic_batch(B, num_scene_points=P, img_size=img)

    t0 = time.perf_counter()
    pred.warmup(batch)
    first_s = time.perf_counter() - t0
    if hook is not None:
        hook("serving", Request(lambda: pred.eager(batch, seed=10 ** 6),
                                lambda: pred(batch, seed=10 ** 6)))
    k1_0, k2_0 = _launches()
    requests = 0

    def run_stream(n):
        nonlocal requests
        t0 = time.perf_counter()
        count = 0
        for out in pred.map_batches((dict(batch) for _ in range(n)), seed=requests):
            count += out["pred_betas"].shape[0]
        assert count == n * B
        requests += n
        return time.perf_counter() - t0

    n1 = max(args.iters, min_chain(args))
    n2 = 3 * n1
    r1 = [run_stream(n1), run_stream(n1)]
    r2 = [run_stream(n2), run_stream(n2)]
    dt = max(min(r2) - min(r1), 1e-9) / (n2 - n1)
    k1_1, k2_1 = _launches()
    sps = B * args.num_samples / dt
    _log(f"serving: first request {first_s:.1f}s, steady-state {dt * 1e3:.1f}ms/batch -> "
         f"{sps:.1f} bodies/s (host readback incl.)")
    print(json.dumps({
        "metric": mode_metric(args)[0],
        "value": sps,
        "unit": "samples/s",
        "vs_baseline": None,
        "extra": {
            "batch_size": B,
            "num_samples_per_image": args.num_samples,
            "scene_points": P,
            "ms_per_batch_steady_state": dt * 1e3,
            "first_call_s": first_s,
            "max_inflight": pred.max_inflight,
            "conditioning_dtype": "bfloat16" if use_bf16 else "float32",
            "pointnet_impl": pred.cfg.pointnet_impl,
            "tf32": tf32_state(),
            "pack_dtype": "float16" if args.pack16 else "float32",
            "readback": "one packed copy per request into pinned memory, unpacked to "
                        "numpy outputs: host consumption and the upload included",
            "launches_per_request": {"k1": (k1_1 - k1_0) / requests,
                                     "k2": (k2_1 - k2_0) / requests},
            "captured": pred.captured,
            "capture": capture_extra(pred._programs),
            "readings": {"n1": n1, "n2": n2, "host_s_n1": r1, "host_s_n2": r2},
            "platform": dev.type,
            "device": device_name(dev),
        },
    }))
    return 0


def _train_bench(args, dev, hook: RequestHook) -> int:
    """The full training step (forward, backward, AdamW, BatchNorm running
    statistics): batch 16, 20,000 scene points, the collision loss on (K2
    on the K nearest points of each body's bbox), the training init from a
    seed; bf16-mixed by default, f32 with TF32 off under --f32. Each call
    is a real optimizer step on the state the last one left."""
    from .data import synthetic_batch
    from .diffusion import make_schedule
    from .models import LossWeights
    from .smpl import make_synthetic_model
    from .train import TrainConfig, make_optimizer, make_train_step

    mp = not args.f32
    cfg = model_config(args.quick)
    B, P, V, img = QUICK_SHAPES if args.quick else (16, FULL_P, FULL_V, FULL_IMG)
    model = random_model(cfg, dev, training=True)
    smpl = make_synthetic_model(num_vertices=V, device=dev)
    stats = unit_stats(dev)
    schedule = make_schedule(50, "cosine", "").to(dev)
    tcfg = TrainConfig(use_collision_loss=True, mixed_precision=mp)
    step = make_train_step(cfg, tcfg, LossWeights(), schedule, stats, smpl, smpl, smpl,
                           make_optimizer(model, tcfg))
    batch = synthetic_batch(B, num_scene_points=P, img_size=img, device=dev)

    def call(i):
        return step(model, batch, generator(dev, i))["loss"]

    if hook is not None:
        hook("train step", Request(lambda: call(10 ** 6)))
    ch = _chain_throughput(call, args.iters, dev, measure_latency=True,
                           min_chain=min_chain(args))
    loss = float(call(10 ** 6 + 1))
    if not np.isfinite(loss):
        raise RuntimeError(f"the training step's loss is not finite: {loss}")
    ips = B / ch.dt
    dtype = "bf16_mixed" if mp else "float32"
    _log(f"train[{dtype}]: first step {ch.first_s:.1f}s, blocking p50 {ch.p50 * 1e3:.1f}ms, "
         f"steady-state {ch.dt * 1e3:.1f}ms/step -> {ips:.1f} imgs/s")
    print(json.dumps({
        "metric": "train_step_imgs_per_sec_per_chip",
        "value": ips,
        "unit": "imgs/s",
        "vs_baseline": None,
        "extra": {
            "batch_size": B,
            "scene_points": P,
            "collision_loss": True,
            "precision": dtype,
            "tf32": tf32_state(),
            "ms_per_step_steady_state": ch.dt * 1e3,
            "p50_blocking_latency_ms": _ms(ch.p50),
            "first_call_s": ch.first_s,
            "loss_after": loss,
            "launches_per_step": ch.readings["launches_per_call"],
            "readings": ch.readings,
            "platform": dev.type,
            "device": device_name(dev),
        },
    }))
    return 0


def _host_bench(args, dev) -> int:
    """Host input-pipeline throughput on real-shaped frames, in imgs/s:

      * native_threaded: C++ decode + flip + warp + normalise on all threads
        (`native.load_batch`, the training loader's path);
      * pil_native_sequential: PIL decode + the native fused warp, one
        image at a time (what `EgoBodyDataset` does per item);
      * pure_python_fallback: PIL decode + the scipy warp.

    The JPEG corpus is made at HoloLens PV size (1920x1080, quality 90,
    smooth scene-like content, so decode costs what a real frame costs;
    --quick: 320x180) in a temporary directory, removed even when the run
    dies."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="egohmr_hostbench_")
    try:
        return _host_bench_body(args, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _host_bench_body(args, dev, tmp) -> int:
    from PIL import Image

    from . import native
    from .data.augment import crop_transform, warp_affine

    if args.quick:
        B, N_IMGS, (H, W), out_size = 4, 8, (180, 320), 32
    else:
        B, N_IMGS, (H, W), out_size = args.batch_size, max(2 * args.batch_size, 128), \
            (1080, 1920), 224
    rng = np.random.RandomState(0)
    paths = []
    # smooth gradients and soft blobs: noise JPEGs decode unrealistically
    # slowly, flat ones unrealistically fast
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = xx / W * 120 + yy / H * 80
    for i in range(N_IMGS):
        im = base.copy()
        for _ in range(6):
            cx, cy = rng.uniform(0, W), rng.uniform(0, H)
            r = rng.uniform(80, 400) * W / 1920
            im += rng.uniform(20, 60) * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r * r))
        im3 = np.stack([im * s for s in (1.0, 0.9, 0.8)], axis=-1)
        arr = np.clip(im3 + rng.randn(H, W, 3) * 2, 0, 255).astype(np.uint8)
        p = os.path.join(tmp, f"{i:04d}.jpg")
        Image.fromarray(arr).save(p, quality=90)
        paths.append(p)

    mean, std = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)

    def rand_trans(n):
        t = np.zeros((n, 2, 3), np.float32)
        for i in range(n):
            t[i] = crop_transform(
                rng.uniform(0.3, 0.7) * W, rng.uniform(0.3, 0.7) * H,
                rng.uniform(0.1, 0.25) * W, rng.uniform(0.1, 0.25) * W,
                out_size, out_size, 1.0, rng.uniform(-30, 30))
        return t

    def timed(fn, reps=3):
        fn()  # warm: page cache, thread pool
        t0 = time.perf_counter()
        n = 0
        for _ in range(reps):
            n += fn()
        return n / (time.perf_counter() - t0)

    results = {}
    if native.available():
        def run_native():
            idx = rng.randint(0, N_IMGS, B)
            out = native.load_batch([paths[i] for i in idx], rand_trans(B), rng.rand(B) < 0.5,
                                    1 + 0.2 * (rng.rand(B, 3) - 0.5), mean, std, out_size)
            assert out.shape == (B, out_size, out_size, 3)
            return B
        results["native_threaded"] = timed(run_native, reps=5)

        def run_pil_native():
            idx = rng.randint(0, N_IMGS, B)
            t = rand_trans(B)
            for j, i in enumerate(idx):
                with Image.open(paths[i]) as im:
                    arr = np.asarray(im.convert("RGB"))
                native.warp_affine_norm(arr, t[j], out_size, mean=mean, std=std)
            return B
        results["pil_native_sequential"] = timed(run_pil_native)

    def run_pure():
        idx = rng.randint(0, N_IMGS, max(B // 4, 1))  # slow: a sample
        t = rand_trans(len(idx))
        for j, i in enumerate(idx):
            with Image.open(paths[i]) as im:
                arr = np.asarray(im.convert("RGB"))
            patch = warp_affine(arr, t[j], out_size, out_size).transpose(2, 0, 1)
            for c in range(3):
                patch[c] = (np.clip(patch[c], 0, 255) - mean[c]) / std[c]
        return len(idx)
    results["pure_python_fallback"] = timed(run_pure)

    headline = results.get("native_threaded", results["pure_python_fallback"])
    for k, v in results.items():
        _log(f"host {k}: {v:.1f} imgs/s")
    print(json.dumps({
        "metric": "host_pipeline_imgs_per_sec",
        "value": headline,
        "unit": "imgs/s",
        "vs_baseline": None,
        "extra": {
            **results,
            "native_available": native.available(),
            "frame_size": f"{W}x{H} jpeg q90",
            "batch_size": B,
            "cpu_cores": os.cpu_count(),
            "note": "native_threaded scales with the cores",
            "platform": dev.type,
            "device": device_name(dev),
        },
    }))
    return 0


# -------------------------------------------------------------------- main
def mode_metric(args) -> tuple:
    """(metric, unit) of the mode `args` selects, `bench.py`'s names."""
    if args.host:
        return "host_pipeline_imgs_per_sec", "imgs/s"
    if args.guided or args.guided_ddim:
        metric = ("guided_ddim5" if args.guided_ddim else "guided_ddpm50") \
            + "_samples_per_sec_per_chip"
        if args.guidance_refresh > 1:
            metric += f"_selreuse{args.guidance_refresh}"
        return metric, "samples/s"
    if args.serving:
        return ("serving_predictor_samples_per_sec_per_chip"
                + ("_pack16" if args.pack16 else "")), "samples/s"
    if args.train:
        return "train_step_imgs_per_sec_per_chip", "imgs/s"
    return "ddim5_samples_per_sec_per_chip", "samples/s"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m egohmr_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--iters", type=int, default=5,
                    help="chain length n1 (at least 3; n2 = 3 n1) and blocking samples")
    ap.add_argument("--quick", action="store_true", help="tiny widths and shapes (smoke test)")
    ap.add_argument("--f32", action="store_true",
                    help="conditioning and denoiser (training: the whole step) in float32 "
                         "with TF32 off; the default is bf16 with f32 sampler, guidance "
                         "and SMPL")
    ap.add_argument("--bf16", action="store_true", help=argparse.SUPPRESS)  # the default
    ap.add_argument("--pointnet", choices=["fused", "xla"], default="fused",
                    help="scene encoder: kernel K1 (fused, default) or the plain bf16 "
                         "`pointnet_forward` (xla)")
    ap.add_argument("--num-samples", type=int, default=1,
                    help="diverse samples per image; conditioning computed once per image "
                         "and tiled")
    ap.add_argument("--guided", action="store_true",
                    help="guided DDPM-50 at batch 16 instead of the DDIM-5 headline")
    ap.add_argument("--guided-ddim", action="store_true",
                    help="guided DDIM-5 (eps shift at t <= 3) at batch 64")
    ap.add_argument("--guidance-refresh", type=int, default=1,
                    help="guided modes: recompute the guided step's selection pass every "
                         "N-th guided step (an approximation for N > 1; 1 is exact)")
    ap.add_argument("--serving", action="store_true",
                    help="the serving layer, Predictor.map_batches, host readback included")
    ap.add_argument("--pack16", action="store_true",
                    help="with --serving: pack the readback as float16")
    ap.add_argument("--train", action="store_true",
                    help="the full training step: batch 16, collision loss on")
    ap.add_argument("--host", action="store_true",
                    help="the host input pipeline on 1920x1080 JPEG frames")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (a smoke test; its numbers are no device metric)")
    # accepted for bench.py's command lines; the port has no remote device to probe
    ap.add_argument("--no-tunnel-probe", action="store_true", help=argparse.SUPPRESS)
    return ap


def main(argv=None, *, request_hook: RequestHook = None) -> int:
    """Run the mode `argv` selects and print its JSON line; returns the
    exit code. `request_hook(name, request)`, when given, is called once
    for every request program a mode times, before it is timed; calling
    `request()` runs one untimed request eagerly (a caller's check of the
    kernels on the path), and `request.replay()`, where the mode captures
    the program, the same request replayed (a caller's check of replay
    against eager): a `Request`."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.bf16 and args.f32:
        ap.error("--bf16 (the default) conflicts with --f32")
    dev = resolve_device(args)
    if dev is None:
        return fail_no_device(*mode_metric(args))
    set_f32(args.f32)
    if args.host:
        return _host_bench(args, dev)
    if args.serving:
        return _serving_bench(args, dev, request_hook)
    if args.train:
        return _train_bench(args, dev, request_hook)
    return _sampling_bench(args, dev, request_hook)


if __name__ == "__main__":
    sys.exit(main())
