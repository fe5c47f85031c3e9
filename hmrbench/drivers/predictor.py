"""Driver `predictor`: stage 2 served through `egohmr_tpu_torch.serving.
Predictor.map_batches`, unguided DDIM, closed loop, on one card.

Set-up makes the weights on the card from the seed, hands the Predictor a
model already there, makes the traffic's distinct batches (NumPy, so that
each request is uploaded as a server's would be), and warms the one
request shape: the capture, then a short stream through `map_batches`.
The window offers the batches in turn for `--seconds`; a request is timed
from when `map_batches` draws it from the benchmark's iterator to when its
outputs are back in host memory. After the window a sample of its
requests, drawn from the seed, is computed again by the reference in f32
and compared.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from hmrbench.lib import judge, synth
from hmrbench.lib import trace as tr
from hmrbench.lib.cell import Ctx, Outcome, Reading
from hmrbench.lib.common import log, quantile

# compared with the reference's own run: the networks' and the sampler's
# outputs; compared with the reference's SMPL and camera applied to the
# outputs' own pose and betas ("posed."): the skinning and the reprojection
NET_KEYS = ("pred_betas", "pred_pose_6d")
POSED_KEYS = ("pred_keypoints_3d", "pred_keypoints_3d_full", "pred_keypoints_2d_full")


def setting(ctx: Ctx) -> Dict:
    """The request as the cell states it."""
    w, t = ctx.workload["program"], ctx.traffic
    return {"B": t["images_per_request"], "S": t["samples_per_image"],
            "sampler": w["sampler"], "respacing": w["respacing"],
            "bf16": bool(w["bf16"]), "pointnet_impl": w["pointnet_impl"],
            "inflight": t["max_inflight"], "distinct": t["distinct_batches"]}


def inputs(ctx: Ctx, model: torch.nn.Module):
    """(state dict, body tables, batches) of this seed: weights for
    `model`'s structure drawn from the seed on the card, NumPy batches."""
    inp, st = ctx.config["inputs"], setting(ctx)
    W = synth.weights(model, ctx.seed, ctx.device)
    S = synth.body_tables(ctx.config["smpl"], ctx.device)
    batches = synth.batches(st["distinct"], st["B"], scene_points=inp["scene_points"],
                            img_size=inp["img_size"], seed=ctx.seed + 1, device=ctx.device)
    return W, S, batches


def request_seed(ctx: Ctx, i: int) -> int:
    """The seed of the window's i-th request (map_batches adds i)."""
    return ctx.seed + i


def reference_outputs(ctx: Ctx, W, S, batch, seed: int, control: bool = False) -> Dict:
    """The reference's outputs of one request, [B * S, ...] as NumPy;
    `control`: the reference one precision below the configuration."""
    ref, cfg, st = ctx.reference, ctx.config, setting(ctx)
    ref.exact()
    sched = ref.schedule(cfg["diffusion"]["num_timesteps"], cfg["diffusion"]["schedule"],
                         st["respacing"], ctx.device)
    stats = (torch.zeros(144, device=ctx.device), torch.ones(144, device=ctx.device))
    with torch.no_grad():
        out = ref.sample(W, cfg["model"], S, stats, sched, synth.to_device(batch, ctx.device),
                         seed, st["S"], p=ref.Prec("fp8" if control else ""),
                         q=ref.Prec("tf32" if control else ""))
    return {k: out[k].float().cpu().numpy() for k in NET_KEYS + POSED_KEYS}


def flat(out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Program outputs [B, S, ...] as [B * S, ...]."""
    return {k: v.reshape((-1,) + v.shape[2:]) for k, v in out.items()}


def judge_request(ctx: Ctx, S, batch, out: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers of one request's outputs `out` [B * S, ...] against the
    reference's run `ref`, and their keypoints against the reference's SMPL
    and camera applied to their own pose and betas."""
    r, m = ctx.reference, ctx.config["model"]
    t = {k: torch.from_numpy(out[k]).to(ctx.device) for k in NET_KEYS}
    with torch.no_grad():
        own = r.posed(m, S, r.camera(m, synth.to_device(batch, ctx.device), setting(ctx)["S"]),
                      t["pred_pose_6d"], t["pred_betas"])
    own = {k: v.cpu().numpy() for k, v in own.items()}
    return {**judge.gaps(out, ref, NET_KEYS), **judge.gaps(out, own, POSED_KEYS, "posed.")}


def compare(ctx: Ctx, W, S, batches, kept: List[Tuple[int, Dict]]):
    """The worst readings over the kept requests (index, program outputs
    [B, S, ...])."""
    per = []
    for i, out in kept:
        b = batches[i % len(batches)]
        ref = reference_outputs(ctx, W, S, b, request_seed(ctx, i))
        per.append(judge_request(ctx, S, b, flat(out), ref))
    return judge.worst(per)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx: Ctx) -> Outcome:
    from egohmr_tpu_torch.diffusion import make_schedule
    from egohmr_tpu_torch.models import BodyRepStats, EgoHMR, EgoHMRConfig
    from egohmr_tpu_torch.nn import pointnet_fused as k1
    from egohmr_tpu_torch.serving import Predictor
    from egohmr_tpu_torch.smpl import SMPLModel

    dev, cfgf, st = ctx.device, ctx.config, setting(ctx)
    cfg = EgoHMRConfig(**cfgf["model"])
    with torch.device(dev):
        model = EgoHMR(cfg)
    W, S, batches = inputs(ctx, model)
    model.load_state_dict(W)
    model.eval()
    pred = Predictor(
        model, cfg, SMPLModel(**S),
        BodyRepStats(torch.zeros(144, device=dev), torch.ones(144, device=dev)),
        make_schedule(cfgf["diffusion"]["num_timesteps"], cfgf["diffusion"]["schedule"],
                      st["respacing"]),
        device=dev, batch_size=st["B"], num_samples=st["S"], bf16=st["bf16"],
        max_inflight=st["inflight"], pointnet_impl=st["pointnet_impl"],
        sampler=st["sampler"], with_guidance=False)
    del model
    pred.warmup(batches[0])
    for _ in pred.map_batches(iter(batches[:st["inflight"] + 1]), seed=0):
        pass
    sync(dev)

    submit_w = tr.Stopwatch()
    if ctx.trace:
        submit, result = pred.submit, pred.result

        def timed_submit(*a, **k):
            with tr.span("submit"), submit_w.time():
                return submit(*a, **k)

        def spanned_result(*a, **k):
            with tr.span("result"):
                return result(*a, **k)

        pred.submit, pred.result = timed_submit, spanned_result

    # ------------------------------------------------------------ window
    pulls: List[float] = []
    t0 = time.perf_counter()
    t_end = t0 + ctx.seconds
    setup_s = t0 - ctx.t_start

    def offered():
        i = 0
        while True:
            now = time.perf_counter()
            if now >= t_end:
                return
            pulls.append(now)
            yield batches[i % len(batches)]
            i += 1

    done: List[float] = []
    outs: List[Dict] = []
    for out in pred.map_batches(offered(), seed=ctx.seed):
        done.append(time.perf_counter())
        outs.append(out)
    in_window = [i for i, t in enumerate(done) if t <= t_end]
    lat_ms = [(done[i] - pulls[i]) * 1e3 for i in in_window]
    bodies = sum(outs[i]["pred_betas"].shape[0] * st["S"] for i in in_window)
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"window: {len(pulls)} requests offered, {len(in_window)} completed in "
        f"{ctx.seconds} s; latency p50 {quantile(lat_ms, 0.5):.3f} ms, "
        f"max {max(lat_ms):.3f} ms; set-up {setup_s:.3f} s")

    # ------------------------------------------------------- traced stretch
    reading = Reading(window={"seconds": ctx.seconds, "units": len(in_window),
                                         "bodies": bodies},
                      spans={"submit": submit_w.seconds},
                      counts=ctx.counts.per_request(cfgf, st))
    if ctx.trace:
        n = ctx.traffic["trace_requests"]
        l1 = k1.launches

        def stream():
            for _ in pred.map_batches(iter(batches[i % len(batches)] for i in range(n)),
                                      seed=ctx.seed + 10 ** 6):
                pass
            return n

        reading.trace = tr.profile(stream)
        reading.trace.counters = {"k1_calls": k1.launches - l1}

    # ------------------------------------------------------------- correct
    del pred
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.RandomState(ctx.seed % 2 ** 32)
    n_check = min(ctx.workload["check"]["requests"], len(in_window))
    pick = sorted(rng.choice(in_window, size=n_check, replace=False).tolist())
    t_ref = time.perf_counter()
    worst = compare(ctx, W, S, batches, [(i, outs[i]) for i in pick])
    log(f"reference: {n_check} requests ({pick}) in {time.perf_counter() - t_ref:.3f} s; "
        + ", ".join(f"{k} {v:.6g}" for k, v in sorted(worst.items())))
    checks = judge.held(worst, ctx.workload["check"]["limits"])
    return Outcome(
        end_to_end={"bodies_per_s": (bodies / ctx.seconds, "bodies/s"),
                    "setup_s": (setup_s, "s")},
        attempted=len(pulls), failed=0, checks=checks, memory_peak_bytes=memory_peak,
        reading=reading,
        notes={"requests_in_window": len(in_window), "latency_p50_ms": quantile(lat_ms, 0.5),
               "latency_p95_ms": quantile(lat_ms, 0.95), "checked_requests": pick})


def control(ctx: Ctx) -> Dict[str, Dict[str, float]]:
    """The control's readings at the cell's size, without the program's
    window: the reference one precision below the configuration put in the
    program's place and judged as a run judges, over as many requests as a
    run checks."""
    from egohmr_tpu_torch.models import EgoHMR, EgoHMRConfig

    with torch.device(ctx.device):
        skeleton = EgoHMR(EgoHMRConfig(**ctx.config["model"]))
    W, S, batches = inputs(ctx, skeleton)
    del skeleton
    per = []
    for i in range(ctx.workload["check"]["requests"]):
        b, seed = batches[i % len(batches)], request_seed(ctx, i)
        per.append(judge_request(ctx, S, b, reference_outputs(ctx, W, S, b, seed, control=True),
                                 reference_outputs(ctx, W, S, b, seed)))
    return {"control": judge.worst(per)}
