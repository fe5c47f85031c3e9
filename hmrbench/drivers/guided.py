"""Driver `guided`: stage 2 served through `egohmr_tpu_torch.serving.
Predictor.map_batches` with collision guidance, DDPM, closed loop, on one
card.

The cell's guidance (the configuration's "collision" group, then the
workload's `program.guidance` over it) names the backend: the learned
part-wise signed-distance field ("volsdf": the port's shipped layout, its
weights drawn from the seed) or the mesh SDF ("sdf"), the weight and steps of the
guidance, and the scene points it reads ("all", or the K nearest the
canonical origin). The Predictor returns each guided step's terms with the
outputs (`record_guidance`).

Set-up, the window and the traced stretch are the `predictor` driver's
(`drivers/predictor.py`, whose weights, batches and output comparison this
driver shares), with two differences. The learned field's calibration
(`field_net`) runs the plain reference, so its seconds are kept out of
`setup_s`, as the check's are. And a cell whose workload file names
`memory_peak_mib` reports the peak of tensor memory allocated on the card
from the end of that calibration to the end of the window: the program's
weights, its warm-up and its captured request's pool (the learned field's
chunks), whatever the window adds. A traced run prints per-layer metrics
only, and leaves `memory_peak_mib` out, so that the stage-1 metrics that
move it (read on the flow cell) are not read on a guided run. After the window a sample of its requests, drawn from the
seed, is computed again by the reference in f32 (`reference/
egohmr-volsmpl.py`) and compared: the outputs as the `predictor` driver
compares them, and, from the record of every guided step:
  * `guide.grad.rel`: the program's gradient g_t against the reference's
    at the program's own x_t (and the program's betas), the norm of the
    gap over the reference's norm. For the learned field the reference's
    gradient is float64's, and the gap is taken after the most that the
    field's pieces explain (`tie_gap`): its gradient is piecewise smooth
    (the min over parts, the ReLUs) and small against its terms (|g| ~
    3e-6 a step, most of the inside points in parts the guidance does
    not move), so one scene point on which float32 takes the piece on
    the other side of an edge moves a step's g by up to a few per cent;
    where float64 puts the edge within rounding (`TIE_SDF`, `KINK` in
    the reference), either side is the program's to take;
  * `guide.step.rel`: the step's identity, out - (mu_t + c_t g_t +
    sigma_t z_t) with the program's mu_t and g_t, z_t drawn again from the
    request's seed and c_t, sigma_t worked out again by the reference,
    summed in the order and the float32 rounding the step takes, over the
    norm of c_t g_t: 0 for a step that applies the configured guidance.
    It is exact because c_t g_t is mostly below the output's float32
    resolution (|g| ~ 1e-6 to 4e-3 against |x| ~ 1): a comparison to
    rounding would read the rounding;
each the largest over the guided steps and the compared requests. A request whose record holds another number of
guided steps reads infinity.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from hmrbench.lib import common, field, judge, synth
from hmrbench.lib import trace as tr
from hmrbench.lib.cell import Ctx, Outcome, Reading
from hmrbench.lib.common import log, quantile

_PRED = common.load_file(common.BENCH / "drivers" / "predictor.py")
REFERENCE = common.BENCH / "reference" / "egohmr-volsmpl.py"
RECORD = "guidance_record"


def guide_of(ctx: Ctx) -> Dict:
    """The cell's guidance settings."""
    return dict(ctx.config.get("collision", {}), **ctx.workload["program"].get("guidance", {}))


def guided_steps(ctx: Ctx) -> int:
    """The guided steps of one request: t <= the threshold."""
    return min(guide_of(ctx)["ddpm_threshold"] + 1, ctx.config["diffusion"]["num_timesteps"])


def scene_cap(guide: Dict):
    """The program's `guidance_scene_points`."""
    return None if guide["scene_points"] == "all" else int(guide["scene_points"])


def gcfg_of(guide: Dict) -> Dict:
    return {k: guide[k] for k in ("cond_grad_weight", "ddpm_threshold", "ddpm_fixed_below",
                                  "ddpm_fixed_coeff")}


def field_net(ctx: Ctx, guide: Dict, W, S, batches):
    """(the program's net, its state dict, the calibration's seconds) of a
    learned backend, drawn from the seed on the card (`lib/field.py`),
    calibrated on the bodies the reference samples unguided for the first
    batch at the run's seed, each in its own scene; (None, None, 0.0) for
    the mesh SDF."""
    if guide["backend"] == "sdf":
        return None, None, 0.0
    from egohmr_tpu_torch.collision.neural_occupancy import PartFieldNet
    from egohmr_tpu_torch.collision.neural_sdf import SDFNetConfig

    G = common.load_file(REFERENCE)
    with torch.device(ctx.device):
        net = PartFieldNet(SDFNetConfig(**guide["net"]))
    t0 = time.perf_counter()
    b, n = synth.to_device(batches[0], ctx.device), ctx.traffic["samples_per_image"]
    # the reference's `exact()` turns TF32 off; the program keeps the
    # process's own settings
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        free = reference_request(ctx, W, None, S, batches[0], ctx.seed, guided=False)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    stats = (torch.zeros(144, device=ctx.device), torch.ones(144, device=ctx.device))
    rot = G.pose_rotations(torch.from_numpy(free["pred_pose_6d"]).to(ctx.device), stats)
    Wf = field.field_weights(net, guide["net"], ctx.seed + 2, S, G.canonical_scene(b, n), rot,
                             torch.from_numpy(free["pred_betas"]).to(ctx.device), ctx.device)
    net.load_state_dict(Wf)
    _PRED.sync(ctx.device)
    return net, Wf, time.perf_counter() - t0


def reference_request(ctx: Ctx, W, Wf, S, batch, seed: int, control: bool = False,
                      guided: bool = True) -> Dict:
    """The reference's guided request: outputs [B * S, ...] and its record
    [G, 4, N, 144], as NumPy; `control`: one precision below; `guided`
    False: the request unguided, without a record."""
    G = common.load_file(REFERENCE)
    cfg, guide = ctx.config, guide_of(ctx)
    G.exact()
    sched = G.ddpm_schedule(cfg["diffusion"]["num_timesteps"], cfg["diffusion"]["schedule"],
                            ctx.device)
    stats = (torch.zeros(144, device=ctx.device), torch.ones(144, device=ctx.device))
    with torch.no_grad():
        out = G.sample(W, cfg["model"], S, stats, sched, synth.to_device(batch, ctx.device), seed,
                       ctx.traffic["samples_per_image"], guide if guided else None,
                       gcfg_of(guide), Wf=Wf,
                       p=G.Prec("fp8" if control else ""), q=G.Prec("tf32" if control else ""))
    return {k: v.float().cpu().numpy() for k, v in out.items()
            if k in _PRED.NET_KEYS + _PRED.POSED_KEYS + (RECORD,)}


def tie_gap(r: np.ndarray, alt: np.ndarray, body: np.ndarray) -> float:
    """The norm of the gap r [N, 144] between a program's gradient and the
    reference's, less what the choices a float32 field may make otherwise
    explain: min ||r - sum_k s_k alt[k]|| over s_k in [0, 1], alt[k] [144]
    on the row body[k]; row by row, by bounded least squares."""
    from scipy.optimize import lsq_linear

    r = r.copy()
    for n in np.unique(body):
        cols = alt[body == n].T
        if np.any(cols):
            fit = lsq_linear(cols, r[n], bounds=(0.0, 1.0), method="bvls")
            r[n] -= cols @ fit.x
    return float(np.linalg.norm(r))


def judge_record(ctx: Ctx, Wf, S, batch, seed: int, record: np.ndarray,
                 betas: np.ndarray) -> Dict[str, float]:
    """The record's numbers (see the module's docstring): `record` [G, 4,
    N, 144] of the bodies of betas [N, 10]."""
    G = common.load_file(REFERENCE)
    cfg, guide = ctx.config, guide_of(ctx)
    steps = guided_steps(ctx)
    if record is None or record.shape[0] != steps or not np.all(np.isfinite(record)):
        return {"guide.grad.rel": math.inf, "guide.step.rel": math.inf}
    dev = ctx.device
    T = cfg["diffusion"]["num_timesteps"]
    sched = G.ddpm_schedule(T, cfg["diffusion"]["schedule"], dev)
    stats = (torch.zeros(144, device=dev), torch.ones(144, device=dev))
    rec = torch.from_numpy(record).to(dev)
    N = rec.shape[2]
    g_ref = G.guidance_ties(guide, S, stats,
                            G.canonical_scene(synth.to_device(batch, ctx.device),
                                              ctx.traffic["samples_per_image"]),
                            torch.from_numpy(betas).to(dev), N, Wf)
    _, z = G.draws(seed, N, T, dev)
    grad_rel = step_rel = 0.0
    for j in range(steps):
        t = steps - 1 - j
        x, mu, g, out = rec[j]
        want, alt, what = (v.cpu().double().numpy() for v in g_ref(x))
        gap = tie_gap(g.cpu().double().numpy() - want, alt, what[:, 0].astype(np.int64))
        grad_rel = max(grad_rel, gap / max(float(np.linalg.norm(want)), 1e-30))
        # the step as the program's float32 arithmetic takes it, term by term
        cg = G.guide_coeff(sched, gcfg_of(guide), t) * g
        step = mu + cg
        if t > 0:
            step = step + G.sigma(sched, t) * z[T - 1 - t]
        gap = float((out - step).norm())
        step_rel = max(step_rel, gap / max(float(cg.norm()), 1e-30) if gap else 0.0)
    return {"guide.grad.rel": grad_rel, "guide.step.rel": step_rel}


def judge_guided(ctx: Ctx, Wf, S, batch, seed: int, out: Dict, ref: Dict) -> Dict[str, float]:
    """All numbers of one request: outputs `out` (program or control, [B *
    S, ...], with its record [G, 4, N, 144] or none) against the
    reference's `ref`."""
    nums = _PRED.judge_request(ctx, S, batch, out, ref)
    nums.update(judge_record(ctx, Wf, S, batch, seed, out.get(RECORD),
                             out["pred_betas"].reshape(-1, out["pred_betas"].shape[-1])))
    return nums


def program_record(out: Dict) -> Dict:
    """Program outputs [B, S, ...] as [B * S, ...], the record [B, S, G, 4,
    144] as [G, 4, B * S, 144]."""
    rec = out.get(RECORD)
    flat = _PRED.flat({k: v for k, v in out.items() if k != RECORD})
    if rec is not None:
        flat[RECORD] = np.ascontiguousarray(
            rec.reshape((rec.shape[0] * rec.shape[1],) + rec.shape[2:]).transpose(1, 2, 0, 3))
    return flat


def compare(ctx: Ctx, W, Wf, S, batches, kept: List[Tuple[int, Dict]]):
    per = []
    for i, out in kept:
        b, seed = batches[i % len(batches)], _PRED.request_seed(ctx, i)
        ref = reference_request(ctx, W, Wf, S, b, seed)
        per.append(judge_guided(ctx, Wf, S, b, seed, program_record(out), ref))
    return judge.worst(per)


def run(ctx: Ctx) -> Outcome:
    from egohmr_tpu_torch.diffusion import GuidanceConfig, make_schedule
    from egohmr_tpu_torch.models import BodyRepStats, EgoHMR, EgoHMRConfig
    from egohmr_tpu_torch.nn import pointnet_fused as k1
    from egohmr_tpu_torch.serving import Predictor
    from egohmr_tpu_torch.smpl import SMPLModel

    dev, cfgf, st, guide = ctx.device, ctx.config, _PRED.setting(ctx), guide_of(ctx)
    cfg = EgoHMRConfig(**cfgf["model"])
    with torch.device(dev):
        model = EgoHMR(cfg)
    W, S, batches = _PRED.inputs(ctx, model)
    model.load_state_dict(W)
    model.eval()
    net, Wf, calibration_s = field_net(ctx, guide, W, S, batches)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    pred = Predictor(
        model, cfg, SMPLModel(**S),
        BodyRepStats(torch.zeros(144, device=dev), torch.ones(144, device=dev)),
        make_schedule(cfgf["diffusion"]["num_timesteps"], cfgf["diffusion"]["schedule"], ""),
        device=dev, batch_size=st["B"], num_samples=st["S"], bf16=st["bf16"],
        max_inflight=st["inflight"], pointnet_impl=st["pointnet_impl"], sampler="ddpm",
        with_guidance=True, guidance=GuidanceConfig(**gcfg_of(guide)),
        collision_backend=guide["backend"], collision_net=net,
        guidance_scene_points=scene_cap(guide), record_guidance=True)
    del model
    pred.warmup(batches[0])
    for _ in pred.map_batches(iter(batches[:st["inflight"] + 1]), seed=0):
        pass
    _PRED.sync(dev)

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
    setup_s = t0 - ctx.t_start - calibration_s

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
    steps = guided_steps(ctx)
    points = cfgf["inputs"]["scene_points"] if scene_cap(guide) is None else \
        min(scene_cap(guide), cfgf["inputs"]["scene_points"])
    # the denoiser's work per step is DDPM's and DDIM's alike: a T-step chain
    # counts as "ddim<T>" in the configurations' count files
    counted = dict(st, respacing=f"ddim{cfgf['diffusion']['num_timesteps']}",
                   guided_steps=steps, guide_points=points)
    reading = Reading(window={"seconds": ctx.seconds, "units": len(in_window),
                              "bodies": bodies},
                      spans={"submit": submit_w.seconds},
                      counts=ctx.counts.per_request(cfgf, counted))
    if ctx.trace:
        n = ctx.traffic["trace_requests"]
        before = (k1.launches, pred.guided_steps, pred.field_rows)

        def stream():
            for _ in pred.map_batches(iter(batches[i % len(batches)] for i in range(n)),
                                      seed=ctx.seed + 10 ** 6):
                pass
            return n

        reading.trace = tr.profile(stream)
        after = (k1.launches, pred.guided_steps, pred.field_rows)
        reading.trace.counters = dict(zip(("k1_calls", "guided_steps", "field_rows"),
                                          (a - b for a, b in zip(after, before))))

    # ------------------------------------------------------------- correct
    del pred
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.RandomState(ctx.seed % 2 ** 32)
    n_check = min(ctx.workload["check"]["requests"], len(in_window))
    pick = sorted(rng.choice(in_window, size=n_check, replace=False).tolist())
    t_ref = time.perf_counter()
    worst = compare(ctx, W, Wf, S, batches, [(i, outs[i]) for i in pick])
    log(f"reference: {n_check} requests ({pick}) in {time.perf_counter() - t_ref:.3f} s; "
        + ", ".join(f"{k} {v:.6g}" for k, v in sorted(worst.items())))
    checks = judge.held(worst, ctx.workload["check"]["limits"])
    end_to_end = {"bodies_per_s": (bodies / ctx.seconds, "bodies/s"), "setup_s": (setup_s, "s")}
    if not ctx.trace:
        end_to_end["memory_peak_mib"] = (memory_peak / 2 ** 20, "MiB")
    return Outcome(
        end_to_end=end_to_end,
        attempted=len(pulls), failed=0, checks=checks, memory_peak_bytes=memory_peak,
        reading=reading,
        notes={"requests_in_window": len(in_window), "latency_p50_ms": quantile(lat_ms, 0.5),
               "latency_p95_ms": quantile(lat_ms, 0.95), "checked_requests": pick,
               "calibration_s": calibration_s})


def control(ctx: Ctx) -> Dict[str, Dict[str, float]]:
    """The control's readings at the cell's size, without the program's
    window: the reference one precision below the configuration (the
    conditioning and the denoiser in float8, SMPL and the field in TF32)
    put in the program's place, its own record judged as a run judges the
    program's, over as many requests as a run checks."""
    from egohmr_tpu_torch.models import EgoHMR, EgoHMRConfig

    with torch.device(ctx.device):
        skeleton = EgoHMR(EgoHMRConfig(**ctx.config["model"]))
    W, S, batches = _PRED.inputs(ctx, skeleton)
    del skeleton
    _, Wf, _ = field_net(ctx, guide_of(ctx), W, S, batches)
    per = []
    for i in range(ctx.workload["check"]["requests"]):
        b, seed = batches[i % len(batches)], _PRED.request_seed(ctx, i)
        out = reference_request(ctx, W, Wf, S, b, seed, control=True)
        per.append(judge_guided(ctx, Wf, S, b, seed, out,
                                reference_request(ctx, W, Wf, S, b, seed)))
    return {"control": judge.worst(per)}
