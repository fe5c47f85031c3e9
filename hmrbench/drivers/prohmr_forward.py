"""Driver `prohmr_forward`: stage 1 (ProHMR-scene) as the evaluation CLI's
`run_batch` runs it, closed loop, one batch at a time, on one card.

Set-up makes the weights on the card from the seed, places the model as
`eval/test_prohmr.py` places it (channels_last, eval, the scene encoder
as the cell states), makes the traffic's distinct NumPy batches and warms
the one shape. A request is one batch: moved to the card by the CLI's
upload helper (`data.egobody.to_device_batch`), `models.prohmr.forward`
with the mode and `samples_per_image - 1` draws from the request's
generator, and its outputs read back to host memory; it is timed from
when the loop takes the batch to when the outputs are on the host. After
the window a sample of its requests, drawn from the seed, is judged
against the reference in f32, stage by stage: the program's context
against the reference's, the program's bodies against the reference's
flow, head, SMPL and camera run on the program's own context, and the
program's keypoints against the reference's SMPL and camera applied to
the program's own pose, betas and crop camera. The whole run is compared
too (logged).
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from hmrbench.lib import judge, synth
from hmrbench.lib import trace as tr
from hmrbench.lib.cell import Ctx, Outcome, Reading
from hmrbench.lib.common import host_counters, host_counters_since, log, quantile



def setting(ctx: Ctx) -> Dict:
    t = ctx.traffic
    return {"B": t["images_per_request"], "S": t["samples_per_image"],
            "distinct": t["distinct_batches"],
            "pointnet_impl": ctx.workload["program"]["pointnet_impl"]}


def flow_rules(model) -> list:
    """The rules that differ from the module kinds' (egohmr_tpu_torch/
    models/prohmr.py:init_random_ and flow/glow.py:init_glow_): the last
    layer of each coupling net and of each of its blocks U(+-1e-3), as
    nflows zero-initialises them, so that each step's scale stays near
    sigmoid(2) and the flow's inverse stays well conditioned under the
    random backbone's large features, and the head's last layer
    Xavier-uniform with gain 0.02, so that the crop camera stays near its
    init (0.9, 0, 0)."""
    rules = [(k, "u", 1e-3, 0.0) for k in model.state_dict()
             if ".linear_layers.1." in k or ".final_layer." in k]
    out_f, in_f = model.flow.fc_head.layers[2].weight.shape
    return rules + [("flow.fc_head.layers.2.weight", "u", 0.02 * (6.0 / (in_f + out_f)) ** 0.5,
                     0.0)]


def inputs(ctx: Ctx, model: torch.nn.Module):
    inp, st = ctx.config["inputs"], setting(ctx)
    W = synth.weights(model, ctx.seed, ctx.device, extra_rules=flow_rules(model))
    S = synth.body_tables(ctx.config["smpl"], ctx.device)
    batches = synth.batches(st["distinct"], st["B"], scene_points=inp["scene_points"],
                            img_size=inp["img_size"], seed=ctx.seed + 1, device=ctx.device)
    return W, S, batches


def request_seed(ctx: Ctx, i: int) -> int:
    return ctx.seed + i


def numpy(out: Dict) -> Dict[str, np.ndarray]:
    return {k: v.float().cpu().numpy() for k, v in out.items()}


def reference_outputs(ctx: Ctx, W, S, batch, seed: int, control: bool = False) -> Dict:
    """The reference's outputs of one batch, [B, S, ...], and its `context`
    [B, C], as NumPy; `control`: each part one precision below what the
    program runs it in."""
    ref = ctx.reference
    ref.exact()
    with torch.no_grad():
        out = ref.forward(W, ctx.config["model"], S, synth.to_device(batch, ctx.device), seed,
                          setting(ctx)["S"], p=ref.CONTROL if control else ref.EXACT)
    return numpy(out)


def judge_request(ctx: Ctx, W, S, batch, seed: int, out: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers of one batch's outputs `out` (with its `context`)
    against the reference's run `ref`: the context's camera and box, image
    and scene features (`context.`); the bodies against the reference's flow, head,
    SMPL and camera run on `out`'s own context (`flow.`); the keypoints
    against the reference's SMPL and camera applied to `out`'s own pose,
    betas and crop camera (`posed.`); the whole run (no prefix)."""
    r, m = ctx.reference, ctx.config["model"]
    st = setting(ctx)
    b = synth.to_device(batch, ctx.device)
    t = {k: torch.from_numpy(v).to(ctx.device) for k, v in out.items()}
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in t.items() if k != "context"}
    with torch.no_grad():
        stage = numpy(r.flow(W, m, S, b, t["context"], seed, st["S"]))
        own = r.posed(m, S, b, flat["pred_pose_6d"], flat["pred_betas"], flat["pred_cam"],
                      st["S"])
    own = {k: v.reshape(out[k].shape).cpu().numpy() for k, v in own.items()}
    parts = r.context_parts(m)

    def split(c):
        return {k: c[:, cols] for k, cols in parts.items()}

    return {**judge.gaps(split(out["context"]), split(ref["context"]), tuple(parts),
                         "context."),
            **judge.gaps(out, stage, r.NET_KEYS, "flow."),
            **judge.gaps(out, own, r.POSED_KEYS, "posed."),
            **judge.gaps(out, ref, r.NET_KEYS)}


def compare(ctx: Ctx, W, S, batches, kept):
    per = []
    for i, out in kept:
        b, seed = batches[i % len(batches)], request_seed(ctx, i)
        per.append(judge_request(ctx, W, S, b, seed, out,
                                 reference_outputs(ctx, W, S, b, seed)))
    return judge.worst(per)


def build(ctx: Ctx):
    from egohmr_tpu_torch.models.prohmr import ProHMR, ProHMRConfig

    cfg = ProHMRConfig(**ctx.config["model"], pointnet_impl=setting(ctx)["pointnet_impl"])
    with torch.device(ctx.device):
        model = ProHMR(cfg)
    return cfg, model


def run(ctx: Ctx) -> Outcome:
    from egohmr_tpu_torch.data.egobody import to_device_batch
    from egohmr_tpu_torch.models.prohmr import forward
    from egohmr_tpu_torch.nn import pointnet_fused as k1
    from egohmr_tpu_torch.smpl import SMPLModel

    dev, st = ctx.device, setting(ctx)
    cuda = dev.type == "cuda"
    cfg, model = build(ctx)
    W, S, batches = inputs(ctx, model)
    model.load_state_dict(W)
    model = model.to(dev, memory_format=torch.channels_last).eval()
    smpl = SMPLModel(**S)
    # the outputs, and the context the flow was run on (judged stage by stage)
    keys = ctx.reference.OUTPUT_KEYS + ("conditioning_feats",)

    def request(i: int) -> Dict[str, np.ndarray]:
        with tr.span("upload"):
            batch = to_device_batch(batches[i % len(batches)], dev)
        gen = torch.Generator(device=dev).manual_seed(request_seed(ctx, i))
        with torch.no_grad(), tr.span("forward"):
            out = forward(model, cfg, smpl, batch, st["S"], generator=gen)
        with tr.span("readback"):
            host = {k: getattr(out, k).float().cpu().numpy() for k in keys}
        host["context"] = host.pop("conditioning_feats")
        return host

    for i in range(2):  # the shape's kernels, K1's weights, cuDNN's choice
        request(10 ** 6 + i)
    if cuda:
        torch.cuda.synchronize(dev)

    # ------------------------------------------------------------ window
    # the window's own peak: set-up's (the weights' flat draws) is apart
    setup_peak = resident = 0
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(dev)
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    host0 = host_counters()
    t0 = time.perf_counter()
    t_end = t0 + ctx.seconds
    setup_s = t0 - ctx.t_start
    lat_ms: List[float] = []
    outs: List[Dict] = []
    while True:
        t = time.perf_counter()
        if t >= t_end:
            break
        outs.append(request(len(outs)))
        done = time.perf_counter()
        if done <= t_end:
            lat_ms.append((done - t) * 1e3)
    host = host_counters_since(host0)
    in_window = list(range(len(lat_ms)))
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    memory_peak = max(setup_peak, window_peak)
    bodies = len(in_window) * st["B"] * st["S"]
    log(f"window: {len(outs)} requests, {len(in_window)} completed in {ctx.seconds} s; "
        f"latency p50 {quantile(lat_ms, 0.5):.3f} ms, max {max(lat_ms):.3f} ms; "
        f"set-up {setup_s:.3f} s")

    reading = Reading(window={"seconds": ctx.seconds, "units": len(in_window),
                              "bodies": bodies, "resident_bytes": resident,
                              "peak_bytes": window_peak}, spans={},
                      counts=ctx.counts.per_request(ctx.config, st))
    if ctx.trace:
        n = ctx.traffic["trace_requests"]
        l1 = k1.launches

        def stream():
            for i in range(n):
                request(10 ** 7 + i)
            return n

        reading.trace = tr.profile(stream)
        reading.trace.counters = {"k1_calls": k1.launches - l1}

    # ------------------------------------------------------------- correct
    del model
    gc.collect()
    if cuda:
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
                    "memory_peak_mib": (window_peak / 2 ** 20, "MiB"),
                    "setup_s": (setup_s, "s")},
        attempted=len(outs), failed=0, checks=checks, memory_peak_bytes=memory_peak,
        reading=reading,
        notes={"requests_in_window": len(in_window), "latency_p50_ms": quantile(lat_ms, 0.5),
               "latency_p95_ms": quantile(lat_ms, 0.95), "checked_requests": pick, "host": host,
               "torch_threads": torch.get_num_threads(), "setup_peak_bytes": setup_peak,
               "window_peak_bytes": window_peak, "resident_bytes": resident})


def control(ctx: Ctx) -> Dict[str, Dict[str, float]]:
    """The control's readings at the cell's size: the reference with each
    part one precision below what the program runs it in, put in the
    program's place and judged as a run judges, over as many batches as a
    run checks."""
    _, model = build(ctx)
    W, S, batches = inputs(ctx, model)
    del model
    per = []
    for i in range(ctx.workload["check"]["requests"]):
        b, seed = batches[i % len(batches)], request_seed(ctx, i)
        per.append(judge_request(ctx, W, S, b, seed,
                                 reference_outputs(ctx, W, S, b, seed, control=True),
                                 reference_outputs(ctx, W, S, b, seed)))
    return {"control": judge.worst(per)}
