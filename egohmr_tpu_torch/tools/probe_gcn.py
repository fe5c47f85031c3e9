"""The GCN denoiser by itself, by variant: the port of the JAX package's
`tools/probe_gcn.py`, with its flags, variants, parity gate and printed
JSON.

    python -m egohmr_tpu_torch.tools.probe_gcn [--batch 128] [--reps 15]
        [--n1 10] [--n2 60] [--quick] [--device cuda | --cpu]

One call of the denoiser, `EgoHMRConfig()`'s GCN (4 residual blocks at
H=1024 over 24 joints) in bf16, at the fuse-doubled batch (64 images x
cond/uncond = 128), with the input layer's projections given:

  full       `nn/gcn.py:modulated_gcn_forward(input_h=)`'s plain path:
             each graph convolution's modulation, adjacency mix, bias,
             BatchNorm, ReLU and residual add as separate PyTorch ops;
  fused      `modulated_gcn_forward(input_h=)` as a sampling step runs it:
             on the card in bf16 each BatchNorm'd graph convolution's glue
             is one kernel (`nn/gconv_epilogue.py`); elsewhere the plain
             path;
  skeleton   the same hidden [B*24, H] x [H, H] products and ReLUs alone, no
             adjacency mix, modulation or BatchNorm: not the same function,
             a floor (full - skeleton = the price of the glue);
  wcat       `full`'s function with each graph convolution's two weight
             products (x @ W[0], x @ W[1]) issued as one product with the
             concatenated [H, 2H] weight, through `modulated_gconv_mix`;
  wcat_skel  the concatenated-weight skeleton, the floor for `wcat`.

The parity gate: `wcat` and `fused` equal `full` at rtol/atol 2e-2 (the
[H, 2H] product may round bf16 differently; the kernel rounds once where
the plain path rounds after every op).

Times: chains of calls with a data dependence (each call's inputs shifted by
1e-12 x the sum of the last output), a synchronize at the end of a chain,
chain-length differencing (t(n2) - t(n1)) / (n2 - n1) with the minimum of
--reps chains of each length taken separately, on the host clock and by
CUDA events. Eager chains run at the host's pace when the host bounds, so
`torch.profiler` also reads, over n1 calls of each variant alone, its
kernels' device time and kernel launches per call. `roofline_ms` is the
card's: the hidden layers' 16 x 2 x (B*24) x H x H flops (4 blocks) at
the H100's 989 TFLOP/s dense bf16 peak (0.104 ms at B=128). On the CPU
(--cpu, a smoke test) the device columns read null. Prints one JSON
line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import bench
from ..models.egohmr import _adjacency
from ..nn import cast_params_bf16
from ..nn.core import batchnorm_eval
from ..nn.gcn import modulated_gcn_forward, modulated_gconv_mix
from ..utils.device import resolve_device

PEAK_BF16 = 989e12  # the H100 SXM's dense bf16 tensor-core rate, flop/s


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m egohmr_tpu_torch.tools.probe_gcn",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128,
                    help="fuse-doubled batch (headline B=64 cond/uncond)")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--n1", type=int, default=10)
    ap.add_argument("--n2", type=int, default=60)
    ap.add_argument("--quick", action="store_true", help="tiny widths (smoke test)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (fails without a card) or 'cpu'")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    return ap


def variants(gcn, adj):
    """{name: fn(a, b)} over the bf16 GCN `gcn` and the adjacency `adj`."""
    relu = torch.relu
    layers = [(blk.gconv1, blk.gconv2) for blk in gcn.gconv_layers]
    # each gconv's W pair concatenated: [in, H] | [in, H] -> [in, 2H]
    wcat = {id(gc): torch.cat([gc.W[0], gc.W[1]], dim=-1)
            for gc in [g.gconv for pair in layers for g in pair] + [gcn.gconv_output]}

    def two_products(gc, x):
        return x @ gc.W[0], x @ gc.W[1]

    def one_product(gc, x):
        h = x @ wcat[id(gc)]
        d = gc.W.shape[-1]
        return h[..., :d], h[..., d:]

    def plain(products):
        """The plain path, each graph convolution's (x @ W[0], x @ W[1])
        issued by `products(gconv, x)`."""
        def fn(a, b):
            gi = gcn.gconv_input[0]
            out = relu(batchnorm_eval(gi.bn, modulated_gconv_mix(gi.gconv, adj, a, b), -1))
            for pair in layers:
                res = out
                for g in pair:
                    mix = modulated_gconv_mix(g.gconv, adj, *products(g.gconv, out))
                    out = relu(batchnorm_eval(g.bn, mix, -1))
                out = res + out
            return modulated_gconv_mix(gcn.gconv_output, adj, *products(gcn.gconv_output, out))
        return fn

    def fused(a, b):
        return modulated_gcn_forward(gcn, adj, None, input_h=(a, b))

    def skeleton(a, b):
        # the hidden layers' products alone; the input mix is an add
        out = relu(a + b)
        for pair in layers:
            res = out
            for g in pair:
                W = g.gconv.W
                out = relu(out @ W[0] + out @ W[1])
            out = res + out
        Wo = gcn.gconv_output.W
        return out @ Wo[0] + out @ Wo[1]

    def wcat_skel(a, b):
        out = relu(a + b)
        for pair in layers:
            res = out
            for g in pair:
                h = out @ wcat[id(g.gconv)]
                d = h.shape[-1] // 2
                out = relu(h[..., :d] + h[..., d:])
            out = res + out
        h = out @ wcat[id(gcn.gconv_output)]
        d = h.shape[-1] // 2
        return h[..., :d] + h[..., d:]

    return {"full": plain(two_products), "fused": fused, "skeleton": skeleton,
            "wcat": plain(one_product), "wcat_skel": wcat_skel}


def profile_calls(fn, a, b, n: int, device: torch.device) -> dict:
    """Kernel launches and kernel device time per call over n calls of
    `fn`, from `torch.profiler`; nulls on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return {"kernel_ms_per_call": None, "launches_per_call": None}
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(a, b)
        torch.cuda.synchronize(device)
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"kernel_ms_per_call": sum(e.self_device_time_total for e in events) / 1e3 / n,
            "launches_per_call": sum(e.count for e in events) / n}


@torch.no_grad()
def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else args.device)
    cuda = dev.type == "cuda"

    cfg = bench.model_config(args.quick)
    gcn = cast_params_bf16(bench.random_model(cfg, torch.device("cpu"))).diffusion_model.to(dev)
    adj = _adjacency(dev)
    B, J, H = args.batch, 24, cfg.gcn_hid_dim
    g = torch.Generator().manual_seed(1)
    h0, h1 = (torch.randn(B, J, H, generator=g).to(dev, torch.bfloat16) for _ in range(2))
    fns = variants(gcn, adj)

    # the parity gate: wcat and fused are full's function
    o_full = fns["full"](h0, h1).float().cpu().numpy()
    diffs = {}
    for k in ("wcat", "fused"):
        o = fns[k](h0, h1).float().cpu().numpy()
        diffs[k] = float(np.abs(o_full - o).max())
        np.testing.assert_allclose(o, o_full, rtol=2e-2, atol=2e-2)
        print(f"# parity: {k} == full (max abs diff {diffs[k]:.2e})", file=sys.stderr)

    def time_variant(name, fn):
        def chain(n):
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else None
            t0 = time.perf_counter()
            if cuda:
                events[0].record()
            carry = torch.zeros((), dtype=torch.bfloat16, device=dev)
            for _ in range(n):
                o = fn(h0 + carry, h1 + carry)
                carry = (o.sum() * 1e-12).to(torch.bfloat16)
            if cuda:
                events[1].record()
                torch.cuda.synchronize(dev)
            else:
                carry.item()
            return (time.perf_counter() - t0,
                    events[0].elapsed_time(events[1]) if cuda else None)

        t0 = time.perf_counter()
        chain(args.n1)
        first_s = time.perf_counter() - t0
        # the min of EACH chain length separately, then the difference: a
        # min over per-pair differences picks anti-correlated noise
        r1 = [chain(args.n1) for _ in range(args.reps)]
        r2 = [chain(args.n2) for _ in range(args.reps)]
        ms = (min(h for h, _ in r2) - min(h for h, _ in r1)) / (args.n2 - args.n1) * 1e3
        event_ms = ((min(e for _, e in r2) - min(e for _, e in r1)) / (args.n2 - args.n1)
                    if cuda else None)
        prof = profile_calls(fn, h0, h1, args.n1, dev)
        bench._log(f"{name}: {ms:.3f} ms/call, events {event_ms} ms/call, kernels "
                   f"{prof['kernel_ms_per_call']} ms and {prof['launches_per_call']} launches "
                   f"a call (first chain {first_s:.1f}s)")
        return ms, event_ms, prof

    results, event_ms, profiled = {}, {}, {}
    for name, fn in fns.items():
        results[name], event_ms[name], profiled[name] = time_variant(name, fn)
    flops = 4 * cfg.gcn_layers * 2.0 * B * J * H * H  # two gconvs of two products a block
    print(json.dumps({
        "metric": "gcn_denoiser_ms_per_call_by_variant",
        "batch_fused": B,
        "results": {k: round(v, 3) for k, v in results.items()},
        "event_ms": event_ms,
        "kernel_ms": {k: v["kernel_ms_per_call"] for k, v in profiled.items()},
        "launches_per_call": {k: v["launches_per_call"] for k, v in profiled.items()},
        "roofline_ms": flops / PEAK_BF16 * 1e3,
        "parity_max_abs_diff": diffs["wcat"],
        "fused_max_abs_diff": diffs["fused"],
        "device": bench.device_name(dev),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
