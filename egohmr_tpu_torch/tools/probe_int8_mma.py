"""Kernel K3: is int8 worth it for the fused PointNet kernel on an H100?

Port of tools/probe_int8_mxu.py. Six variants of one experiment: G
independent chains of R chained [2048, 256] x [256, 256] products with the
accumulator carried, then the max over the rows, out [G, 1, 256]:

  A  bf16          acc += (x + bf16(i % 2)) @ w, f32 accumulate: the rate
                   the fused PointNet's products can reach.
  A1 bf16_bare     the same without the perturbation.
  B  int8          pre-quantised int8 operands, int32 accumulate, the
                   operand perturbed by int8(i % 2) (which wraps: 127 + 1 is
                   -128, here as in the original).
  B1 int8_bare     no perturbation.
  B2 int8_slice    the operand alternates between the two halves of a
                   [2M, K] array: a different operand per step at no cost.
  C  int8_glue     per step, per-row dynamic quantisation of the f32
                   activation (max-abs -> scale -> round half to even ->
                   int8), int8 product, f32 dequantisation (row scale x
                   column scale), x 0.0625 and clip to +-2, fed back: the
                   cost of a product inside a quantised PointNet stage.

On a CUDA tensor a variant runs in the hand-written Hopper kernel of
`csrc/probe_mma.cu` (`wgmma` tensor-core products, B and, for the variants
whose operand does not change, A read from shared memory by descriptor; no
library product inside); on a CPU tensor in `plain`, a PyTorch loop over R
that the tests and `--cpu` use and that the probe on the card never calls.
The glue variant's kernel takes w with its k index permuted within each
32-wide block (`glue_k_order`), so that the quantised activation goes from
the accumulator's registers into the next product's without a shuffle.

Measurement rule: the R loop is inside the kernel with a data dependence
between steps; R is a run-time argument, so one build serves both chain
lengths; each variant is timed with CUDA events at R1 and R2, interleaved,
the minimum per chain length is taken and then the difference:
per-product time = (t(R2) - t(R1)) / (G * (R2 - R1)). The card runs the
chains' CTAs side by side, so this is the card's aggregate time per
product. `--grid` is G, the number of chains: at the default 32 the kernel
runs 32 x 2048 / 128 = 512 CTAs, one per SM at a time, 3.9 waves over the
132 SMs of an H100. One product is 2 * 2048 * 256 * 256 = 268.4 MFLOP:
0.271 us at the 989 TFLOP/s bf16 peak, 0.136 us at the 1,979 TOPS int8
peak. Those peaks assume the 1,830 MHz clock of NVIDIA's data sheet; the
card may run its SMs up to 1,980 MHz, so a reading may pass its peak by up
to 8.2%, and only one above that is a fault of the measurement and
raises. A variant whose time does not grow with R is reported as
"hoisted", not as a rate.

What it says on an NVIDIA H100 80GB HBM3 at 700 W (per product, G=32):
bf16 0.29 us, int8 0.14-0.15 us, int8 with the glue 0.45 us. int8 is 2.0x
bf16 when the operands arrive quantised (`int8_speedup_pure`), and 0.63x
bf16 when each product quantises its f32 input per row and dequantises its
output (`int8_speedup_with_glue`): the glue's 12 instructions an element on
the CUDA cores cost more than the product they feed. A stage of the fused
PointNet that quantised its activations per step would be slower than the
bf16 stage, so it stays bf16.

    python3 -m egohmr_tpu_torch.tools.probe_int8_mma [--grid 32 --r1 32
        --r2 160 --reps 12 --variants A,B --cpu]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import time
from typing import Dict, Tuple

import numpy as np
import torch

M, K, N = 2048, 256, 256
PEAK_BF16, PEAK_INT8 = 989e12, 1979e12  # H100 SXM, dense, at 1,830 MHz
# the most a reading can exceed its peak: the H100 SXM's highest SM clock
# over the one the published peaks assume
CLOCK_HEADROOM = 1980 / 1830
VARIANTS = ("A_bf16", "A1_bf16_bare", "B_int8", "B1_int8_bare",
            "B2_int8_slice", "C_int8_glue")
INT8_VARIANTS = VARIANTS[2:]
# one int8 product adds at most 256 * 128 * 127 = 4.2e6 to an int32 sum
MAX_R_INT8 = 500

# K3 launches on the card since the count was last set to 0 (one per `run`
# call on CUDA tensors)
launches = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load("probe_mma")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.k3_probe.argtypes = [i, vp, vp, vp, i, i, i, vp, vp, vp]
        for f in (lib.k3_probe, lib.k3_rows_per_cta, lib.k3_depth, lib.k3_width):
            f.restype = i
        lib.k3_error_string.argtypes = [i]
        lib.k3_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def glue_k_order(k: int) -> torch.Tensor:
    """The k order of the glue variant's weights: position p of each 32-wide
    block of the kernel's w^T [n][k] holds source k = order[p].

    A thread of the kernel holds, of each 32-wide k-block of a row, the
    accumulator's columns 8j + 2t + {0, 1}, j = 0..3 (t = lane % 4), and
    the int8 A fragment it feeds to the next product wants k = 4t + b and
    16 + 4t + b, b = 0..3. Byte b of the fragment's register h (h = 0, 1:
    the low and high 16 of the block) is column 8 (2h + b // 2) + 2t + b % 2
    of the accumulator; this is that column for every fragment position.
    A permutation within k leaves an integer product unchanged."""
    if k % 32:
        raise ValueError(f"k must be a multiple of 32, got {k}")
    p = torch.arange(k)
    r = p % 32
    half, t, b = r // 16, (r % 16) // 4, r % 4
    return p - r + 8 * (2 * half + b // 2) + 2 * t + b % 2


def permute_glue_k(wt: torch.Tensor) -> torch.Tensor:
    """w^T [n][k] -> the same with k in `glue_k_order`."""
    return wt[:, glue_k_order(wt.shape[1]).to(wt.device)].contiguous()


def flop() -> int:
    """Operations of one [M, K] x [K, N] product."""
    return 2 * M * K * N


def make_inputs(seed: int = 0, device="cpu") -> Dict[str, Tuple[torch.Tensor, ...]]:
    """The operands of every variant, from a NumPy seed: x and w standard
    normal; xq, wq = round(clip(. * 30, +-127)) as int8; sw the per-column
    max-abs of w over 127; xq2 = [xq; xq flipped along the rows]."""
    rng = np.random.RandomState(seed)
    xf = rng.randn(M, K).astype(np.float32)
    wf = rng.randn(K, N).astype(np.float32)
    xq = np.round(np.clip(xf * 30, -127, 127)).astype(np.int8)
    wq = np.round(np.clip(wf * 30, -127, 127)).astype(np.int8)
    sw = (np.abs(wf).max(axis=0, keepdims=True) / np.float32(127.0)).astype(np.float32)
    xq2 = np.concatenate([xq, xq[::-1]], axis=0)

    def t(a, dtype=None):
        out = torch.tensor(np.ascontiguousarray(a)).to(device)  # copies
        return out if dtype is None else out.to(dtype)

    bf = torch.bfloat16
    return {
        "A_bf16": (t(xf, bf), t(wf, bf)),
        "A1_bf16_bare": (t(xf, bf), t(wf, bf)),
        "B_int8": (t(xq), t(wq)),
        "B1_int8_bare": (t(xq), t(wq)),
        "B2_int8_slice": (t(xq2), t(wq)),
        "C_int8_glue": (t(xf), t(wq), t(sw)),
    }


def _int_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 product as int64: float64 holds every partial sum
    (at most 256 * 128 * 127) exactly, on the CPU and on the card."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int64)


def _check(name: str, r: int, grid: int, ops) -> None:
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; one of {VARIANTS}")
    if r < 0 or grid < 1:
        raise ValueError(f"need r >= 0 and grid >= 1, got r={r}, grid={grid}")
    if name in INT8_VARIANTS and name != "C_int8_glue" and r > MAX_R_INT8:
        raise ValueError(f"{name}: r={r} could overflow the int32 accumulator "
                         f"(limit {MAX_R_INT8})")
    want = {"A": (torch.bfloat16, torch.bfloat16), "B": (torch.int8, torch.int8),
            "C": (torch.float32, torch.int8, torch.float32)}[name[0]]
    if len(ops) != len(want) or any(o.dtype != d for o, d in zip(ops, want)):
        raise ValueError(f"{name} takes operands of {want}, got "
                         f"{[o.dtype for o in ops]}")
    x, w = ops[0], ops[1]
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x [M, K] and w [K, N] expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if name == "B2_int8_slice" and x.shape[0] % 2:
        raise ValueError("B2_int8_slice takes x of [2M, K]")
    if name == "C_int8_glue":
        if w.shape[0] != w.shape[1]:
            raise ValueError("C_int8_glue feeds its result back: needs K == N")
        if tuple(ops[2].shape) != (1, w.shape[1]):
            raise ValueError(f"sw must be [1, N], got {tuple(ops[2].shape)}")
    if any(o.device != x.device for o in ops):
        raise ValueError("operands lie on different devices")


def plain(name: str, r: int, grid: int, *ops: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of variant `name`: `r` chained products,
    then the max over the rows, [grid, 1, N] (f32, or int32 for the pure
    int8 variants). The G chains get the same operands, so one chain is
    computed and repeated. bf16 operands meet in an f32 product; the int8
    products are exact."""
    _check(name, r, grid, ops)
    x, w = ops[0], ops[1]
    with torch.no_grad():
        if name.startswith("A"):
            wf = w.float()
            acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
            for i in range(r):
                xi = x + torch.tensor(i % 2, dtype=torch.bfloat16) if name == "A_bf16" else x
                acc = acc + torch.matmul(xi.float(), wf)
            out = acc.amax(dim=0, keepdim=True)
        elif name == "C_int8_glue":
            sw = ops[2]
            for i in range(r):
                # a tensor divisor: PyTorch on CUDA multiplies by the
                # reciprocal of a scalar one, which is not the rounded
                # quotient that jnp computes
                amax = x.abs().amax(dim=1, keepdim=True)
                s = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-8)
                xq = torch.round(x / s).to(torch.int8)
                deq = _int_product(xq, w).to(torch.float32) * s * sw
                x = torch.clamp(deq * 0.0625, -2.0, 2.0)
            out = x.amax(dim=0, keepdim=True)
        else:
            m = x.shape[0] // 2 if name == "B2_int8_slice" else x.shape[0]
            acc = torch.zeros((m, w.shape[1]), dtype=torch.int64, device=x.device)
            for i in range(r):
                if name == "B_int8":  # an int8 add: wraps at 127
                    xi = x + torch.tensor(i % 2, dtype=torch.int8)
                elif name == "B2_int8_slice":
                    xi = x[(i % 2) * m:(i % 2) * m + m]
                else:
                    xi = x
                acc = acc + _int_product(xi, w)
            if int(acc.abs().max()) >= 2 ** 31:
                raise OverflowError(f"{name}: the chain left int32 at r={r}")
            out = acc.amax(dim=0, keepdim=True).to(torch.int32)
    return out[None].expand(grid, 1, -1).contiguous()


def _launch(name: str, r: int, grid: int, ops) -> torch.Tensor:
    global launches
    lib = _load()
    x, w = ops[0], ops[1]
    m = x.shape[0] // 2 if name == "B2_int8_slice" else x.shape[0]
    tm = lib.k3_rows_per_cta()
    if w.shape != (lib.k3_depth(), lib.k3_width()) or m % tm or m < tm:
        raise ValueError(f"K3 is built for w [{lib.k3_depth()}, {lib.k3_width()}] and "
                         f"M a multiple of {tm}, got w {tuple(w.shape)}, M={m}")
    if not 1 <= grid <= 65535:
        raise ValueError(f"K3 takes 1 <= grid <= 65535 chains, got {grid}")
    dev = x.device
    out_dtype = torch.float32 if name[0] in "AC" else torch.int32
    x = x.contiguous()
    wt = w.t().contiguous()  # [n][k]: K-major, as integer wgmma requires
    if name == "C_int8_glue":
        wt = permute_glue_k(wt)
    sw = ops[2].contiguous() if name == "C_int8_glue" else None
    partial = torch.empty((grid, m // tm, w.shape[1]), dtype=out_dtype, device=dev)
    out = torch.empty((grid, 1, w.shape[1]), dtype=out_dtype, device=dev)
    if any(t.data_ptr() % 16 for t in (x, wt)):
        raise ValueError("K3 needs 16-byte aligned operands")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.k3_probe(VARIANTS.index(name), x.data_ptr(), wt.data_ptr(),
                            None if sw is None else sw.data_ptr(), m, grid, r,
                            partial.data_ptr(), out.data_ptr(), stream)
    if code != 0:
        msg = lib.k3_error_string(code).decode()
        raise RuntimeError(f"K3 launch failed: CUDA error {code} ({msg})")
    launches += 1
    return out


def run(name: str, r: int, grid: int, *ops: torch.Tensor) -> torch.Tensor:
    """Variant `name` over `grid` chains of `r` products -> [grid, 1, N].

    CUDA operands go through the kernel (or raise); CPU operands through
    the plain version. There is no fallback between the two."""
    _check(name, r, grid, ops)
    if ops[0].device.type == "cuda":
        return _launch(name, r, grid, ops)
    if ops[0].device.type == "cpu":
        return plain(name, r, grid, *ops)
    raise ValueError(f"K3 runs on CUDA or CPU tensors, got {ops[0].device}")


def _time_ms(fn, cuda: bool) -> float:
    """One call's time: CUDA events on the card, the host clock on the CPU
    (where the time means nothing)."""
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def measure(name: str, ops, grid: int, r1: int, r2: int, reps: int) -> dict:
    """Time one variant at both chain lengths, interleaved; the minimum per
    chain length, then the difference."""
    cuda = ops[0].device.type == "cuda"
    run(name, 2, grid, *ops)  # build and smoke
    if cuda:
        torch.cuda.synchronize()
    t1s, t2s = [], []
    for _ in range(reps):
        t1s.append(_time_ms(lambda: run(name, r1, grid, *ops), cuda))
        t2s.append(_time_ms(lambda: run(name, r2, grid, *ops), cuda))
    t1, t2 = min(t1s), min(t2s)
    res = {"t_r1_ms": round(t1, 4), "t_r2_ms": round(t2, 4)}
    per = (t2 - t1) * 1e-3 / (grid * (r2 - r1))  # seconds per product
    # a chain (r2 / r1) times as long must take longer by a clear margin
    if cuda and t2 < t1 * (1 + 0.25 * (r2 / max(r1, 1) - 1)):
        return {**res, "hoisted": True}
    rate = flop() / max(per, 1e-30)
    res.update({"us_per_matmul": round(per * 1e6, 4),
                "tflops": round(rate / 1e12, 1),
                "pct_bf16_peak": round(100 * rate / PEAK_BF16, 1),
                "pct_int8_peak": round(100 * rate / PEAK_INT8, 1)})
    peak = PEAK_INT8 if name in INT8_VARIANTS else PEAK_BF16
    if cuda and rate > peak * CLOCK_HEADROOM:
        raise RuntimeError(f"{name}: {rate / 1e12:.1f} T op/s is above the card's "
                           f"peak of {peak / 1e12:.0f} at its highest clock: the "
                           "measurement is at fault")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, default=32, help="G, the number of chains")
    ap.add_argument("--r1", type=int, default=32)
    ap.add_argument("--r2", type=int, default=160)
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU (the times mean nothing)")
    ap.add_argument("--variants", type=str, default="",
                    help="comma list of variant names (prefix ok); all if empty")
    args = ap.parse_args(argv)
    if args.r2 <= args.r1:
        ap.error("--r2 must exceed --r1")

    if args.cpu:
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA device; --cpu runs the plain "
                           "versions instead")
    else:
        device = torch.device("cuda")
    inputs = make_inputs(0, device)
    names = list(VARIANTS)
    if args.variants:
        want = set(args.variants.split(","))
        names = [n for n in names if n in want or n.split("_")[0] in want]

    results: dict = {}
    for name in names:
        results[name] = measure(name, inputs[name], args.grid, args.r1, args.r2, args.reps)
        print(name, json.dumps(results[name]), flush=True)

    def us(name):
        return results.get(name, {}).get("us_per_matmul")

    if us("A_bf16") and us("B_int8"):
        results["int8_speedup_pure"] = round(us("A_bf16") / us("B_int8"), 2)
    if us("A_bf16") and us("C_int8_glue"):
        results["int8_speedup_with_glue"] = round(us("A_bf16") / us("C_int8_glue"), 2)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
