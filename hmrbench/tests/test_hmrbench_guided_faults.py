"""A guided run with the guidance broken underneath comes out not correct,
beside `test_hmrbench_faults.py`'s faults: the guidance dropped (the steps
run unguided), its weight halved, the learned field's scene cut to the
JAX package's 4,096 points (to half the tiny scene on the CPU), and, on a
card at the cell's own size, the field's float32 matmuls switched to TF32.
On the CPU at tiny widths with the port in float32; on a card at the
cell's size (those need a CUDA device and skip without one)."""
import dataclasses
import time

import pytest
import torch
import tiny_guided

import egohmr_tpu_torch.eval.pipeline as pipeline

VOLSDF, MESH = "egohmr-volsdf-ddpm50", "egohmr-ddpm50-guided"


def dropped(monkeypatch):
    """Every step unguided: the sampling loop given no guidance."""
    loop = pipeline.sample_loop
    monkeypatch.setattr(pipeline, "sample_loop",
                        lambda *a, **k: loop(*a, **dict(k, guidance_fn=None)))


def halved(monkeypatch):
    """The guidance's weight halved where the loop reads it."""
    loop = pipeline.sample_loop

    def half(*a, **k):
        g = k["guidance"]
        return loop(*a, **dict(k, guidance=dataclasses.replace(
            g, cond_grad_weight=g.cond_grad_weight / 2)))

    monkeypatch.setattr(pipeline, "sample_loop", half)


def capped(monkeypatch, points=None):
    """The learned field's scene cut to the `points` nearest the origin:
    the JAX package's 4,096 on the card, half the scene on the CPU."""
    make = pipeline.make_volsdf_guidance_fn

    def cut(net, model, cond, stats, **kw):
        n = points or cond.scene_pcd.shape[1] // 2
        return make(net, model, cond, stats, **dict(kw, max_scene_points=n))

    monkeypatch.setattr(pipeline, "make_volsdf_guidance_fn", cut)


FAULTS = [(VOLSDF, dropped), (VOLSDF, halved), (VOLSDF, capped), (MESH, dropped),
          (MESH, halved)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    res = tiny_guided.run(cell, f32=True, seed=31)
    assert res["correct"] is False, res["checks"]
    assert not res["checks"]["guide.grad.rel"]["value"] <= res["checks"]["guide.grad.rel"][
        "limit"] or not res["checks"]["guide.step.rel"]["value"] <= res["checks"][
        "guide.step.rel"]["limit"], res["checks"]


def on_card(monkeypatch, cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's size is the card's work")
    from hmrbench import run as runner

    args = runner.parse(["--workload", cell, "--seed", str(seed), "--seconds", "3",
                         "--trace", "0"])
    res = runner.run(args, t_start=time.perf_counter())
    print(cell, seed, res["checks"])
    return res


CARD = [(VOLSDF, dropped), (VOLSDF, halved),
        (VOLSDF, lambda m: capped(m, 4096)), (MESH, dropped), (MESH, halved)]


@pytest.mark.gpu
@pytest.mark.parametrize("cell,fault", CARD, ids=["volsdf-dropped", "volsdf-halved",
                                                  "volsdf-capped", "mesh-dropped",
                                                  "mesh-halved"])
def test_fault_is_not_correct_at_the_cells_size(monkeypatch, cell, fault):
    fault(monkeypatch)
    res = on_card(monkeypatch, cell, 2 ** 31 + 51)
    assert res["correct"] is False, res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [61, 2 ** 31 + 62])
def test_tf32_field_is_not_correct_at_the_cells_size(monkeypatch, seed):
    """The learned field's float32 matmuls with cuBLAS's TF32 on: its
    gradient fails."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    res = on_card(monkeypatch, VOLSDF, seed)
    assert res["correct"] is False, res["checks"]
    assert not res["checks"]["guide.grad.rel"]["value"] <= res["checks"]["guide.grad.rel"][
        "limit"], res["checks"]
