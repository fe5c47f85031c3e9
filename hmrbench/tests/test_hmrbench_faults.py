"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of the run as it is, at tiny
widths with the port in float32 (sound runs read at rounding there), once
for each fault that the cell can have; and, on a card at the cell's own
size, stage 1 with its float32 matmuls switched to TF32."""
import time

import pytest
import torch
import tiny_cells

import egohmr_tpu_torch.diffusion.sampler as sampler
import egohmr_tpu_torch.flow.glow as glow
import egohmr_tpu_torch.models.prohmr as prohmr
import egohmr_tpu_torch.serving as serving


def altered_pack(monkeypatch):
    """An answer altered where it is produced: every packed output off by
    0.05."""
    pack = serving.Predictor._pack
    monkeypatch.setattr(serving.Predictor, "_pack", lambda self, outs: pack(self, outs) + 0.05)


def frozen_steps(monkeypatch):
    """A step that returns its state unchanged: every sampler step."""
    monkeypatch.setattr(sampler, "_ddim_step", lambda *a, **k: (a[5], a[7]))


def altered_forward(monkeypatch):
    """An answer altered where it is produced: stage 1's poses off by
    0.05."""
    forward = prohmr.forward

    def altered(*a, **k):
        out = forward(*a, **k)
        return out._replace(pred_pose_6d=out.pred_pose_6d + 0.05)

    monkeypatch.setattr(prohmr, "forward", altered)


def frozen_coupling(monkeypatch):
    """A step that returns its state unchanged: every coupling of the
    flow's inverse."""
    monkeypatch.setattr(glow, "coupling_inverse",
                        lambda coupling, y, context: (y, y.new_zeros(y.shape[0])))


FAULTS = [("egohmr-ddim5-bulk", altered_pack), ("egohmr-ddim5-bulk", frozen_steps),
          ("prohmr-flow", altered_forward), ("prohmr-flow", frozen_coupling)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    res = tiny_cells.run(cell, f32=True, seed=31)
    assert res["correct"] is False, res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [41, 2 ** 31 + 42, 4_000_000_043])
def test_tf32_stage1_is_not_correct_at_the_cells_size(monkeypatch, seed):
    """Stage 1 with cuBLAS's TF32 switched on (its flow and head run float32
    with TF32 off) at the cell's own size: the flow's numbers fail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's size is the card's work")
    from hmrbench import run as runner

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    # the program's own default for its convolutions (the reference's
    # `exact()` turns it off for the rest of the process)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    args = runner.parse(["--workload", "prohmr-flow", "--seed", str(seed), "--seconds", "3",
                         "--trace", "0"])
    res = runner.run(args, t_start=time.perf_counter())
    print("tf32", seed, res["checks"])
    assert res["correct"] is False, res["checks"]
    assert any(not c["value"] <= c["limit"] for k, c in res["checks"].items()
               if k.startswith("flow.")), res["checks"]
