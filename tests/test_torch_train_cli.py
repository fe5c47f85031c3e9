"""The port's training CLI (`egohmr_tpu_torch.train.train_egohmr`) on the
CPU at full width: the synthetic smoke and its resume, the real-data branch
on the on-disk EgoBody fixture, the warm-start flags, the checkpoint's model
state read back by the JAX package, and `prefetch_to_device`."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from egohmr_tpu.interop.torch_convert import convert_egohmr, load_torch_checkpoint
from egohmr_tpu_torch.data.prefetch import prefetch_to_device
from egohmr_tpu_torch.interop import export_arrays
from egohmr_tpu_torch.models import EgoHMR, EgoHMRConfig, init_random_
from egohmr_tpu_torch.nn.embedders import sinusoidal_table
from egohmr_tpu_torch.train import train_egohmr as cli
from egohmr_tpu_torch.utils.checkpoint import latest_checkpoint, restore_checkpoint

from .test_egobody_dataset import egobody_root  # noqa: F401 (pytest fixture)
from .test_torch_data import _write_smpl_pkl

COMMON = ["--device", "cpu", "--synthetic", "--batch_size", "2", "--log_step", "1",
          "--val_step", "1000", "--save_step", "1000", "--data_parallel", "false"]


def _read_steps(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [json.loads(line)["step"] for line in f]


@pytest.fixture
def run_dir(tmp_path):
    """A save directory, removed after the test: a full-width checkpoint
    with its AdamW state is some 540 MB."""
    yield str(tmp_path / "run")
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """A synthetic run of 2 steps resumed to 4, and the same 4 steps in one
    run; removed after the module's tests."""
    root = tmp_path_factory.mktemp("train")
    split, whole = str(root / "split"), str(root / "whole")
    cli.main(COMMON + ["--save_dir", split, "--num_steps", "2"])
    first = _read_steps(split)
    cli.main(COMMON + ["--save_dir", split, "--num_steps", "4"])
    cli.main(COMMON + ["--save_dir", whole, "--num_steps", "4"])
    yield first, split, whole
    shutil.rmtree(root, ignore_errors=True)


def test_cli_smoke_and_resume(resumed):
    """Steps [0, 1], then resumed at 2 without replaying a step: [0, 1, 2,
    3]; the flags in params.json; the checkpoints under their step names."""
    first, split, _ = resumed
    assert first == [0, 1]
    assert _read_steps(split) == [0, 1, 2, 3]
    assert json.load(open(os.path.join(split, "params.json")))["num_steps"] == 4
    ckpts = os.path.join(split, "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["step_1.pt", "step_3.pt"]
    assert latest_checkpoint(ckpts) == os.path.join(ckpts, "step_3.pt")
    state = restore_checkpoint(os.path.join(ckpts, "step_3.pt"))
    assert state["step"] == 3
    assert all(torch.isfinite(v).all() for v in state["model"].values())


def test_resumed_run_equals_the_uninterrupted_one(resumed):
    """The model, the trained `pe` table, AdamW's state and the metrics of
    2 + 2 steps equal those of 4 steps in one run, bit for bit: a resumed
    run continues the data, the draws and the optimizer where they were."""
    _, split, whole = resumed
    a = restore_checkpoint(os.path.join(split, "checkpoints", "step_3.pt"))
    b = restore_checkpoint(os.path.join(whole, "checkpoints", "step_3.pt"))
    for k in b["model"]:
        torch.testing.assert_close(a["model"][k], b["model"][k], rtol=0, atol=0, msg=k)
    torch.testing.assert_close(a["trained_buffers"], b["trained_buffers"], rtol=0, atol=0)
    for i, sb in b["optimizer"]["state"].items():
        for k, v in sb.items():
            torch.testing.assert_close(a["optimizer"]["state"][i][k], v, rtol=0, atol=0)
    with open(os.path.join(split, "metrics.jsonl")) as f1, \
            open(os.path.join(whole, "metrics.jsonl")) as f2:
        assert f1.read() == f2.read()


def test_saved_model_state_reads_back_into_jax(resumed, run_dir):
    """`convert_egohmr` turns the checkpoint's model state, and the
    `--export_torch` file, into a JAX tree equal to the port's parameters
    and statistics. The trained timestep table travels beside the reference
    layout, which rebuilds `pe` from its formula."""
    _, split, _ = resumed
    state = restore_checkpoint(os.path.join(split, "checkpoints", "step_3.pt"))
    sd = {k: v.numpy() for k, v in state["model"].items()}
    tree = convert_egohmr(sd)
    back = export_arrays(tree)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k].astype(back[k].dtype), err_msg=k)
    pe = state["trained_buffers"]["embed_timestep.pe"].numpy()
    np.testing.assert_array_equal(np.asarray(tree["embed_timestep"]["pe"]),
                                  sinusoidal_table(pe.shape[1]))
    assert not np.array_equal(pe, sinusoidal_table(pe.shape[1]))  # the drawn rows moved

    os.makedirs(run_dir)
    out = os.path.join(run_dir, "exported.pt")
    cli.main(COMMON + ["--save_dir", split, "--num_steps", "4", "--export_torch", out])
    assert _read_steps(split) == [0, 1, 2, 3]  # nothing left to run, nothing logged
    exported = load_torch_checkpoint(out)
    assert torch.load(out, weights_only=True)["total_steps"] == 4
    for k in sd:
        np.testing.assert_array_equal(exported[k], sd[k], err_msg=k)


def _write_imagenet_resnet50(path):
    """A torchvision-layout ResNet-50 state_dict, classifier included."""
    sd = init_random_(EgoHMR(EgoHMRConfig()), seed=5).backbone.state_dict()
    sd = {k: v.clone() for k, v in sd.items()}
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    torch.save(sd, path)
    return sd


@pytest.mark.parametrize("flag", ["--load_imagenet_ckpt", "--load_pretrained_ckpt"])
def test_warm_start_flags_load_the_backbone(run_dir, flag):
    """The backbone starts from the file: with lr 0 and no decay the
    checkpoint after one step holds the file's weights (BatchNorm
    statistics aside, which the step updates)."""
    os.makedirs(run_dir)
    zoo = _write_imagenet_resnet50(os.path.join(run_dir, "resnet50.pth"))
    if flag == "--load_imagenet_ckpt":
        path = os.path.join(run_dir, "resnet50.pth")
    else:  # a reference checkpoint: {'state_dict': {'backbone.*': ...}}
        path = os.path.join(run_dir, "prohmr.pt")
        torch.save({"state_dict": {"backbone." + k: v for k, v in zoo.items()
                                   if not k.startswith("fc.")}}, path)
    cli.main(COMMON + ["--save_dir", run_dir, "--num_steps", "1", "--lr", "0",
                       "--weight_decay", "0", flag, path])
    model = restore_checkpoint(os.path.join(run_dir, "checkpoints", "step_0.pt"))["model"]
    for k, v in zoo.items():
        if k.startswith("fc.") or k.endswith(("running_mean", "running_var",
                                              "num_batches_tracked")):
            continue
        torch.testing.assert_close(model["backbone." + k], v, rtol=0, atol=0, msg=k)


def test_real_data_branch_on_the_dataset_fixture(egobody_root, run_dir):  # noqa: F811
    """Two steps of the non-synthetic branch on the on-disk fixture with
    SMPL pickles: the stats file written, validation on the val split (one
    image, padded to the batch), `best_model_vis.pt` saved."""
    root = egobody_root
    cube = os.path.join(root, "Egohmr_scene_preprocess_cube_s2_from_gt_release")
    for split in ("train", "val"):  # the fixture lays out the test split only
        if not os.path.exists(os.path.join(cube, split)):
            os.symlink(os.path.join(cube, "test"), os.path.join(cube, split))
    smpl = os.path.join(run_dir, "smpl")
    os.makedirs(smpl)
    for i, g in enumerate(("NEUTRAL", "MALE", "FEMALE")):
        _write_smpl_pkl(os.path.join(smpl, f"SMPL_{g}.pkl"), i, num_vertices=6890, n_shape=12)
    save = os.path.join(run_dir, "out")
    ann = os.path.join(root, "annotations.npz")
    cli.main(["--device", "cpu", "--dataset_root", root, "--dataset_file_train", ann,
              "--dataset_file_val", ann, "--smpl_model_path", smpl,
              "--batch_size", "2", "--num_steps", "2", "--log_step", "1", "--val_step", "1",
              "--save_dir", save, "--data_parallel", "false", "--mixed_precision", "false"])
    assert _read_steps(save) == [0, 1, 1]
    with open(os.path.join(save, "metrics.jsonl")) as f:
        val = [json.loads(line) for line in f][-1]
    assert np.isfinite(val["val_keypoints_3d_vis"]) and val["val_keypoints_3d_vis"] > 0
    with np.load(os.path.join(save, "preprocess_stats", "preprocess_stats.npz")) as z:
        assert z["Xmean"].shape == (144,) and np.isfinite(z["Xstd"]).all()
    assert sorted(os.listdir(os.path.join(save, "checkpoints"))) == ["best_model_vis.pt",
                                                                       "step_1.pt"]


def test_cli_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--synthetic", "--num_steps", "1"])


def test_prefetch_keeps_order_and_reraises_the_producers_error():
    def batches():
        for i in range(3):
            yield {"x": np.full((2, 3), i, np.float32), "imgname": ["a", "b"]}
        raise ValueError("broken batch")

    it = prefetch_to_device(batches(), size=2, device="cpu")
    for i in range(3):
        b = next(it)
        assert "imgname" not in b and isinstance(b["x"], torch.Tensor)
        assert float(b["x"][0, 0]) == i
    with pytest.raises(ValueError, match="broken batch"):
        next(it)


def test_prefetch_thread_ends_when_the_consumer_stops():
    """An endless producer stops once the iterator is closed."""
    import itertools
    import threading

    before = threading.active_count()
    it = prefetch_to_device(({"x": np.zeros(2, np.float32)} for _ in itertools.count()),
                            size=2, device="cpu")
    next(it)
    assert threading.active_count() == before + 1
    it.close()
    assert threading.active_count() == before


def test_phase_timer_and_trace(tmp_path):
    """`PhaseTimer` averages each phase's host time; `trace` writes a
    Chrome-format trace of the block, and does nothing without a directory."""
    from egohmr_tpu_torch.utils.profiling import PhaseTimer, trace

    timer = PhaseTimer()
    x = torch.ones(64, 64)
    for _ in range(3):
        with timer.phase("matmul", sync=x):
            x = x @ x / 64
        with timer.phase("idle"):
            pass
    means = timer.summary()
    assert set(means) == {"matmul", "idle"} and timer.counts == {"matmul": 3, "idle": 3}
    assert all(v >= 0 for v in means.values())
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(8) @ torch.ones(8)
    assert prof is not None
    events = json.load(open(tmp_path / "tr" / "trace.json"))["traceEvents"]
    assert any("matmul" in e.get("name", "") or "dot" in e.get("name", "") for e in events)
    with trace("") as prof:
        assert prof is None
