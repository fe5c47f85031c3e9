"""The port's stage-1 training CLI (`egohmr_tpu_torch.train.train_prohmr`)
on the CPU at full width (ResNet-50, the 4-step Glow at hidden 1024, 20,000
scene points, 6890 vertices, batch 2): the synthetic smoke and its resume,
the data streams the JAX CLI draws, the checkpoint read back by the JAX
package, and the real-data branch on the on-disk EgoBody fixture with a
mocap file and an ImageNet warm start, and its batch stream resumed
mid-epoch."""
import json
import os
import shutil
from itertools import islice

import numpy as np
import pytest
import torch

from egohmr_tpu.interop.torch_convert import convert_discriminator, convert_prohmr
from egohmr_tpu_torch.data import EgoBodyDataset, synthetic_batch
from egohmr_tpu_torch.interop import export_discriminator, export_prohmr
from egohmr_tpu_torch.models import ProHMR, ProHMRConfig
from egohmr_tpu_torch.models import prohmr as tprohmr
from egohmr_tpu_torch.train import train_prohmr as cli
from egohmr_tpu_torch.utils.checkpoint import latest_checkpoint, restore_checkpoint

from .test_egobody_dataset import egobody_root  # noqa: F401 (pytest fixture)
from .test_torch_data import _write_smpl_pkl
from .torch_parity import tmp_path  # noqa: F401 (a fixture: removed after each test)

COMMON = ["--device", "cpu", "--synthetic", "--batch_size", "2", "--log_step", "1",
          "--save_step", "1000", "--data_parallel", "false"]


def _read_metrics(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """A synthetic run of 1 step resumed to 2, and the same 2 steps in one
    run, with what the uninterrupted run's steps were fed; removed after
    the module's tests (a full-width checkpoint with both AdamW states is
    some 950 MB)."""
    root = tmp_path_factory.mktemp("train_prohmr")
    split, whole = str(root / "split"), str(root / "whole")
    fed = []
    make = cli.make_prohmr_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def run(model, disc, batch, mocap, generator):
            fed.append((batch["img"][:, :2, :2].clone(), {k: v.clone() for k, v in mocap.items()}))
            return step(model, disc, batch, mocap, generator)
        return run

    cli.main(COMMON + ["--save_dir", split, "--num_steps", "1"])
    first = [m["step"] for m in _read_metrics(split)]
    cli.main(COMMON + ["--save_dir", split, "--num_steps", "2"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "make_prohmr_train_step", recording)
        cli.main(COMMON + ["--save_dir", whole, "--num_steps", "2"])
    yield first, split, whole, fed
    shutil.rmtree(root, ignore_errors=True)


def test_cli_smoke_and_resume(resumed):
    """Step [0], then resumed at 1 without replaying a step; finite
    losses with every term the JAX CLI logs; the checkpoints under their
    step names."""
    first, split, _, _ = resumed
    assert first == [0]
    metrics = _read_metrics(split)
    assert [m["step"] for m in metrics] == [0, 1]
    assert {"loss", "loss_nll", "loss_gen", "loss_disc", "loss_v2v_mode"} <= set(metrics[0])
    assert all(np.isfinite(v) for m in metrics for v in m.values())
    assert json.load(open(os.path.join(split, "params.json")))["num_steps"] == 2
    ckpts = os.path.join(split, "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["step_0.pt", "step_1.pt"]
    assert latest_checkpoint(ckpts) == os.path.join(ckpts, "step_1.pt")


def test_resumed_run_equals_the_uninterrupted_one(resumed):
    """The generator (its trained `init_betas` and `init_cam` included), the
    discriminator, both AdamW states, the mocap stream and the metrics of
    1 + 1 steps equal those of 2 steps in one run, bit for bit."""
    _, split, whole, _ = resumed
    a = restore_checkpoint(os.path.join(split, "checkpoints", "step_1.pt"))
    b = restore_checkpoint(os.path.join(whole, "checkpoints", "step_1.pt"))
    for part in ("model", "discriminator"):
        for k in b[part]:
            torch.testing.assert_close(a[part][k], b[part][k], rtol=0, atol=0, msg=k)
    for opt in ("optimizer", "disc_optimizer"):
        for i, sb in b[opt]["state"].items():
            for k, v in sb.items():
                torch.testing.assert_close(a[opt]["state"][i][k], v,
                                           rtol=0, atol=0)
    assert torch.equal(a["mocap_rng"]["keys"], b["mocap_rng"]["keys"])
    assert a["mocap_rng"]["pos"] == b["mocap_rng"]["pos"]
    assert _read_metrics(split) == _read_metrics(whole)
    # AdamW trains the head's initial betas and camera, which start at 0
    # and (0.9, 0, 0)
    assert (b["model"]["flow.fc_head.init_betas"] != 0).all()
    assert not torch.equal(b["model"]["flow.fc_head.init_cam"], torch.tensor([[0.9, 0.0, 0.0]]))


def test_data_streams_are_the_jax_clis(resumed):
    """What the JAX CLI feeds its steps: step i takes `synthetic_batch(B,
    seed=i + 1)` (batch 0 sets the ActNorms) and mocap poses x 0.3, then
    betas x 0.5, from one `RandomState(seed)`."""
    _, _, _, fed = resumed
    rng = np.random.RandomState(0)
    assert len(fed) == 2
    for i, (img, mocap) in enumerate(fed):
        want = synthetic_batch(2, seed=i + 1)["img"][:, :2, :2]
        np.testing.assert_array_equal(img.numpy(), want)
        np.testing.assert_array_equal(mocap["body_pose"].numpy(),
                                      rng.randn(2, 69).astype(np.float32) * 0.3)
        np.testing.assert_array_equal(mocap["betas"].numpy(),
                                      rng.randn(2, 10).astype(np.float32) * 0.5)


def test_saved_state_reads_back_into_jax(resumed):
    """The JAX package's `convert_prohmr` and `convert_discriminator` turn
    the checkpoint's generator and discriminator into trees that export
    back to the same arrays, key for key."""
    _, split, _, _ = resumed
    state = restore_checkpoint(os.path.join(split, "checkpoints", "step_1.pt"))
    sd = {k: v.numpy() for k, v in state["model"].items()}
    back = export_prohmr(convert_prohmr(sd))
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k].astype(back[k].dtype), err_msg=k)
    dsd = {"discriminator." + k: v.numpy() for k, v in state["discriminator"].items()}
    dback = export_discriminator(convert_discriminator(dsd))
    assert set(dback) == set(dsd)
    for k in dsd:
        np.testing.assert_array_equal(dback[k], dsd[k], err_msg=k)


def _train_split(root):
    """The fixture lays out the test split only: its scene files serve the
    train split too."""
    s1 = os.path.join(root, "Egohmr_scene_preprocess_s1_release")
    for name in ("pcd_verts_dict", "map_dict"):
        if not os.path.exists(os.path.join(s1, f"{name}_train.pkl")):
            os.symlink(os.path.join(s1, f"{name}_test.pkl"), os.path.join(s1, f"{name}_train.pkl"))
    return os.path.join(root, "annotations.npz")


def test_real_data_stream_resumes_where_it_stood(egobody_root):  # noqa: F811
    """The real-data branch's batch stream from batch `first` (a run
    resumed at step `first - 1`) is the uninterrupted stream's from that
    batch on, across epochs: 6 images in 3 batches of 2 an epoch, each
    epoch shuffled by its own seed, without augmentation; the images and
    their names equal exactly."""
    ann = _train_split(egobody_root)
    ds = EgoBodyDataset(dataset_file=ann, data_root=egobody_root, split="train", train=True,
                        do_augment=False, scene_type="whole_scene")
    full = list(islice(cli.egobody_batches(ds, 2, 0), 8))
    assert len({tuple(b["imgname"]) for b in full[:3]}) == 3
    assert [b["imgname"] for b in full[:3]] != [b["imgname"] for b in full[3:6]]
    for first in (1, 3, 5):
        got = list(islice(cli.egobody_batches(ds, 2, first), 8 - first))
        for i, (g, w) in enumerate(zip(got, full[first:])):
            assert g["imgname"] == w["imgname"], (first, i)
            np.testing.assert_array_equal(g["img"], w["img"])


def test_real_data_branch_with_a_warm_start(egobody_root, tmp_path):  # noqa: F811
    """Two steps of the non-synthetic branch on the on-disk fixture, with
    SMPL pickles, a CMU-mocap file and `--load_imagenet_ckpt`: with lr 0 and
    no decay the checkpoint holds the file's backbone (BatchNorm statistics
    aside, which the steps update), and the losses are finite."""
    root = egobody_root
    ann = _train_split(root)
    smpl = tmp_path / "smpl"
    os.makedirs(smpl)
    for i, g in enumerate(("NEUTRAL", "MALE", "FEMALE")):
        _write_smpl_pkl(smpl / f"SMPL_{g}.pkl", i, num_vertices=6890, n_shape=12)
    rng = np.random.RandomState(0)
    mocap = str(tmp_path / "cmu_mocap.npz")
    np.savez(mocap, pose=rng.randn(20, 72).astype(np.float32) * 0.2,
             betas=rng.randn(20, 10).astype(np.float32))
    zoo = {k: v.clone() for k, v in tprohmr.init_random_(
        ProHMR(ProHMRConfig()), seed=5).backbone.state_dict().items()}
    zoo["fc.weight"], zoo["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    torch.save(zoo, tmp_path / "resnet50.pth")
    save = str(tmp_path / "out")
    cli.main(["--device", "cpu", "--dataset_root", root, "--dataset_file_train", ann,
              "--cmu_mocap_file", mocap, "--smpl_model_path", str(smpl),
              "--batch_size", "2", "--num_steps", "2", "--log_step", "1", "--save_dir", save,
              "--data_parallel", "false", "--lr", "0", "--weight_decay", "0",
              "--load_imagenet_ckpt", str(tmp_path / "resnet50.pth")])
    metrics = _read_metrics(save)
    assert [m["step"] for m in metrics] == [0, 1]
    assert all(np.isfinite(v) for m in metrics for v in m.values())
    model = restore_checkpoint(os.path.join(save, "checkpoints", "step_1.pt"))["model"]
    for k, v in zoo.items():
        if k.startswith("fc.") or k.endswith(("running_mean", "running_var",
                                              "num_batches_tracked")):
            continue
        torch.testing.assert_close(model["backbone." + k], v, rtol=0, atol=0, msg=k)
    shutil.rmtree(save, ignore_errors=True)


def test_cli_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--synthetic", "--num_steps", "1"])
