"""The port's stage-1 evaluation CLI (`egohmr_tpu_torch.eval.test_prohmr`)
against egohmr_tpu's, the weights it loads, and the two-stage handoff: the
port's stage-1 CLI writes `results.pkl` on the on-disk EgoBody fixture and
the port's stage-2 CLI reads its translations."""
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from egohmr_tpu.eval import test_prohmr as jcli
from egohmr_tpu.models.prohmr import ProHMRConfig as JProHMRConfig
from egohmr_tpu.models.prohmr import init_prohmr
from egohmr_tpu.utils.checkpoint import save_npz as j_save_npz
from egohmr_tpu_torch.eval import test_prohmr as tcli
from egohmr_tpu_torch.interop import prohmr_state_dict_from_jax
from egohmr_tpu_torch.models import ProHMR, ProHMRConfig
from egohmr_tpu_torch.models import prohmr as tprohmr

from .test_egobody_dataset import N_ITEMS, egobody_root  # noqa: F401 (pytest fixture)
from .test_torch_data import _write_smpl_pkl
from .torch_parity import TINY_PROHMR, tiny_prohmr_pair, tmp_path, to_jax  # noqa: F401 (tmp_path: a fixture)


def test_cli_has_the_originals_flags_and_defaults():
    """The same flags with the same defaults, but for `--platform`, which
    the port replaces by `--device` (default `cuda`)."""
    j, t = vars(jcli.parse_args([])), vars(tcli.parse_args([]))
    assert set(j) - set(t) == {"platform"} and set(t) - set(j) == {"device"}
    assert {k: v for k, v in j.items() if k != "platform"} == \
        {k: v for k, v in t.items() if k != "device"}
    assert t["device"] == "cuda" and t["pointnet_impl"] == "fused"
    assert (t["batch_size"], t["num_samples"]) == (10, 5)


def test_cli_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--synthetic", "--num_batches", "1"])


def test_cli_loads_reference_port_and_npz_checkpoints(tmp_path):
    """A reference-layout `.pt` (with the reference module's discriminator
    and nflows' extra state, both left out strictly), a checkpoint of the
    port's training CLI and a JAX `save_npz` tree load to the same weights,
    `init_betas` and `init_cam` included; an orbax directory is refused."""
    cfg = ProHMRConfig(**TINY_PROHMR)
    _, _, params, model = tiny_prohmr_pair(seed=6)
    want = model.state_dict()
    ref = dict(want)
    ref["flow.flow._transform._transforms.0.initialized"] = torch.tensor(True)
    ref["discriminator.D_conv1.weight"] = torch.zeros(32, 9, 1, 1)
    pt = str(tmp_path / "run" / "53618.pt")
    os.makedirs(os.path.dirname(pt))
    torch.save({"state_dict": ref}, pt)
    ckpt = str(tmp_path / "step_3.pt")
    torch.save({"model": want, "discriminator": {}, "step": 3}, ckpt)
    j_save_npz(str(tmp_path / "params.npz"), to_jax(params))
    j_save_npz(str(tmp_path / "state.npz"), {"params": to_jax(params)})
    for path in (pt, ckpt, str(tmp_path / "params.npz"), str(tmp_path / "state.npz")):
        got = tcli._load_model(path, cfg).state_dict()
        assert set(got) == set(want), path
        for k in want:
            assert torch.equal(got[k], want[k]), (path, k)
    assert not torch.equal(want["flow.fc_head.init_cam"], torch.tensor([[0.9, 0.0, 0.0]]))
    os.makedirs(tmp_path / "step_100")
    with pytest.raises(ValueError, match="save_npz"):
        tcli._load_model(str(tmp_path / "step_100"), cfg)


ARGS = ["--synthetic", "--batch_size", "2", "--num_samples", "2", "--num_batches", "1"]


def test_cli_as_a_whole_matches_jax(tmp_path, monkeypatch, capsys):
    """Stage 1's evaluation at full width on the CPU (ResNet-50, a Glow of 4
    steps of 2 blocks at hidden 1024, 20,000 scene points, 6890 vertices,
    2 images x 2 samples, the CLI's default `--pointnet_impl fused`, which
    takes the plain encoder on the CPU in both packages): both CLIs on the
    same weights (the tree the JAX CLI draws with `--synthetic`), the same
    batch and the same z (the one the JAX CLI's key chain draws). The
    summary keys equal and their values within rtol 1e-3; the
    `pred_cam_full_list` each writes at rtol 1e-4."""
    params = jax.tree_util.tree_map(np.asarray, init_prohmr(
        jax.random.PRNGKey(0), JProHMRConfig(pointnet_impl="fused")))
    sub = jax.random.split(jax.random.PRNGKey(0))[1]
    z = np.zeros((2, 2, 144), np.float32)
    z[:, 1:] = np.asarray(jax.random.normal(sub, (2, 1, 144)))

    def same_weights(cfg):
        model = ProHMR(cfg)
        model.load_state_dict(prohmr_state_dict_from_jax(params), strict=True)
        return model

    def same_z(*a, **kw):
        return tprohmr.forward(*a, **{**kw, "z": torch.tensor(z)})

    monkeypatch.setattr(tcli, "_synthetic_model", same_weights)
    monkeypatch.setattr(tcli, "forward", same_z)
    save_j, save_t = str(tmp_path / "j"), str(tmp_path / "t")
    want = jcli.main(ARGS + ["--platform", "cpu", "--save_root", save_j])
    capsys.readouterr()
    got = tcli.main(ARGS + ["--device", "cpu", "--save_root", save_t])
    printed = capsys.readouterr().out
    assert list(got) == list(want) == ["g_mpjpe", "mpjpe", "pa_mpjpe", "v2v"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
        assert f'"{k}"' in printed
    with open(os.path.join(save_j, "results.pkl"), "rb") as f:
        rj = pickle.load(f)
    with open(os.path.join(save_t, "results.pkl"), "rb") as f:
        rt = pickle.load(f)
    assert set(rt) == set(rj) == {"pred_cam_full_list"}
    a, b = rt["pred_cam_full_list"], rj["pred_cam_full_list"]
    assert a.shape == b.shape == (2, 3) and a.dtype == b.dtype == np.float32
    np.testing.assert_allclose(a, b, rtol=1e-4)


def test_two_stage_handoff_on_the_dataset_fixture(egobody_root, tmp_path):  # noqa: F811
    """Port stage 1 -> `results.pkl` -> port stage 2, as
    `tests/test_two_stage.py` runs the JAX package: the stage-1 CLI on the
    fixture (6 images in batches of 4: the short last batch padded and
    trimmed) writes one translation per image, finite; the dataset hands
    exactly those to stage 2 (rtol 1e-5); and the stage-2 CLI, with
    `--two_stage true`, carries them into its own `results_seed_0.pkl`
    (rtol 1e-5)."""
    from egohmr_tpu_torch.data import EgoBodyDataset, save_stats
    from egohmr_tpu_torch.eval import test_egohmr as s2cli
    from egohmr_tpu_torch.models import EgoHMR, EgoHMRConfig, init_random_

    root = egobody_root
    ann = os.path.join(root, "annotations.npz")
    smpl = tmp_path / "smpl"
    os.makedirs(smpl)
    for i, g in enumerate(("NEUTRAL", "MALE", "FEMALE")):
        _write_smpl_pkl(smpl / f"SMPL_{g}.pkl", i, num_vertices=6890, n_shape=12)
    ck1 = str(tmp_path / "s1" / "model.pt")
    os.makedirs(os.path.dirname(ck1))
    torch.save({"state_dict": tprohmr.init_random_(ProHMR(ProHMRConfig()), seed=3).state_dict()},
               ck1)
    s1_root = str(tmp_path / "s1_out")
    s1 = tcli.main(["--device", "cpu", "--dataset_file", ann, "--dataset_root", root,
                    "--checkpoint", ck1, "--smpl_model_path", str(smpl),
                    "--scene_type", "whole_scene", "--batch_size", "4", "--num_samples", "2",
                    "--save_root", s1_root])
    assert all(np.isfinite(v) for v in s1.values()), s1
    pkl = os.path.join(s1_root, "results.pkl")
    with open(pkl, "rb") as f:
        handoff = pickle.load(f)["pred_cam_full_list"]
    assert handoff.shape == (N_ITEMS, 3) and np.isfinite(handoff).all()
    assert np.abs(handoff[:, 2]).max() > 0.1  # a depth, not a zero placeholder

    ds = EgoBodyDataset(dataset_file=ann, data_root=root, split="test", train=False,
                        scene_type="cube", load_stage1_transl=True, stage1_result_path=pkl)
    for i in range(N_ITEMS):
        np.testing.assert_allclose(ds[i]["stage1_transl_full"], handoff[i], rtol=1e-5)

    ck2 = str(tmp_path / "s2" / "model.pt")
    os.makedirs(os.path.dirname(ck2))
    torch.save({"state_dict": init_random_(EgoHMR(EgoHMRConfig()), seed=1).state_dict()}, ck2)
    save_stats(str(tmp_path / "stats.npz"), np.zeros(144, np.float32), np.ones(144, np.float32))
    s2 = s2cli.main([
        "--device", "cpu", "--dataset_file", ann, "--dataset_root", root, "--checkpoint", ck2,
        "--body_rep_stats", str(tmp_path / "stats.npz"), "--smpl_model_path", str(smpl),
        "--two_stage", "true", "--stage1_result_path", pkl,
        "--scene_crop_by_stage1_transl", "false",  # the fixture ships the GT cubes
        "--batch_size", "3", "--num_samples", "1", "--timestep_respacing_eval", "ddim5",
        "--with_coap_grad", "false", "--eval_coll_loss", "false",
        "--eval_contact_score", "false", "--bf16", "false", "--pointnet_impl", "xla",
        "--save_results", "true", "--save_root", str(tmp_path / "s2_out")])
    assert np.isfinite(s2["g_mpjpe"])
    with open(tmp_path / "s2_out" / "output_egohmr_s2" / "results_seed_0.pkl", "rb") as f:
        res = pickle.load(f)
    np.testing.assert_allclose(res["pred_cam_full_list"], handoff, rtol=1e-5)


# ------------------------------------------------------------ preprocess
def _mesh_files(tmp_path):
    """The same 40 vertices as an OBJ, an ASCII PLY and a binary PLY with an
    extra colour property."""
    import struct

    verts = np.random.RandomState(0).randn(40, 3).astype(np.float32)
    obj = tmp_path / "m.obj"
    obj.write_text("# mesh\n" + "".join(f"v {x} {y} {z}\n" for x, y, z in verts) + "f 1 2 3\n")
    head = "ply\nformat {}\nelement vertex 40\nproperty float x\nproperty float y\n" \
           "property float z\nproperty uchar red\nelement face 1\n" \
           "property list uchar int vertex_indices\nend_header\n"
    ply_a = tmp_path / "a.ply"
    ply_a.write_text(head.format("ascii 1.0") + "".join(f"{x} {y} {z} 7\n" for x, y, z in verts))
    ply_b = tmp_path / "b.ply"
    ply_b.write_bytes(head.format("binary_little_endian 1.0").encode()
                      + b"".join(struct.pack("<fffB", *v, 7) for v in verts))
    return [str(obj), str(ply_a), str(ply_b)]


def test_mesh_io_equals_the_original(tmp_path):
    """`preprocess.mesh_io` reads the same vertices as egohmr_tpu's from
    OBJ, ASCII and binary PLY, and downsamples the same way."""
    from egohmr_tpu.preprocess import mesh_io as jio
    from egohmr_tpu_torch.preprocess import mesh_io as tio

    for path in _mesh_files(tmp_path):
        got = tio.read_mesh_vertices(path)
        np.testing.assert_array_equal(got, jio.read_mesh_vertices(path), err_msg=path)
        assert got.shape == (40, 3) and got.dtype == np.float64
        for target in (7, 40, 100):
            np.testing.assert_array_equal(tio.uniform_downsample(got, target),
                                          jio.uniform_downsample(got, target))
    with pytest.raises(ValueError, match="unsupported"):
        tio.read_mesh_vertices(str(tmp_path / "m.stl"))


@pytest.mark.parametrize("augment", [False, True])
def test_crop_scene_cube_equals_the_original(augment):
    """The cube crop, with and without the training-time rotation and
    shift, equals egohmr_tpu's on the same draws; so does `rotate_y`."""
    from egohmr_tpu.preprocess import scene as jscene
    from egohmr_tpu_torch.preprocess import scene as tscene

    rng = np.random.RandomState(1)
    verts = rng.rand(5000, 3) * [6.0, 3.0, 6.0] - [3.0, 0.0, 3.0]
    body = rng.randn(100, 3) * [0.2, 0.5, 0.1] + [0.3, 1.0, -0.2]
    center = body.mean(0)
    kw = dict(cube_size=2.0, target=800, body_verts=body if augment else None)
    got = tscene.crop_scene_cube(verts, center, rng=np.random.RandomState(3), **kw)
    want = jscene.crop_scene_cube(verts, center, rng=np.random.RandomState(3), **kw)
    assert got.shape == (800, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tscene.rotate_y(verts, center, 0.7),
                                  jscene.rotate_y(verts, center, 0.7))


def test_preprocess_s1_and_s2_equal_the_originals(egobody_root, tmp_path):  # noqa: F811
    """On the on-disk EgoBody fixture with a scene mesh: the whole-scene
    clouds and frame map of `preprocess_s1` equal the original's exactly;
    the cubes of `preprocess_s2`, around the GT body (training, with the
    random rotation and shift) and around stage 1's translations (test),
    equal the original's at rtol 1e-6: the port poses the GT body with its
    own SMPL, which differs from JAX's at f32 rounding."""
    import egohmr_tpu.preprocess.scene as jscene
    from egohmr_tpu.smpl import make_synthetic_model as j_make_smpl
    from egohmr_tpu_torch.preprocess import scene as tscene
    from egohmr_tpu_torch.smpl import make_synthetic_model

    from .test_egobody_dataset import SCENE

    root = egobody_root
    mesh_dir = os.path.join(root, "scene_mesh", SCENE)
    os.makedirs(mesh_dir, exist_ok=True)
    rng = np.random.RandomState(2)
    mesh = rng.rand(30000, 3) * [8.0, 3.0, 8.0] - [4.0, 1.5, 4.0]
    with open(os.path.join(mesh_dir, SCENE + ".obj"), "w") as f:
        f.write("".join(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in mesh))
    ann = os.path.join(root, "annotations.npz")
    out = {}
    for side, mod in (("jax", jscene), ("port", tscene)):
        mod.preprocess_s1(root, str(tmp_path / side / "s1"), "test", annotation_file=ann,
                          scene_verts_num_target=2000)
    for name in ("map_dict_test.pkl", "pcd_verts_dict_test.pkl"):
        with open(tmp_path / "jax" / "s1" / name, "rb") as f:
            want = pickle.load(f)
        with open(tmp_path / "port" / "s1" / name, "rb") as f:
            got = pickle.load(f)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    smpls = {"jax": {g: j_make_smpl(seed=i, num_vertices=6890)
                     for i, g in enumerate(("male", "female"))},
             "port": {g: make_synthetic_model(seed=i, num_vertices=6890)
                      for i, g in enumerate(("male", "female"))}}
    for stage1 in ("", os.path.join(root, "stage1.pkl")):
        for side, mod in (("jax", jscene), ("port", tscene)):
            save = str(tmp_path / side / ("s2_pred" if stage1 else "s2_gt"))
            mod.preprocess_s2(root, save, "test", smpls[side], annotation_file=ann,
                              stage1_result_path=stage1 or None, cube_size=2.0,
                              scene_verts_num_target=1500, seed=4)
            out[side] = sorted((d, f) for d, _, fs in os.walk(save) for f in fs)
        assert len(out["port"]) == N_ITEMS and [f for _, f in out["port"]] == \
            [f for _, f in out["jax"]]
        for (dj, f), (dt, _) in zip(out["jax"], out["port"]):
            got, want = np.load(os.path.join(dt, f)), np.load(os.path.join(dj, f))
            assert got.shape == want.shape == (1500, 3)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9, err_msg=f)
