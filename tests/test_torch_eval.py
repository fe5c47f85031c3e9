"""Port parity of the evaluation path: `evaluate_batch` field by field,
`sample_bodies(use_stage1_transl=...)`, the weights the CLI loads, and the
slice as a whole: the port's `eval.test_egohmr.main` against egohmr_tpu's on
the same weights, batches and starting noise."""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egohmr_tpu.diffusion import make_schedule as j_make_schedule
from egohmr_tpu.eval import pipeline as jpipe
from egohmr_tpu.eval import test_egohmr as jcli
from egohmr_tpu.models import BodyRepStats as JStats
from egohmr_tpu.models import EgoHMRConfig as JaxConfig
from egohmr_tpu.models import init_egohmr
from egohmr_tpu.smpl import make_synthetic_model as j_make_smpl
from egohmr_tpu.utils.checkpoint import save_npz as j_save_npz
from egohmr_tpu_torch.data import synthetic_batch, to_torch
from egohmr_tpu_torch.diffusion import make_schedule
from egohmr_tpu_torch.eval import EvalResult, evaluate_batch, sample_bodies
from egohmr_tpu_torch.eval import test_egohmr as tcli
from egohmr_tpu_torch.interop import state_dict_from_jax
from egohmr_tpu_torch.models import BodyRepStats, Condition, EgoHMR, EgoHMRConfig
from egohmr_tpu_torch.smpl import make_synthetic_model

from .test_egobody_dataset import N_ITEMS, egobody_root  # noqa: F401 (pytest fixture)
from .test_torch_data import _write_smpl_pkl
from .torch_parity import TINY, tiny_pair, tmp_path, to_jax, to_np  # noqa: F401 (tmp_path: a fixture)

B, S, V, P = 3, 3, 300, 400
ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "artifacts")
EXACT = ("coll_ratio", "contact", "vis_count", "invis_count", "vertex_vis_count",
         "vertex_invis_count")


@pytest.fixture(scope="module")
def sampled():
    """Bodies sampled by the JAX package at a tiny config (ResNet-18), for
    three images: the first wholly in view, the second half out of the image
    (some joints and vertices invisible), the third wholly out of it (no
    visible joint). The male and the female body differ."""
    jcfg, tcfg, params, _ = tiny_pair(seed=2)
    batch = synthetic_batch(B, num_scene_points=P, img_size=64, seed=6)
    batch["smpl_params"]["transl"][1, 0] = 1.55   # u around the right edge
    batch["smpl_params"]["transl"][2, 0] = 4.0    # far outside
    batch["gender"] = np.array([0, 1, 1], np.int32)
    smpls = [(j_make_smpl(seed=s, num_vertices=V), make_synthetic_model(seed=s, num_vertices=V))
             for s in (0, 1, 2)]
    jout, jcond = jpipe.sample_bodies(
        to_jax(params), jcfg, smpls[0][0], JStats(jnp.zeros(144), jnp.ones(144)),
        j_make_schedule(50, "cosine", "ddim5"), to_jax(batch), jax.random.PRNGKey(3), S,
        sampler="ddim")
    tout = {k: torch.tensor(np.array(v)) for k, v in jout.items()}
    tcond = Condition(*(torch.tensor(np.array(x)) for x in jcond))
    return jcfg, tcfg, batch, smpls, (jout, jcond), (tout, tcond)


@pytest.mark.parametrize("vis_mask_pa", [True, False])
def test_evaluate_batch_matches_jax_field_by_field(sampled, vis_mask_pa):
    """The same sampled bodies through both `evaluate_batch`es: rtol/atol
    1e-4 on every error and diversity field (NaN where JAX has NaN: the
    vis-masked fit of the image with no visible joint); the collision
    ratio, the contact score and the four counts exactly."""
    jcfg, tcfg, batch, smpls, (jout, jcond), (tout, tcond) = sampled
    # a contact threshold between two bodies' squared distances, so that the
    # score is mixed
    dmin2 = np.sort(np.asarray(jnp.square(jpipe.min_body_scene_distance(
        jout["pred_vertices"].reshape(B * S, -1, 3),
        jnp.repeat(jcond.scene_pcd, S, axis=0)))))
    thresh = float((dmin2[3] + dmin2[4]) / 2)
    assert dmin2[4] - dmin2[3] > 1e-6
    kw = dict(eval_with_vis_mask_pa=vis_mask_pa, contact_thresh=thresh)
    want = jpipe.evaluate_batch(jcfg, *(s[0] for s in smpls), to_jax(batch), jout, jcond, **kw)
    got = evaluate_batch(tcfg, *(s[1] for s in smpls), to_torch(batch, "cpu"), tout, tcond, **kw)
    assert isinstance(got, EvalResult)
    assert got._fields == tuple(f.name for f in want.__dataclass_fields__.values())
    for name in got._fields:
        g, w = to_np(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        if name in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, equal_nan=True, err_msg=name)
    # the inputs do exercise the masks, the gender switch and the scores
    assert got.vis_count.tolist()[0] == 24 and 0 < got.vis_count[1] < 24 and got.vis_count[2] == 0
    assert 0 < got.vertex_vis_count[1] < V
    assert got.coll_ratio.max() > 0 and 0 < got.contact.mean() < 1
    assert torch.isnan(got.pa_mpjpe_all[2]).all() == vis_mask_pa
    assert torch.isfinite(got.pa_mpjpe_all[:2]).all() and torch.isfinite(got.v2v_invis).all()
    same = evaluate_batch(tcfg, smpls[0][1], smpls[1][1], smpls[1][1], to_torch(batch, "cpu"),
                          tout, tcond, **kw)
    assert torch.equal(same.g_mpjpe[0], got.g_mpjpe[0])       # image 0 is male
    assert not torch.allclose(same.g_mpjpe[1], got.g_mpjpe[1])  # image 1 is female


def test_evaluate_batch_options(sampled):
    """Scores switched off are None, as in JAX; the learned backends run
    with their net and are refused without one; the 20,000-point default
    threshold applies to the squared distance."""
    from egohmr_tpu_torch.collision.neural_occupancy import load_occupancy

    jcfg, tcfg, batch, smpls, _, (tout, tcond) = sampled
    args = (tcfg, *(s[1] for s in smpls), to_torch(batch, "cpu"), tout, tcond)
    off = evaluate_batch(*args, eval_collision=False, eval_contact=False)
    assert off.coll_ratio is None and off.contact is None and off.g_mpjpe.shape == (B, S)
    only = evaluate_batch(*args, eval_collision=False)
    assert only.coll_ratio is None and only.contact.shape == (B, S)
    for backend in ("occupancy", "volsdf"):
        with pytest.raises(ValueError, match="needs a learned collision net"):
            evaluate_batch(*args, collision_backend=backend)
        # no collision score, no net needed
        assert evaluate_batch(*args, collision_backend=backend,
                              eval_collision=False).coll_ratio is None
    net = load_occupancy(os.path.join(ARTIFACTS, "occupancy_synthetic.npz"))
    learned = evaluate_batch(*args, collision_backend="occupancy", occ_net=net)
    assert learned.coll_ratio.shape == (B, S) and torch.equal(learned.contact, only.contact)
    with pytest.raises(ValueError, match="unknown collision_backend"):
        evaluate_batch(*args, collision_backend="coap")
    from egohmr_tpu_torch.collision import min_body_scene_distance

    d = min_body_scene_distance(tout["pred_vertices"].reshape(B * S, -1, 3),
                                tcond.scene_pcd.repeat_interleave(S, dim=0))
    mid = float(d.sort().values[4])  # between d^2 and d for distances under 1
    got = evaluate_batch(*args, contact_thresh=mid).contact.reshape(-1)
    assert torch.equal(got, (d * d < mid).float()) and not torch.equal(got, (d < mid).float())


@pytest.mark.parametrize("artifact", ["occupancy_synthetic.npz", "volsdf_synthetic.npz"])
def test_evaluate_batch_learned_coll_ratio_matches_jax(sampled, artifact, monkeypatch):
    """The same sampled bodies through both `evaluate_batch`es with a learned
    backend and a shipped net: every field as with the mesh SDF (rtol/atol
    1e-4, counts exactly), and the collision ratio to within the points
    whose field lies within 1e-5 of the threshold. The port's query runs in
    chunks here (QUERY_ROWS cut to 40 points a chunk)."""
    from egohmr_tpu.collision import neural_occupancy as jocc
    from egohmr_tpu.collision import neural_sdf as jsdf
    from egohmr_tpu_torch.collision import neural_occupancy as tocc
    from egohmr_tpu_torch.collision import neural_sdf as tsdf

    backend = "volsdf" if artifact.startswith("volsdf") else "occupancy"
    path = os.path.join(ARTIFACTS, artifact)
    params, cfg = (jsdf.load_sdfnet if backend == "volsdf" else jocc.load_occupancy)(path)
    net = (tsdf.load_sdfnet if backend == "volsdf" else tocc.load_occupancy)(path)
    monkeypatch.setattr(tocc, "QUERY_ROWS", B * S * 24 * 40)
    jcfg, tcfg, batch, smpls, (jout, jcond), (tout, tcond) = sampled
    jkw = dict(collision_backend=backend, occ_params=params, occ_cfg=cfg)
    want = jax.jit(lambda b, o, c: jpipe.evaluate_batch(jcfg, *(s[0] for s in smpls), b, o, c,
                                                        **jkw))(to_jax(batch), jout, jcond)
    got = evaluate_batch(tcfg, *(s[1] for s in smpls), to_torch(batch, "cpu"), tout, tcond,
                         collision_backend=backend, occ_net=net)
    for name in got._fields:
        g, w = to_np(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        if name in ("contact", "vis_count", "invis_count", "vertex_vis_count",
                    "vertex_invis_count"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif name != "coll_ratio":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, equal_nan=True, err_msg=name)
    # the field at every (body, point), JAX's, to count the near-threshold points
    n = B * S
    out_bs = jocc.SMPLOutput(
        vertices=jout["pred_vertices"].reshape(n, -1, 3),
        joints=jout["pred_keypoints_3d"].reshape(n, -1, 3),
        full_pose=jout["pred_pose_rotmat"].reshape(n, 24, 3, 3),
        joints_smpl=jout["pred_joints_smpl"].reshape(n, 24, 3))
    scene = jnp.repeat(jcond.scene_pcd, S, axis=0)
    betas = jout["pred_betas"].reshape(n, 10)
    if backend == "occupancy":
        field = jocc.occupancy_query(params, cfg, smpls[0][0], out_bs, betas, scene)
        thresh = 0.5
    else:
        field = jsdf.sdf_query(params, cfg, smpls[0][0], out_bs, betas, scene)
        thresh = 0.0
    near = np.sum(np.abs(np.asarray(field) - thresh) < 1e-5, axis=-1).reshape(B, S)
    coll_g, coll_w = to_np(got.coll_ratio), np.asarray(want.coll_ratio)
    assert np.all(np.abs(coll_g - coll_w) <= near / scene.shape[1] + 1e-7)
    assert coll_w.max() > 0  # some points are inside a body and its bbox


def test_use_stage1_transl_matches_jax():
    """With `stage1_transl_full` in the batch, `sample_bodies` conditions on
    it instead of the input translation unless told not to: both settings
    against JAX (rtol/atol 1e-4), and the two differ."""
    jcfg, tcfg, params, model = tiny_pair(seed=4)
    batch = synthetic_batch(2, num_scene_points=300, img_size=64, seed=8)
    batch["stage1_transl_full"] = batch["smpl_params"]["transl"] + np.array(
        [[0.3, -0.2, 0.4]], np.float32)
    key = jax.random.PRNGKey(5)
    x_T = np.asarray(jax.random.normal(jax.random.split(key)[1], (4, 144)))
    jside = (to_jax(params), jcfg, j_make_smpl(num_vertices=V), JStats(jnp.zeros(144), jnp.ones(144)),
             j_make_schedule(50, "cosine", "ddim5"), to_jax(batch), key, 2)
    tside = (model, tcfg, make_synthetic_model(num_vertices=V),
             BodyRepStats(torch.zeros(144), torch.ones(144)), make_schedule(50, "cosine", "ddim5"),
             to_torch(batch, "cpu"), None, 2)
    outs = {}
    for flag in (True, False):
        jout, jcond = jpipe.sample_bodies(*jside, sampler="ddim", use_stage1_transl=flag)
        tout, tcond = sample_bodies(*tside, sampler="ddim", use_stage1_transl=flag,
                                    noise=torch.tensor(x_T))
        for k in ("pred_keypoints_3d_full", "pred_vertices", "pred_keypoints_2d_full"):
            np.testing.assert_allclose(to_np(tout[k]), np.asarray(jout[k]), rtol=1e-4, atol=1e-4,
                                       err_msg=f"{k}, use_stage1_transl={flag}")
        np.testing.assert_allclose(to_np(tcond.input_transl), np.asarray(jcond.input_transl),
                                   rtol=1e-6, atol=1e-6)
        outs[flag] = tout
    want = batch["stage1_transl_full"]
    assert (outs[True]["pred_keypoints_3d_full"] - outs[False]["pred_keypoints_3d_full"]
            ).abs().max() > 0.1
    assert "stage1_transl_full" in batch and np.array_equal(batch["stage1_transl_full"], want)
    # the caller's batch keeps its own translation
    assert not np.array_equal(batch["smpl_params"]["transl"], want)


def test_cli_loads_reference_and_npz_checkpoints(tmp_path):
    """A reference-layout `.pt` loads as it is; a param tree that went
    through the JAX package's `save_npz` loads through `load_npz_tree` and
    `state_dict_from_jax` to the same weights, its trained timestep table
    `pe` too, and so does a checkpoint of the port's training CLI; an orbax
    directory is refused with the way out."""
    cfg = EgoHMRConfig(**TINY)
    _, _, params, model = tiny_pair(seed=6)
    want = model.state_dict()
    formula = model.embed_timestep.pe.clone()
    trained = formula.clone()
    trained[7] += 0.01  # a drawn row moved
    params["embed_timestep"]["pe"] = trained.numpy()
    pt = str(tmp_path / "run" / "model.pt")
    os.makedirs(os.path.dirname(pt))
    torch.save({"state_dict": want, "epoch": 3}, pt)
    ckpt = str(tmp_path / "run" / "step_3.pt")
    torch.save({"model": want, "trained_buffers": {"embed_timestep.pe": trained},
                "optimizer": {"state": {}, "param_groups": []}, "step": 3}, ckpt)
    j_save_npz(str(tmp_path / "params.npz"), to_jax(params))
    j_save_npz(str(tmp_path / "state.npz"), {"params": to_jax(params), "step": jnp.asarray(4)})
    for path in (pt, ckpt, str(tmp_path / "params.npz"), str(tmp_path / "state.npz")):
        loaded = tcli._load_model(path, cfg)
        got = loaded.state_dict()
        assert set(got) == set(want), path
        for k in want:
            assert torch.equal(got[k], want[k]), (path, k)
        assert torch.equal(loaded.embed_timestep.pe, formula if path == pt else trained), path
    os.makedirs(tmp_path / "step_100")
    with pytest.raises(ValueError, match="save_npz"):
        tcli._load_model(str(tmp_path / "step_100"), cfg)


def test_cli_refuses_what_it_cannot_do():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["--synthetic", "--num_batches", "1"])  # --device cuda by default
    for backend, flag in (("occupancy", "--occupancy_ckpt"), ("volsdf", "--sdfnet_ckpt")):
        with pytest.raises(ValueError, match=f"--collision_backend {backend} needs {flag}"):
            tcli.main(["--synthetic", "--device", "cpu", "--collision_backend", backend])


def test_cli_has_the_originals_flags_and_defaults():
    """The same flags with the same defaults, but for `--platform`, which
    the port replaces by `--device`; default overrides work as in JAX."""
    j, t = vars(jcli.parse_args([])), vars(tcli.parse_args([]))
    assert set(j) - set(t) == {"platform"} and set(t) - set(j) == {"device"}
    assert {k: v for k, v in j.items() if k != "platform"} == \
        {k: v for k, v in t.items() if k != "device"}
    assert t["device"] == "cuda"
    assert tcli.parse_args([], cond_grad_weight=30.0).cond_grad_weight == 30.0
    with pytest.raises(AssertionError):
        tcli.parse_args([], no_such_flag=1)


CLI_ARGS = ["--synthetic", "--batch_size", "2", "--num_batches", "1", "--num_samples", "2",
            "--data_parallel", "false", "--bf16", "false", "--pointnet_impl", "xla",
            "--timestep_respacing_eval", "ddim5"]


@pytest.mark.parametrize("guided,nonlocal_layer", [(False, False), (True, False), (False, True)],
                         ids=["unguided", "guided", "nonlocal"])
def test_cli_as_a_whole_matches_jax(tmp_path, monkeypatch, capsys, guided, nonlocal_layer):
    """The slice as a whole, at full width on the CPU (ResNet-50, 20,000
    scene points, 6890 vertices, 2 images x 2 samples, DDIM-5 with eta = 0):
    both CLIs on the same weights (the tree the JAX CLI draws with
    `--synthetic`, turned by `state_dict_from_jax`), the same batches
    (`synthetic_batch(seed=100)`) and the same x_T (the one the JAX CLI's
    key chain draws, handed to the port as `noise`). Summary keys equal,
    values within rtol 1e-3; the `results.pkl` each writes holds the same
    keys and shapes and the same bodies, and the port's viewer tool reads
    the port's file. `nonlocal`: `--gcn_nonlocal_layer true`, with the block's output
    BatchNorm drawn at random in both trees (its init, scale 0, makes the
    block the identity)."""
    args = CLI_ARGS + ["--with_coap_grad", "true" if guided else "false",
                       "--gcn_nonlocal_layer", "true" if nonlocal_layer else "false"]
    # the JAX CLI, with --synthetic: init_egohmr(PRNGKey(0), cfg), and per
    # batch key, sub = split(key); sample_loop draws x_T from split(sub)[1]
    cfg = JaxConfig(pointnet_impl="xla", gcn_nonlocal_layer=nonlocal_layer)
    params = init_egohmr(jax.random.PRNGKey(0), cfg)
    if nonlocal_layer:
        import egohmr_tpu.models as jmodels

        rng = np.random.RandomState(9)
        bn = params["diffusion_model"]["non_local"]["bn"]
        bn.update({k: jnp.asarray(v + 0.3 * rng.randn(*v.shape).astype(np.float32))
                   for k, v in ((k, np.asarray(bn[k])) for k in ("scale", "bias"))})
        monkeypatch.setattr(jmodels, "init_egohmr", lambda key, c: params)
    sub = jax.random.split(jax.random.PRNGKey(0))[1]
    x_T = np.asarray(jax.random.normal(jax.random.split(sub)[1], (4, 144)))

    def same_weights(tcfg):
        model = EgoHMR(tcfg)
        model.load_state_dict(state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, params)), strict=True)
        return model

    def same_noise(*a, **kw):
        return sample_bodies(*a, **{**kw, "noise": torch.tensor(x_T)})

    monkeypatch.setattr(tcli, "_synthetic_model", same_weights)
    monkeypatch.setattr(tcli, "sample_bodies", same_noise)
    save_j, save_t = str(tmp_path / "j"), str(tmp_path / "t")
    want = jcli.main(args + ["--platform", "cpu", "--save_results", "true", "--save_root", save_j])
    capsys.readouterr()
    got = tcli.main(args + ["--device", "cpu", "--save_results", "true", "--save_root", save_t])
    printed = capsys.readouterr().out
    assert list(got) == list(want)  # the same keys in the same order
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6, err_msg=k)
        assert f'"{k}"' in printed
    assert "smallest-error-sample-invis from 2 samples" in printed and "[batch 0]" in printed
    assert 0.0 <= got["coll_ratio"] <= 1.0 and 0.0 <= got["contact"] <= 1.0

    rel = os.path.join("output_egohmr_synthetic", "results_seed_0.pkl")
    with open(os.path.join(save_j, rel), "rb") as f:
        rj = pickle.load(f)
    with open(os.path.join(save_t, rel), "rb") as f:
        rt = pickle.load(f)
    assert set(rt) == set(rj)
    for k in rj:
        assert rt[k].shape == rj[k].shape and rt[k].dtype == rj[k].dtype, k
        np.testing.assert_allclose(rt[k], rj[k], rtol=1e-3, atol=1e-4, err_msg=k)

    from egohmr_tpu_torch.tools import visualize_results as vr

    written = vr.main(["--results", os.path.join(save_t, rel), "--synthetic_smpl",
                       "--indices", "0", "--views", "camera", "--img_size", "320", "180",
                       "--out_dir", str(tmp_path / "vis"), "--device", "cpu"])
    assert len(written) == 1 and os.path.exists(written[0])


def test_cli_render_and_padding_on_the_dataset_fixture(egobody_root, tmp_path):  # noqa: F811
    """The non-synthetic branch on the synthetic on-disk EgoBody fixture:
    a reference-layout checkpoint, SMPL pickles, stats, a short last batch
    padded and trimmed, renders written."""
    root = egobody_root
    cfg = EgoHMRConfig()
    os.makedirs(tmp_path / "smpl")
    for i, g in enumerate(("NEUTRAL", "MALE", "FEMALE")):
        _write_smpl_pkl(tmp_path / "smpl" / f"SMPL_{g}.pkl", i, num_vertices=6890, n_shape=12)
    ckpt = str(tmp_path / "ckpt" / "model.pt")
    os.makedirs(os.path.dirname(ckpt))
    from egohmr_tpu_torch.models import init_random_

    torch.save({"state_dict": init_random_(EgoHMR(cfg), seed=1).state_dict()}, ckpt)
    from egohmr_tpu_torch.data import save_stats

    save_stats(str(tmp_path / "stats" / "s.npz"), np.zeros(144, np.float32),
               np.ones(144, np.float32))
    summary = tcli.main([
        "--device", "cpu", "--dataset_root", root,
        "--dataset_file", os.path.join(root, "annotations.npz"),
        "--stage1_result_path", os.path.join(root, "stage1.pkl"),
        "--scene_crop_by_stage1_transl", "false", "--checkpoint", ckpt,
        "--body_rep_stats", str(tmp_path / "stats" / "s.npz"),
        "--smpl_model_path", str(tmp_path / "smpl"), "--batch_size", "4",
        "--num_samples", "2", "--timestep_respacing_eval", "ddim5", "--with_coap_grad", "false",
        "--bf16", "false", "--pointnet_impl", "xla", "--save_results", "true",
        "--save_root", str(tmp_path / "out"), "--render", "true",
        "--output_render_root", str(tmp_path / "render")])
    assert np.isfinite(summary["g_mpjpe"]) and 0.0 <= summary["coll_ratio"] <= 1.0
    with open(tmp_path / "out" / "output_egohmr_ckpt" / "results_seed_0.pkl", "rb") as f:
        res = pickle.load(f)
    # 6 items in batches of 4: the second batch is padded to 4 and trimmed to 2
    assert res["pred_betas_list"].shape == (N_ITEMS, 2, 10)
    assert res["pred_cam_full_list"].shape == (N_ITEMS, 3)
    assert len(os.listdir(tmp_path / "render")) == 4

