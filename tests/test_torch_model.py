"""Port parity: weights, constants, SMPL, data and the stage-2 model
(compute_condition, make_denoise_fn, model_outputs) against egohmr_tpu."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egohmr_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from egohmr_tpu.interop.torch_export import export_egohmr
from egohmr_tpu.models import BodyRepStats as JStats
from egohmr_tpu.models import compute_condition as j_compute_condition
from egohmr_tpu.models import make_denoise_fn as j_make_denoise_fn
from egohmr_tpu.models import model_outputs as j_model_outputs
from egohmr_tpu.nn.core import cast_params_bf16 as j_cast_bf16
from egohmr_tpu.smpl import constants as JC
from egohmr_tpu.smpl import lbs as j_lbs
from egohmr_tpu.smpl import make_synthetic_model as j_make_smpl
from egohmr_tpu_torch.data import pad_batch, synthetic_batch, to_torch
from egohmr_tpu_torch.interop import state_dict_from_jax
from egohmr_tpu_torch.models import (
    BodyRepStats,
    Condition,
    compute_condition,
    make_denoise_fn,
    model_outputs,
)
from egohmr_tpu_torch.nn import cast_params_bf16
from egohmr_tpu_torch.smpl import constants as TC
from egohmr_tpu_torch.smpl import lbs, make_synthetic_model

from .torch_parity import tiny_pair, tmp_path, to_jax, to_np  # noqa: F401 (tmp_path: a fixture)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=0)


@pytest.fixture(scope="module")
def batch_np():
    return synthetic_batch(2, num_scene_points=600, img_size=64, seed=3)


@pytest.mark.parametrize("through_npz", [False, True], ids=["tree", "save_npz"])
def test_state_dict_equals_export_egohmr(pair, tmp_path, through_npz):
    """Key for key and value for value, and a strict load takes every key;
    also for a tree that the JAX package wrote with `save_npz` and the port
    read back with its own `load_npz_tree`."""
    _, _, params, model = pair
    want = export_egohmr(params)
    if through_npz:
        from egohmr_tpu.utils.checkpoint import save_npz
        from egohmr_tpu_torch.utils.checkpoint import load_npz_tree

        save_npz(str(tmp_path / "params.npz"), params)
        params = load_npz_tree(str(tmp_path / "params.npz"))
    got = state_dict_from_jax(params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    # tiny_pair loaded it strictly; the module's own state_dict has the same keys
    assert sorted(model.state_dict()) == sorted(want)


def test_state_dict_copies(pair):
    _, _, params, _ = pair
    sd = state_dict_from_jax(params)
    sd["scene_enc.fc_c.bias"][0] += 1.0
    assert np.asarray(params["scene_enc"]["fc_c"]["b"])[0] != sd["scene_enc.fc_c.bias"][0]


def test_constants_equal_jax():
    for name in ("PARENTS", "SMPL_EDGES", "SMPL_TO_OPENPOSE", "OPENPOSE_TO_SMPL",
                 "OPENPOSE_TO_SMPL_PELVIS_LOOSENED", "EXTRA_JOINT_VERTEX_IDS",
                 "FLIP_PERM_OPENPOSE_2D", "FLIP_PERM_SMPL_3D"):
        np.testing.assert_array_equal(getattr(TC, name), getattr(JC, name), err_msg=name)
    np.testing.assert_array_equal(TC.joint_adjacency(), JC.joint_adjacency())


@pytest.mark.parametrize("V", [512, 6890])
def test_synthetic_smpl_equals_jax(V):
    j, t = j_make_smpl(seed=2, num_vertices=V), make_synthetic_model(seed=2, num_vertices=V)
    for name in t._fields:
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), err_msg=name)


def test_synthetic_batch_and_padding(batch_np):
    j = j_synthetic_batch(2, num_scene_points=600, img_size=64, seed=3)
    for path, v in jax.tree_util.tree_leaves_with_path(j):
        got = batch_np
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(got, np.asarray(v))
    t = to_torch(batch_np, "cpu")
    direct = synthetic_batch(2, num_scene_points=600, img_size=64, seed=3, device="cpu")
    torch.testing.assert_close(direct["scene_pcd_verts_full"], t["scene_pcd_verts_full"],
                               rtol=0, atol=0)
    assert t["img"].shape == (2, 64, 64, 3)
    t["img"][0, 0, 0, 0] += 1  # copies, never aliases
    assert batch_np["img"][0, 0, 0, 0] != t["img"][0, 0, 0, 0]
    padded = pad_batch(t, 5)
    assert padded["smpl_params"]["transl"].shape == (5, 3)
    torch.testing.assert_close(padded["img"][4], t["img"][1], rtol=0, atol=0)


def test_lbs_matches_jax():
    """SMPL skinning, f32, both pose inputs: atol 1e-5."""
    j, t = j_make_smpl(seed=1, num_vertices=512), make_synthetic_model(seed=1, num_vertices=512)
    rng = np.random.RandomState(0)
    betas = rng.randn(3, 10).astype(np.float32)
    go, bp = rng.randn(3, 3).astype(np.float32) * 0.5, rng.randn(3, 69).astype(np.float32) * 0.3
    transl = rng.randn(3, 3).astype(np.float32)
    want = j_lbs(j, *map(jnp.asarray, (betas, go, bp, transl)), pose2rot=True)
    got = lbs(t, *map(torch.tensor, (betas, go, bp, transl)), pose2rot=True)
    for name in ("vertices", "joints", "full_pose", "joints_smpl"):
        np.testing.assert_allclose(to_np(getattr(got, name)),
                                   np.asarray(getattr(want, name)), atol=1e-5, rtol=0)


def _conditions(pair, batch_np, bf16=False, impl="xla"):
    jcfg, tcfg, params, model = pair
    jcfg, tcfg = (dataclasses.replace(c, pointnet_impl=impl) for c in (jcfg, tcfg))
    jp, jb, tb = to_jax(params), to_jax(batch_np), to_torch(batch_np, "cpu")
    if bf16:
        jp, model = j_cast_bf16(jp), cast_params_bf16(model)
        jb = dict(jb, img=jb["img"].astype(jnp.bfloat16))
        tb = dict(tb, img=tb["img"].to(torch.bfloat16))
    jcond, _ = j_compute_condition(jp, jcfg, jb)
    return (jcfg, tcfg, jp, model), jcond, compute_condition(model, tcfg, tb)


def test_compute_condition_matches_jax(pair, batch_np):
    _, jcond, tcond = _conditions(pair, batch_np)
    for name in tcond._fields:
        np.testing.assert_allclose(to_np(getattr(tcond, name)),
                                   np.asarray(getattr(jcond, name), np.float32),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("fuse", [True, False])
def test_denoise_fn_matches_jax(pair, batch_np, fuse):
    """make_denoise_fn (hoisted projection, fused cond/uncond batch, joint
    copy) on the same condition: rtol/atol 2e-5."""
    (jcfg, tcfg, jp, model), jcond, _ = _conditions(pair, batch_np)
    # feed both sides the same condition, so the bar isolates the denoiser
    tcond = Condition(*(torch.tensor(np.asarray(x)) for x in jcond))
    rng = np.random.RandomState(5)
    x_t = rng.randn(2, 144).astype(np.float32)
    t = np.array([7, 31])
    want = j_make_denoise_fn(jp, jcfg, jcond, fuse=fuse)(jnp.asarray(x_t), jnp.asarray(t))
    got = make_denoise_fn(model, tcfg, tcond, fuse=fuse)(torch.tensor(x_t), torch.tensor(t))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_bf16_path_runs_denoiser_in_bf16(pair, batch_np, impl):
    """Mirror of tests/test_egohmr_model.py::test_bf16_path_runs_denoiser_in_bf16:
    with cast params and a bf16 image the whole conditioning tensor and the
    denoiser run in bf16 — also when K1 hands back its f32 pooled feature.
    The scene cloud and the betas head stay f32."""
    (_, tcfg, _, model), _, cond = _conditions(pair, batch_np, bf16=True, impl=impl)
    assert cond.cond.dtype == torch.bfloat16
    assert cond.cond_uncond.dtype == torch.bfloat16
    assert cond.scene_pcd.dtype == torch.float32
    assert cond.pred_betas.dtype == torch.float32
    out = make_denoise_fn(model, tcfg, cond)(torch.zeros(2, 144, dtype=torch.bfloat16),
                                             torch.zeros(2, dtype=torch.int64))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


def test_bf16_betas_head_uses_rounded_weights(pair, batch_np):
    """The betas head takes f32 inputs with bf16-cast weights and computes
    in f32 from the rounded weights, as JAX promotes: same values as JAX's
    bf16 path on the same condition inputs."""
    _, jcond, tcond = _conditions(pair, batch_np, bf16=True)
    np.testing.assert_allclose(to_np(tcond.pred_betas), np.asarray(jcond.pred_betas),
                               rtol=2e-2, atol=2e-3)


def test_model_outputs_match_jax(pair, batch_np):
    """SMPL + reprojection of a denoised pose, on the same condition,
    with non-trivial pose stats."""
    (jcfg, tcfg, _, _), jcond, _ = _conditions(pair, batch_np)
    tcond = Condition(*(torch.tensor(np.asarray(x)) for x in jcond))
    rng = np.random.RandomState(6)
    mean, std = rng.randn(144).astype(np.float32) * 0.1, 1 + rng.rand(144).astype(np.float32)
    x0 = rng.randn(2, 144).astype(np.float32)
    jsmpl, tsmpl = j_make_smpl(num_vertices=512), make_synthetic_model(num_vertices=512)
    want = j_model_outputs(jcfg, jsmpl, jcond, jnp.asarray(x0),
                           JStats(jnp.asarray(mean), jnp.asarray(std)))
    got = model_outputs(tcfg, tsmpl, tcond, torch.tensor(x0),
                        BodyRepStats(torch.tensor(mean), torch.tensor(std)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
