"""Tensor parallelism in the PyTorch port (`egohmr_tpu_torch.parallel.tp`)
against the port's dense forwards and against the JAX package's GSPMD
placement (`egohmr_tpu.parallel.tp`) on `make_dp_tp_mesh(2, 4)` over the
8 virtual CPU devices of `tests/conftest.py`. The port's grid is 2 x 4 of
"cpu": one process drives every shard, as on a card.

The same randomised weights reach both packages through
`interop.state_dict_from_jax`. Split vs dense: rtol 1e-5 / atol 1e-6 for
the networks (the JAX package's bars), rtol 1e-4 / atol 1e-5 for sampling.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from egohmr_tpu.models import Condition as JCondition
from egohmr_tpu.models import make_denoise_fn as j_make_denoise_fn
from egohmr_tpu.nn.gcn import modulated_gcn_forward as j_gcn_forward
from egohmr_tpu.nn.pointnet import pointnet_forward as j_pointnet_forward
from egohmr_tpu.parallel import egohmr_tp_specs as j_egohmr_tp_specs
from egohmr_tpu.parallel import gcn_tp_specs as j_gcn_tp_specs
from egohmr_tpu.parallel import make_dp_tp_mesh
from egohmr_tpu.parallel import place_params as j_place_params
from egohmr_tpu.parallel import pointnet_tp_specs as j_pointnet_tp_specs
from egohmr_tpu.smpl import constants as JC
from egohmr_tpu_torch.data import synthetic_batch, to_torch
from egohmr_tpu_torch.diffusion import GuidanceConfig, make_schedule
from egohmr_tpu_torch.eval import sample_bodies
from egohmr_tpu_torch.interop import export_arrays
from egohmr_tpu_torch.models import BodyRepStats, Condition, compute_condition, make_denoise_fn
from egohmr_tpu_torch.nn import (
    modulated_gcn_forward,
    modulated_gcn_forward_tp,
    pointnet_forward,
    pointnet_forward_tp,
)
from egohmr_tpu_torch.parallel import (
    REPLICATED,
    egohmr_tp_specs,
    gcn_tp_specs,
    make_dp_tp_grid,
    place_params,
    pointnet_tp_specs,
    shard_batch,
)
from egohmr_tpu_torch.serving import Predictor
from egohmr_tpu_torch.smpl import make_synthetic_model

from .torch_parity import tiny_pair, to_jax, to_np

DP, TP = 2, 4
GRID = make_dp_tp_grid(DP, TP, ["cpu"] * (DP * TP))
NET_BARS = dict(rtol=1e-5, atol=1e-6)
SAMPLE_BARS = dict(rtol=1e-4, atol=1e-5)


def _jax_mesh():
    if len(jax.devices()) < DP * TP:
        pytest.fail(f"tests/conftest.py gives JAX {len(jax.devices())} CPU devices, not 8")
    return make_dp_tp_mesh(DP, TP)


def _by_rows(placed, fn, *inputs):
    """`fn(row's placement, row's block of each input)` over the grid's
    rows, the blocks concatenated in row order."""
    return torch.cat([fn(p, *(shard_batch((r, len(placed)), x) for x in inputs))
                      for r, p in enumerate(placed)])


# --------------------------------------------------------------- networks
def test_pointnet_tp_matches_dense_and_jax():
    """The split PointNet on the 2 x 4 grid against the dense port and
    against JAX's forward on params placed over `make_dp_tp_mesh(2, 4)`,
    rtol 1e-5 / atol 1e-6; each block's hidden width is really cut 4 ways
    and the row's module holds none of it."""
    _, _, params, model = tiny_pair(seed=0)
    enc = model.scene_enc
    pts = np.random.RandomState(1).randn(4, 128, 3).astype(np.float32)
    dense = pointnet_forward(enc, torch.tensor(pts))
    placed = place_params(GRID, enc, pointnet_tp_specs(enc))
    got = _by_rows(placed, pointnet_forward_tp, torch.tensor(pts))
    np.testing.assert_allclose(to_np(got), to_np(dense), **NET_BARS)

    H = enc.block_1.fc_0.weight.shape[0]
    for p in placed:
        assert [sh["block_1.fc_0.weight"].shape for sh in p.shards] == [(H // TP, 2 * H)] * TP
        assert [sh["block_1.fc_1.weight"].shape for sh in p.shards] == [(H, H // TP)] * TP
        assert p.module.block_1.fc_0.weight.numel() == 0
        with pytest.raises(RuntimeError):  # the dense forward cannot run on a placed row
            pointnet_forward(p.module, torch.tensor(pts))

    mesh = _jax_mesh()
    jp = j_place_params(mesh, to_jax(params["scene_enc"]), j_pointnet_tp_specs(params["scene_enc"]))
    want = jax.jit(j_pointnet_forward)(jp, jax.device_put(jnp.asarray(pts),
                                                          NamedSharding(mesh, P("data"))))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **NET_BARS)


@pytest.mark.parametrize("nonlocal_layer", [False, True], ids=["plain", "nonlocal"])
def test_gcn_tp_matches_dense_and_jax(nonlocal_layer):
    """The split GCN (and its non-local block: logits summed over the
    shards before the f32 softmax) on the 2 x 4 grid against the dense
    port and JAX's placed forward, rtol 1e-5 / atol 1e-6."""
    _, cfg, params, model = tiny_pair(seed=1, gcn_nonlocal_layer=nonlocal_layer)
    gcn = model.diffusion_model
    adj = torch.tensor(JC.joint_adjacency(), dtype=torch.float32)
    x = np.random.RandomState(2).randn(4, 24, cfg.gcn_in_dim).astype(np.float32)
    dense = modulated_gcn_forward(gcn, adj, torch.tensor(x))
    placed = place_params(GRID, gcn, gcn_tp_specs(gcn))
    got = _by_rows(placed, lambda p, xs: modulated_gcn_forward_tp(p, adj, xs), torch.tensor(x))
    np.testing.assert_allclose(to_np(got), to_np(dense), **NET_BARS)
    hid = cfg.gcn_hid_dim
    assert placed[0].shards[3]["gconv_layers.0.gconv1.gconv.W"].shape == (2, hid, hid // TP)
    assert placed[0].shards[3]["gconv_layers.0.gconv2.gconv.W"].shape == (2, hid // TP, hid)

    mesh = _jax_mesh()
    jp = j_place_params(mesh, to_jax(params["diffusion_model"]),
                        j_gcn_tp_specs(params["diffusion_model"]))
    jadj = jnp.asarray(JC.joint_adjacency(), jnp.float32)
    want = jax.jit(lambda p, x: j_gcn_forward(p, jadj, x, train=False)[0])(
        jp, jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data"))))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **NET_BARS)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_denoise_fn_tp_matches_dense_and_jax(fuse):
    """`make_denoise_fn(tp=)` (each shard projects the condition with its
    own columns of the input layer) against the dense one and against
    JAX's on placed params, on the same condition, x_t and t."""
    jcfg, tcfg, params, model = tiny_pair(seed=2)
    batch = synthetic_batch(4, num_scene_points=300, img_size=64, seed=4)
    with torch.no_grad():
        cond = compute_condition(model, tcfg, to_torch(batch, "cpu"))
    jcond = JCondition(*(jnp.asarray(v.numpy()) for v in cond))
    rng = np.random.RandomState(5)
    x_t = rng.randn(4, 144).astype(np.float32)
    t = np.array([3, 17, 29, 41])
    dense = make_denoise_fn(model, tcfg, cond, fuse=fuse)(torch.tensor(x_t), torch.tensor(t))
    placed = place_params(GRID, model, egohmr_tp_specs(model))

    def row(p, c, x, tt):
        return make_denoise_fn(p.module, tcfg, Condition(*c), fuse=fuse, tp=p)(x, tt)

    got = _by_rows(placed, row, tuple(cond), torch.tensor(x_t), torch.tensor(t))
    np.testing.assert_allclose(to_np(got), to_np(dense), **NET_BARS)

    mesh = _jax_mesh()
    jp = j_place_params(mesh, to_jax(params), j_egohmr_tp_specs(params))
    want = jax.jit(lambda p, c, x, tt: j_make_denoise_fn(p, jcfg, c, fuse=fuse)(x, tt))(
        jp, jcond, jnp.asarray(x_t), jnp.asarray(t))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------- sampling
def _world(**overrides):
    _, cfg, _, model = tiny_pair(seed=5, **overrides)
    smpl = make_synthetic_model(seed=0, num_vertices=64)
    stats = BodyRepStats(torch.zeros(144), torch.ones(144))
    return cfg, model, smpl, stats


RUNS = {
    "ddim5": dict(with_guidance=False),
    # at a weight where the guidance moves the bodies by far more than ten
    # times the bar (asserted below). At 2e4 (test_torch_parallel.py's
    # weight) the guided step amplifies the f32 rounding of ANY split of
    # the batch or the model beyond this bar, the flat two-replica
    # Predictor's too, which that file holds to 2e-4 / 2e-4
    "guided_ddim5": dict(with_guidance=True, guidance=GuidanceConfig(ddim_scale=5e3)),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_sample_bodies_tp_matches_dense(run):
    """`sample_bodies(tp=)` on a 1 x 4 grid (pure tensor parallelism, the
    GCN with its non-local block) against the dense port on the same
    noise, DDIM-5, f32: every output at rtol 1e-4 / atol 1e-5. The guided
    bodies move by over ten times that bar from the unguided ones."""
    cfg, model, smpl, stats = _world(gcn_nonlocal_layer=True)
    schedule = make_schedule(50, "cosine", "ddim5")
    batch = to_torch(synthetic_batch(2, num_scene_points=256, img_size=64, seed=6), "cpu")
    noise = torch.randn(2 * 3, 144, generator=torch.Generator().manual_seed(7))
    (placed,) = place_params(make_dp_tp_grid(1, TP, ["cpu"] * TP), model,
                             egohmr_tp_specs(model))

    def sample(m, tp=None, **kw):
        out, _ = sample_bodies(m, cfg, smpl, stats, schedule, batch, None, 3, sampler="ddim",
                               noise=noise, tp=tp, **{**RUNS[run], **kw})
        return out

    dense, got = sample(model), sample(placed.module, placed)
    for k in dense:
        np.testing.assert_allclose(to_np(got[k]), to_np(dense[k]), **SAMPLE_BARS, err_msg=k)
    if RUNS[run]["with_guidance"]:
        off = sample(model, with_guidance=False)
        moved = float((off["pred_pose_6d"] - dense["pred_pose_6d"]).abs().max())
        assert moved > 10 * SAMPLE_BARS["rtol"], moved


def _serve(model, cfg, smpl, stats, device, run="ddim5", **kw):
    schedule = make_schedule(50, "cosine", "ddim5")
    batch = synthetic_batch(4, num_scene_points=256, img_size=64, seed=2)
    p = Predictor(copy.deepcopy(model), cfg, smpl, stats, schedule, device=device,
                  **{**dict(batch_size=4, num_samples=2, bf16=False, pointnet_impl="xla",
                            sampler="ddim"), **RUNS[run], **kw})
    return p, p(batch, seed=3)


@pytest.mark.parametrize("run", list(RUNS))
def test_predictor_on_the_grid_equals_one_device(run):
    """`Predictor(device=<2 x 4 grid>)` against the one-device `Predictor`
    on the same seed, f32: every output at rtol 1e-4 / atol 1e-5. Each row
    serves half of every request, with its rows of the whole batch's noise
    and the guidance's mean over the whole batch."""
    cfg, model, smpl, stats = _world()
    _, one = _serve(model, cfg, smpl, stats, "cpu", run)
    pred, grid = _serve(model, cfg, smpl, stats, GRID, run)
    assert pred.tp == TP and len(pred.devices) == DP
    for k in one:
        np.testing.assert_allclose(grid[k], one[k], **SAMPLE_BARS, err_msg=k)


def test_predictor_switches_k1_off_under_a_model_axis():
    """Under tp > 1 the serving default `pointnet_impl="fused"` becomes
    the split plain encoder, as `self.cfg` shows; the bf16 default runs and
    stays within bf16's reach of the one-device plain bf16 run."""
    cfg, model, smpl, stats = _world()
    pred, grid = _serve(model, cfg, smpl, stats, GRID, bf16=True, pointnet_impl="fused")
    assert pred.cfg.pointnet_impl == "xla"
    _, one = _serve(model, cfg, smpl, stats, "cpu", bf16=True)
    assert all(np.isfinite(v).all() for v in grid.values())
    gap = float(np.mean(np.abs(grid["pred_keypoints_3d"] - one["pred_keypoints_3d"])))
    assert gap < 0.05, gap


def test_one_by_tp_and_dp_by_one_grids():
    """A 1 x 4 grid (pure tensor parallelism) equals one device at the
    sampling bars; a 2 x 1 grid is the flat two-replica `Predictor`, bit
    for bit, with the serving default `pointnet_impl` kept."""
    cfg, model, smpl, stats = _world()
    _, one = _serve(model, cfg, smpl, stats, "cpu")
    _, pure = _serve(model, cfg, smpl, stats, make_dp_tp_grid(1, TP, ["cpu"] * TP))
    for k in one:
        np.testing.assert_allclose(pure[k], one[k], **SAMPLE_BARS, err_msg=k)
    p21, col = _serve(model, cfg, smpl, stats, make_dp_tp_grid(DP, 1, ["cpu"] * DP),
                      pointnet_impl="fused")
    _, flat = _serve(model, cfg, smpl, stats, ["cpu"] * DP, pointnet_impl="fused")
    assert p21.tp == 1 and p21.cfg.pointnet_impl == "fused"
    for k in flat:
        np.testing.assert_array_equal(col[k], flat[k], err_msg=k)


# ------------------------------------------------------------------ rules
@pytest.mark.parametrize("nonlocal_layer", [False, True], ids=["plain", "nonlocal"])
def test_rules_cover_every_key_and_equal_jax(nonlocal_layer):
    """`egohmr_tp_specs` names every `state_dict` key, and leaf for leaf
    splits the dimension that JAX's `egohmr_tp_specs` splits: each JAX leaf
    becomes an array that varies along its "model" axis only, and through
    the interop names the port's tensor must vary along its rule's `dim`
    only (nowhere for a replicated one)."""
    _, _, params, model = tiny_pair(seed=3, gcn_nonlocal_layer=nonlocal_layer)
    specs = egohmr_tp_specs(model)
    assert sorted(specs) == sorted(model.state_dict())
    for k, p in specs.items():
        assert p.kind in ("replicated", "column", "row"), k
        assert (p.kind == "replicated") == (p.dim is None), k

    def marker(a, spec):
        a = np.asarray(a)
        axes = [i for i, name in enumerate(spec) if name == "model"]
        if not axes:
            return np.zeros(a.shape, np.float32)
        shape = [1] * a.ndim
        shape[axes[0]] = a.shape[axes[0]]
        return np.broadcast_to(np.arange(1, a.shape[axes[0]] + 1, dtype=np.float32).reshape(shape),
                               a.shape).copy()

    marked = jax.tree_util.tree_map(marker, params, j_egohmr_tp_specs(params))
    exported = export_arrays(marked)
    assert set(exported) == set(specs)
    for k, arr in exported.items():
        varies = [d for d in range(arr.ndim) if arr.shape[d] > 1 and np.ptp(arr, axis=d).max() > 0]
        want = [] if specs[k] == REPLICATED else [specs[k].dim]
        assert varies == want, (k, varies, specs[k])
    n_split = sum(p != REPLICATED for p in specs.values())
    assert n_split == 12 + 24 + (7 if nonlocal_layer else 0)


# --------------------------------------------------------------- refusals
def test_refusals():
    """A model axis that does not divide a split width, a batch that the
    data rows do not divide, ragged or mixed grids, too few devices for a
    grid, and training through a split network each raise."""
    cfg, model, smpl, stats = _world()
    schedule = make_schedule(50, "cosine", "ddim5")
    kw = dict(bf16=False, pointnet_impl="xla")
    with pytest.raises(ValueError, match="does not divide by the 3-way model axis"):
        place_params(make_dp_tp_grid(1, 3, ["cpu"] * 3), model, egohmr_tp_specs(model))
    with pytest.raises(ValueError, match="does not divide by the 3-way model axis"):
        Predictor(model, cfg, smpl, stats, schedule, device=[["cpu"] * 3], batch_size=2, **kw)
    with pytest.raises(ValueError, match="batch_size 5 must divide by the 2 data rows"):
        Predictor(model, cfg, smpl, stats, schedule, device=GRID, batch_size=5, **kw)
    with pytest.raises(ValueError, match="one non-zero width"):
        Predictor(model, cfg, smpl, stats, schedule, device=[["cpu", "cpu"], ["cpu"]], **kw)
    with pytest.raises(ValueError, match="all be rows"):
        Predictor(model, cfg, smpl, stats, schedule, device=[["cpu", "cpu"], "cpu"], **kw)
    with pytest.raises(ValueError, match="need 8 devices"):
        make_dp_tp_grid(2, 4, ["cpu"] * 7)
    with pytest.raises(ValueError, match="specs do not match"):
        place_params(GRID, model, pointnet_tp_specs(model.scene_enc))

    (placed,) = place_params(make_dp_tp_grid(1, 2, ["cpu"] * 2), model, egohmr_tp_specs(model))
    adj = torch.tensor(JC.joint_adjacency(), dtype=torch.float32)
    with pytest.raises(ValueError, match="inference only"):
        modulated_gcn_forward_tp(placed.sub("diffusion_model"), adj,
                                 torch.zeros(1, 24, cfg.gcn_in_dim), train=True)
    batch = to_torch(synthetic_batch(2, num_scene_points=64, img_size=64, seed=0), "cpu")
    with pytest.raises(ValueError, match="train=True"):
        compute_condition(placed.module, cfg, batch, train=True, tp=placed)
    with pytest.raises(ValueError, match="pointnet_impl='fused'"):
        compute_condition(placed.module, dataclasses.replace(cfg, pointnet_impl="fused"), batch,
                          tp=placed)
