"""Data parallelism in the PyTorch port, part 1: the helpers of
`egohmr_tpu_torch.parallel` at world 2 and 3, cross-replica BatchNorm and
the point-sharded scene encoder at world 2 against world 1 and against the
JAX package's versions under `jax.shard_map` over `make_mesh(2)`, the
multi-device `Predictor` and the refusals. Ranks are processes on a gloo
group (`torch_dp_worker.spawn`); the steps and the CLIs are
`test_torch_dp.py`'s."""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from egohmr_tpu.nn import core as jcore
from egohmr_tpu.nn.pointnet import pointnet_forward as j_pointnet_forward
from egohmr_tpu.nn.pointnet import pointnet_forward_point_sharded as j_point_sharded
from egohmr_tpu.parallel import make_mesh
from egohmr_tpu_torch.data import synthetic_batch
from egohmr_tpu_torch.diffusion import GuidanceConfig, make_schedule
from egohmr_tpu_torch.models import BodyRepStats
from egohmr_tpu_torch.nn import batchnorm, pointnet_forward
from egohmr_tpu_torch.parallel import DataParallel, draw_rows, global_rows, rows, shard_batch
from egohmr_tpu_torch.serving import Predictor
from egohmr_tpu_torch.smpl import make_synthetic_model
from egohmr_tpu_torch.utils import device as device_mod

from . import torch_dp_worker as worker
from .torch_parity import tiny_pair, to_np


def _record(rank, size):
    return DataParallel(rank=rank, size=size, group=None, device=torch.device("cpu"))


# ------------------------------------------------------------ rows, shards
@pytest.mark.parametrize("world", [2, 3])
def test_rows_and_shard_batch(world):
    """Each rank's contiguous block, in rank order, covering the batch once;
    `shard_batch` takes it from every tensor and array of a nested batch
    and keeps other leaves; a batch the world does not divide raises."""
    n = 4 * world
    blocks = [rows(_record(r, world), n) for r in range(world)]
    assert [(b.start, b.stop) for b in blocks] == [(4 * r, 4 * r + 4) for r in range(world)]
    assert rows(None, n) == slice(0, n)
    batch = {"img": torch.arange(n), "smpl_params": {"betas": np.arange(n * 2).reshape(n, 2)},
             "name": "kept", "scalar": torch.tensor(3.0)}
    got = [shard_batch(_record(r, world), batch) for r in range(world)]
    torch.testing.assert_close(torch.cat([g["img"] for g in got]), batch["img"])
    np.testing.assert_array_equal(np.concatenate([g["smpl_params"]["betas"] for g in got]),
                                  batch["smpl_params"]["betas"])
    assert all(g["name"] == "kept" and float(g["scalar"]) == 3.0 for g in got)
    assert shard_batch(None, batch) is batch
    with pytest.raises(ValueError, match="does not divide"):
        rows(_record(0, world), n + 1)


@pytest.mark.parametrize("world", [2, 3])
def test_draw_rows_keeps_each_blocks_rows_of_the_global_draw(world):
    """Every block draws for the whole batch from an equal generator and
    keeps its rows, so the blocks concatenated are the 1-way draw, bit for
    bit; a rank's record and the plain (i, n) block name the same rows."""
    n_local = 3

    def draw(n):
        g = torch.Generator().manual_seed(7)
        return torch.randn((n, 5), generator=g)

    assert global_rows(None, n_local) == n_local
    assert global_rows((1, world), n_local) == world * n_local
    whole = draw_rows(None, world * n_local, draw)
    blocks = [draw_rows((r, world), n_local, draw) for r in range(world)]
    torch.testing.assert_close(torch.cat(blocks), whole, rtol=0, atol=0)
    for r in range(world):
        torch.testing.assert_close(draw_rows(_record(r, world), n_local, draw), blocks[r],
                                   rtol=0, atol=0)
        assert rows((r, world), world * n_local) == rows(_record(r, world), world * n_local)


@pytest.fixture(scope="module", params=[2, 3], ids=["world2", "world3"])
def helpers(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(f"helpers{request.param}"))
    worker.spawn(worker.helper_cases, request.param, root)
    yield request.param, worker.load(root, "helpers", request.param)
    shutil.rmtree(root, ignore_errors=True)


def test_gather_rows_and_replicate(helpers):
    """`gather_rows` concatenates the ranks' blocks in rank order (f32 and
    int64); `replicate` leaves every rank with rank 0's parameters and
    buffers."""
    world, out = helpers
    n = 3 * world
    for o in out:
        torch.testing.assert_close(o["gather_f32"],
                                   torch.arange(n * 2, dtype=torch.float32).reshape(n, 2))
        torch.testing.assert_close(o["gather_i64"], torch.arange(n))
        for k, v in out[0]["replicated"].items():
            torch.testing.assert_close(o["replicated"][k], v, rtol=0, atol=0)
    torch.manual_seed(0)
    want = torch.nn.Linear(3, 2).state_dict()
    for k in ("weight", "bias"):
        torch.testing.assert_close(out[0]["replicated"][k], want[k], rtol=0, atol=0)
    assert int(out[0]["replicated"]["count"]) == 5


def test_mean_grads_and_metrics(helpers):
    """The gradients' and the metrics' means over the ranks, one f32 and
    one f64 buffer, on every rank."""
    world, out = helpers
    mean_rank = (world - 1) / 2
    for o in out:
        a, b = o["mean_grads"]
        torch.testing.assert_close(a, torch.full((4,), mean_rank + 1))
        assert b.dtype == torch.float64
        torch.testing.assert_close(b, torch.full((2, 3), 10 * (mean_rank + 1),
                                                 dtype=torch.float64))
        assert float(o["mean_metrics"]["loss"]) == pytest.approx(mean_rank)
        assert float(o["mean_metrics"]["other"]) == pytest.approx(2 * mean_rank)


def test_all_reduce_sum_backward_sums_the_gradient(helpers):
    """y = sum_r x_r * w on every rank; the loss sum_r (r + 1) y: the
    gradient to x_r is w times sum_r (r + 1), JAX's psum transpose."""
    world, out = helpers
    w = torch.tensor([1.0, 2.0, 3.0])
    s = world * (world + 1) / 2
    for o in out:
        y, g = o["all_reduce_sum"]
        torch.testing.assert_close(y, w * s)
        torch.testing.assert_close(g, w * s)


# ------------------------------------------- sync BatchNorm, sharded encoder
BN_LAYOUTS = {"gcn": dict(shape=(6, 24, 8), axes=(0, 1), channel_dim=-1),
              "resnet": dict(shape=(6, 5, 4, 8), axes=(0, 1, 2), channel_dim=1)}
ENC_B, ENC_P = 2, 400


def _nchw(a, layout):
    return a if layout == "gcn" else np.ascontiguousarray(a.transpose(0, 3, 1, 2))


@pytest.fixture(scope="module")
def bn_encoder(tmp_path_factory):
    """Inputs for `bn_and_encoder_cases`, its world-2 results, and the
    encoder's tiny weights (JAX and port)."""
    root = str(tmp_path_factory.mktemp("bn_encoder"))
    rng = np.random.RandomState(0)
    inp = {"bn": {}}
    bn_params = {}
    for layout, spec in BN_LAYOUTS.items():
        c = spec["shape"][-1]
        p = {"scale": 1 + 0.1 * rng.randn(c), "bias": 0.1 * rng.randn(c),
             "mean": 0.3 * rng.randn(c), "var": 1 + rng.rand(c)}
        p = {k: v.astype(np.float32) for k, v in p.items()}
        x = (rng.randn(*spec["shape"]) * 3 + 1).astype(np.float32)
        cot = rng.randn(*spec["shape"]).astype(np.float32)
        bn = torch.nn.BatchNorm1d(c)
        with torch.no_grad():
            bn.weight.copy_(torch.tensor(p["scale"]))
            bn.bias.copy_(torch.tensor(p["bias"]))
            bn.running_mean.copy_(torch.tensor(p["mean"]))
            bn.running_var.copy_(torch.tensor(p["var"]))
        bn_params[layout] = (p, x, cot)
        inp["bn"][layout] = {"c": c, "state": bn.state_dict(),
                             "x": torch.tensor(_nchw(x, layout)),
                             "cot": torch.tensor(_nchw(cot, layout)),
                             "channel_dim": spec["channel_dim"]}
    _, cfg, params, model = tiny_pair(seed=3)
    enc = model.scene_enc
    inp["enc_dims"] = (cfg.scene_feat_dim, cfg.pointnet_hidden_dim)
    inp["enc_state"] = enc.state_dict()
    inp["points"] = torch.tensor(rng.randn(ENC_B, ENC_P, 3).astype(np.float32))
    torch.save(inp, os.path.join(root, "inputs.pt"))
    worker.spawn(worker.bn_and_encoder_cases, 2, root)
    yield inp, bn_params, params["scene_enc"], enc, worker.load(root, "bn_encoder", 2)
    shutil.rmtree(root, ignore_errors=True)


def _world1_bn(case):
    bn = torch.nn.BatchNorm1d(case["c"])
    bn.load_state_dict(case["state"])
    x = case["x"].clone().requires_grad_(True)
    y = batchnorm(bn, x, case["channel_dim"], train=True)
    (y * case["cot"]).sum().backward()
    return {"y": y.detach(), "gx": x.grad, "gw": bn.weight.grad, "gb": bn.bias.grad,
            "mean": bn.running_mean, "var": bn.running_var}


@pytest.mark.parametrize("layout", list(BN_LAYOUTS))
def test_sync_batchnorm_equals_world1(bn_encoder, layout):
    """Train-mode BatchNorm at world 2, each rank on half the rows, against
    one process on all of them: the output and the gradient to x of each
    rank's rows, the summed weight and bias gradients, and the running
    statistics (unbiased by the global count), rtol 1e-5."""
    inp, _, _, _, out = bn_encoder
    want = _world1_bn(inp["bn"][layout])
    n = inp["bn"][layout]["x"].shape[0]
    for r, o in enumerate(out):
        mine = rows(_record(r, 2), n)
        o = o[layout]
        torch.testing.assert_close(o["y"], want["y"][mine], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(o["gx"], want["gx"][mine], rtol=1e-5, atol=1e-5)
        for k in ("gw", "gb", "mean", "var"):
            torch.testing.assert_close(o[k], want[k], rtol=1e-5, atol=1e-6, msg=k)


def _jax_sync_bn(p, x, cot, axes):
    """JAX's cross-replica BatchNorm under shard_map over make_mesh(2), as
    the DP train step differentiates it: per shard, then the parameter
    gradients summed over the mesh."""
    def local(x, cot, scale, bias):
        def loss(x, scale, bias):
            y, new = jcore.batchnorm({**p, "scale": scale, "bias": bias}, x, train=True,
                                     reduce_axes=axes, axis_name="data")
            return jnp.sum(y * cot), (y, new)

        (_, (y, new)), (gx, gs, gb) = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(x, scale, bias)
        return (y, gx, jax.lax.psum(gs, "data"), jax.lax.psum(gb, "data"),
                new["mean"], new["var"])

    f = jax.shard_map(local, mesh=make_mesh(2), in_specs=(P("data"), P("data"), P(), P()),
                      out_specs=(P("data"), P("data"), P(), P(), P(), P()), check_vma=False)
    return [np.asarray(a) for a in f(jnp.asarray(x), jnp.asarray(cot),
                                     jnp.asarray(p["scale"]), jnp.asarray(p["bias"]))]


@pytest.mark.parametrize("layout", list(BN_LAYOUTS))
def test_sync_batchnorm_matches_jax(bn_encoder, layout):
    """Against JAX's `batchnorm(axis_name="data")` over 2 devices: the
    output and x's gradient (rtol 1e-4), the parameter gradients and the
    running statistics, whose variance JAX unbiases by the global count
    too (rtol 1e-5)."""
    _, bn_params, _, _, out = bn_encoder
    p, x, cot = bn_params[layout]
    y, gx, gs, gb, mean, var = _jax_sync_bn(p, x, cot, BN_LAYOUTS[layout]["axes"])
    n = x.shape[0]

    def back(t):
        t = to_np(t)
        return t if layout == "gcn" else t.transpose(0, 2, 3, 1)

    for r, o in enumerate(out):
        mine = rows(_record(r, 2), n)
        o = o[layout]
        np.testing.assert_allclose(back(o["y"]), y[mine], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(back(o["gx"]), gx[mine], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(to_np(o["gw"]), gs, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(to_np(o["gb"]), gb, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(to_np(o["mean"]), mean, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(to_np(o["var"]), var, rtol=1e-5, atol=1e-6)
    # the global count, not the shard's: unbiasing by the shard's would
    # move the running variance by far more than the bar
    n_all = int(np.prod(x.shape[:-1]))
    n_shard, m = n_all // 2, 0.1
    biased = (var - (1 - m) * p["var"]) / m * (n_all - 1) / n_all
    shard_var = (1 - m) * p["var"] + m * biased * n_shard / (n_shard - 1)
    assert np.abs(shard_var / var - 1).max() > 1e-4


def test_point_sharded_encoder_equals_plain(bn_encoder):
    """Each rank encodes half of every cloud's points; both return the
    whole clouds' features: rtol 1e-5, atol 1e-6 against `pointnet_forward`
    on the whole cloud."""
    inp, _, _, enc, out = bn_encoder
    with torch.no_grad():
        want = pointnet_forward(enc, inp["points"])
    for o in out:
        torch.testing.assert_close(o["encoder"], want, rtol=1e-5, atol=1e-6)


def test_point_sharded_encoder_matches_jax(bn_encoder):
    """Against JAX's `pointnet_forward_point_sharded` over make_mesh(2), the
    points split on axis 1, and JAX's plain encoder: rtol 1e-5, atol 1e-6."""
    inp, _, jparams, _, out = bn_encoder
    pts = jnp.asarray(to_np(inp["points"]))
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    f = jax.shard_map(lambda p, x: j_point_sharded(p, x, axis_name="data"), mesh=make_mesh(2),
                      in_specs=(P(), P(None, "data")), out_specs=P(), check_vma=False)
    want = np.asarray(f(jp, pts))
    np.testing.assert_allclose(want, np.asarray(j_pointnet_forward(jp, pts)), rtol=1e-5,
                               atol=1e-6)
    for o in out:
        np.testing.assert_allclose(to_np(o["encoder"]), want, rtol=1e-5, atol=1e-6)


# -------------------------------------------------------------- Predictor
def _predictor_world():
    _, cfg, _, model = tiny_pair(seed=5)
    smpl = make_synthetic_model(seed=0, num_vertices=64)
    stats = BodyRepStats(torch.zeros(144), torch.ones(144))
    return cfg, model, smpl, stats


PREDICTOR_RUNS = {
    "ddim5": dict(sampler="ddim", respacing="ddim5", with_guidance=False),
    # the guidance, at a weight that moves the bodies
    "guided_ddim5": dict(sampler="ddim", respacing="ddim5", with_guidance=True,
                         guidance=GuidanceConfig(ddim_scale=2e4)),
}


@pytest.mark.parametrize("run", list(PREDICTOR_RUNS))
def test_predictor_over_two_devices_equals_one(run):
    """`Predictor(device=["cpu", "cpu"])`, two replicas each serving half
    of every request, against the one-device `Predictor` on the same seed,
    f32: every output at rtol 2e-4, atol 2e-4 (the JAX package's bars in
    `tests/test_serving.py`). In the guided run the guidance moves the
    outputs by more than ten times the bars, so a guidance averaged over
    half the batch (twice as strong) would fail."""
    spec = dict(PREDICTOR_RUNS[run])
    cfg, model, smpl, stats = _predictor_world()
    schedule = make_schedule(50, "cosine", spec.pop("respacing"))
    batch = synthetic_batch(4, num_scene_points=256, img_size=64, seed=2)
    kw = dict(batch_size=4, num_samples=2, bf16=False, pointnet_impl="xla", **spec)

    def serve(device, **extra):
        import copy

        p = Predictor(copy.deepcopy(model), cfg, smpl, stats, schedule, device=device,
                      **{**kw, **extra})
        return p(batch, seed=3)

    one = serve("cpu")
    two = serve(["cpu", "cpu"])
    for k in one:
        np.testing.assert_allclose(two[k], one[k], rtol=2e-4, atol=2e-4, err_msg=k)
    if spec.get("with_guidance"):
        off = serve("cpu", with_guidance=False)
        moved = np.abs(off["pred_pose_6d"] - one["pred_pose_6d"]).max()
        assert moved > 10 * 2e-4, moved


def test_predictor_refuses_what_it_cannot_do():
    """A batch the devices do not divide, a data x model grid whose model
    axis does not divide a split width (`parallel/tp.py`; the grid's own
    tests are `test_torch_tp.py`) and mixed device types each raise."""
    cfg, model, smpl, stats = _predictor_world()
    schedule = make_schedule(50, "cosine", "ddim5")
    kw = dict(batch_size=5, bf16=False, pointnet_impl="xla")
    with pytest.raises(ValueError, match="must divide"):
        Predictor(model, cfg, smpl, stats, schedule, device=["cpu", "cpu"], **kw)
    with pytest.raises(ValueError, match="does not divide by the 3-way model axis"):
        Predictor(model, cfg, smpl, stats, schedule, device=[["cpu", "cpu", "cpu"]], **kw)
    with pytest.raises(ValueError, match="one type"):
        Predictor(model, cfg, smpl, stats, schedule, device=["cpu", "meta"],
                  **{**kw, "batch_size": 4})


# --------------------------------------------------------------- refusals
def test_resolve_device_refuses_what_would_run_one_way(monkeypatch):
    """A torchrun world of several ranks with `--data_parallel false` (or
    in an entry point without the flag), and `--data_parallel true` over
    several visible cards without torchrun (the message gives the torchrun
    line), raise; one process on one device does not."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="--data_parallel is false"):
        device_mod.resolve_device("cpu", False)
    with pytest.raises(ValueError, match="runs in one process"):
        device_mod.resolve_device("cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    entry = "egohmr_tpu_torch.train.train_egohmr"
    with pytest.raises(RuntimeError, match=f"torchrun --nproc_per_node=4 -m {entry}"):
        device_mod.resolve_device("cuda", True, entry)
    assert device_mod.resolve_device("cuda", False, entry) == torch.device("cuda")
    monkeypatch.delenv("WORLD_SIZE")
    assert device_mod.resolve_device("cpu", True) == torch.device("cpu")
