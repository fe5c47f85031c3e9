"""Port parity of the slices as a whole: `sample_bodies` (unguided DDIM-5,
guided DDIM-5 and guided DDPM-50) and `serving.Predictor` against
egohmr_tpu, and the import rule."""
import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egohmr_tpu.diffusion import GuidanceConfig as JGuidanceConfig
from egohmr_tpu.diffusion import make_schedule as j_make_schedule
from egohmr_tpu.eval.pipeline import sample_bodies as j_sample_bodies
from egohmr_tpu.models import BodyRepStats as JStats
from egohmr_tpu.models import EgoHMRConfig as JaxConfig
from egohmr_tpu.models import init_egohmr
from egohmr_tpu.serving import MESH_OUTPUT_KEYS as J_MESH_KEYS
from egohmr_tpu.serving import Predictor as JPredictor
from egohmr_tpu.smpl import make_synthetic_model as j_make_smpl
from egohmr_tpu_torch.data import synthetic_batch, to_torch
from egohmr_tpu_torch.diffusion import GuidanceConfig, make_schedule
from egohmr_tpu_torch.diffusion import sampler as tsampler
from egohmr_tpu_torch.eval import sample_bodies, tile_condition
from egohmr_tpu_torch.models import BodyRepStats
from egohmr_tpu_torch.serving import MESH_OUTPUT_KEYS, Predictor
from egohmr_tpu_torch.smpl import make_synthetic_model

from .torch_parity import tiny_pair, to_jax, to_np

S, V = 2, 512
KEYS = ("pred_keypoints_3d", "pred_vertices", "pred_betas")


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg, params, model = tiny_pair(seed=1)
    rng = np.random.RandomState(9)
    mean, std = rng.randn(144).astype(np.float32) * 0.1, 1 + 0.2 * rng.rand(144).astype(np.float32)
    batch = synthetic_batch(2, num_scene_points=600, img_size=64, seed=4)
    jax_side = (jcfg, to_jax(params), j_make_smpl(num_vertices=V),
                JStats(jnp.asarray(mean), jnp.asarray(std)), j_make_schedule(50, "cosine", "ddim5"))
    port_side = (model, tcfg, make_synthetic_model(num_vertices=V),
                 BodyRepStats(torch.tensor(mean), torch.tensor(std)),
                 make_schedule(50, "cosine", "ddim5"))
    return jax_side, port_side, batch


def _jax_run(setup, key, **kw):
    (jcfg, jp, jsmpl, jstats, jsched), _, batch = setup
    out, _ = j_sample_bodies(jp, jcfg, jsmpl, jstats, jsched, to_jax(batch), key, S,
                             sampler="ddim", **kw)
    # x_T exactly as sample_loop draws it from `key`
    _, sub = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(sub, (2 * S, 144)))
    return out, x_T


def test_tile_condition_is_repeat_interleave():
    from egohmr_tpu_torch.models import Condition

    c = Condition(*(torch.arange(3).reshape(3, 1) for _ in Condition._fields))
    assert tile_condition(c, 2).cond[:, 0].tolist() == [0, 0, 1, 1, 2, 2]


def test_sample_bodies_f32_matches_jax(setup):
    """The whole unguided DDIM-5 path in f32, same weights, batch and x_T:
    rtol/atol 1e-4 on keypoints, vertices and betas."""
    jout, x_T = _jax_run(setup, jax.random.PRNGKey(11))
    _, (model, tcfg, smpl, stats, sched), batch = setup
    out, _ = sample_bodies(model, tcfg, smpl, stats, sched, to_torch(batch, "cpu"),
                           None, S, sampler="ddim", noise=torch.tensor(x_T))
    for k in KEYS:
        assert out[k].shape == jout[k].shape, k
        np.testing.assert_allclose(to_np(out[k]), np.asarray(jout[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_sample_bodies_bf16_close_to_jax_f32(setup, impl):
    """The port's bf16 path (K1's plain version for "fused") stays within the
    JAX bf16 envelope of the JAX f32 bodies: mean abs < 0.05, the bar of
    tests/test_egohmr_model.py::test_sample_bodies_bf16_close_to_f32."""
    import dataclasses

    jout, x_T = _jax_run(setup, jax.random.PRNGKey(12))
    _, (model, tcfg, smpl, stats, sched), batch = setup
    out, _ = sample_bodies(model, dataclasses.replace(tcfg, pointnet_impl=impl), smpl,
                           stats, sched, to_torch(batch, "cpu"), None, S, sampler="ddim",
                           bf16=True, noise=torch.tensor(x_T))
    got = to_np(out["pred_keypoints_3d"])
    assert out["pred_keypoints_3d"].dtype == torch.float32 and np.isfinite(got).all()
    assert np.mean(np.abs(got - np.asarray(jout["pred_keypoints_3d"]))) < 0.05


def _first_then_zeros(x_T):
    """A stand-in for `jax.random.normal`: the first draw (x_T, taken
    outside the scan) is `x_T`, every later one (the per-step noise) zero."""
    calls = []

    def normal(key, shape, dtype=jnp.float32):
        calls.append(shape)
        if len(calls) == 1:
            assert tuple(shape) == x_T.shape
            return jnp.asarray(x_T, dtype)
        return jnp.zeros(shape, dtype)

    return normal


@pytest.mark.parametrize("sampler,respacing", [("ddim", "ddim5"), ("ddpm", "")])
def test_guided_sample_bodies_f32_matches_jax(setup, monkeypatch, sampler, respacing):
    """`sample_bodies(with_guidance=True)` in f32, guided DDIM-5 and guided
    zero-noise DDPM-50, same weights, batch and x_T: rtol/atol 1e-4 on
    keypoints, vertices and betas, as for the unguided path. The guidance
    weights are raised on both sides until the guided bodies differ from
    the unguided ones by over ten times that bar."""
    (jcfg, jp, jsmpl, jstats, _), (model, tcfg, smpl, stats, _), batch = setup
    x_T = np.random.RandomState(21).randn(2 * S, 144).astype(np.float32)
    weights = dict(cond_grad_weight=60.0, ddim_scale=30.0)
    monkeypatch.setattr(jax.random, "normal", _first_then_zeros(x_T))
    monkeypatch.setattr(tsampler, "_step_noise", lambda x, g: torch.zeros_like(x))
    jout, _ = j_sample_bodies(jp, jcfg, jsmpl, jstats, j_make_schedule(50, "cosine", respacing),
                              to_jax(batch), jax.random.PRNGKey(0), S, sampler=sampler,
                              with_guidance=True, guidance=JGuidanceConfig(**weights))
    sched = make_schedule(50, "cosine", respacing)
    run = lambda **kw: sample_bodies(model, tcfg, smpl, stats, sched, to_torch(batch, "cpu"),  # noqa: E731
                                     torch.Generator(), S, sampler=sampler,
                                     noise=torch.tensor(x_T), **kw)[0]
    out = run(with_guidance=True, guidance=GuidanceConfig(**weights))
    free = run()
    assert (out["pred_vertices"] - free["pred_vertices"]).abs().max() > 1e-3
    for k in KEYS:
        assert out[k].shape == jout[k].shape and not out[k].requires_grad, k
        np.testing.assert_allclose(to_np(out[k]), np.asarray(jout[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_sample_bodies_guidance_options(setup):
    """The learned collision backends are not ported and say so; the two
    option clash raises as in JAX; `guidance_refresh_every` runs; the bf16
    path hands the guidance an f32 condition."""
    _, (model, tcfg, smpl, stats, sched), batch = setup
    b = to_torch(batch, "cpu")
    run = lambda **kw: sample_bodies(model, tcfg, smpl, stats, sched, b,  # noqa: E731
                                     torch.Generator().manual_seed(0), 1, sampler="ddim", **kw)
    for backend in ("occupancy", "volsdf"):
        with pytest.raises(NotImplementedError, match="slice 7"):
            run(with_guidance=True, collision_backend=backend)
        with pytest.raises(ValueError, match="sdf-backend knob"):
            run(with_guidance=True, collision_backend=backend, guidance_refresh_every=2)
    with pytest.raises(ValueError, match="unknown collision_backend"):
        run(with_guidance=True, collision_backend="coap")
    exact = run(with_guidance=True)[0]["pred_pose_6d"]
    reuse = run(with_guidance=True, guidance_refresh_every=2)[0]["pred_pose_6d"]
    assert torch.isfinite(reuse).all() and (reuse - exact).abs().max() < 1e-2
    out, cond = run(with_guidance=True, bf16=True)
    assert cond.scene_pcd.dtype == torch.float32 and cond.pred_betas.dtype == torch.float32
    assert out["pred_pose_6d"].dtype == torch.float32 and torch.isfinite(out["pred_pose_6d"]).all()


@pytest.mark.parametrize("sampler,respacing", [("ddim", "ddim5"), ("ddpm", "")])
def test_guided_predictor_on_cpu(setup, sampler, respacing):
    """A guided `Predictor` on the CPU, bf16 as served: finite outputs,
    padded rows trimmed, the short request equal to the leading rows of the
    full one, and different from the unguided Predictor's bodies."""
    _, (model, tcfg, smpl, stats, _), _ = setup
    sched = make_schedule(50, "cosine", respacing)
    kw = dict(device="cpu", batch_size=4, num_samples=1, sampler=sampler)
    guided = Predictor(model, tcfg, smpl, stats, sched, with_guidance=True,
                       guidance=GuidanceConfig(cond_grad_weight=60.0, ddim_scale=30.0), **kw)
    free = Predictor(model, tcfg, smpl, stats, sched, **kw)
    full = _mini(4, 3)
    short = {k: ({kk: vv[:3] for kk, vv in v.items()} if isinstance(v, dict) else v[:3])
             for k, v in full.items()}
    a, b, c = guided(full, seed=2), guided(short, seed=2), free(full, seed=2)
    assert b["pred_pose_6d"].shape == (3, 1, 144)
    assert all(np.isfinite(v).all() for v in a.values())
    np.testing.assert_allclose(b["pred_pose_6d"], a["pred_pose_6d"][:3], rtol=2e-3, atol=2e-3)
    assert np.abs(a["pred_pose_6d"] - c["pred_pose_6d"]).max() > 1e-3


@pytest.fixture(scope="module")
def predictor(setup):
    _, (model, tcfg, smpl, stats, sched), _ = setup
    return Predictor(model, tcfg, smpl, stats, sched, device="cpu", batch_size=4,
                     num_samples=S, max_inflight=2, output_keys=MESH_OUTPUT_KEYS)


def _mini(n, seed):
    return synthetic_batch(n, num_scene_points=300, img_size=64, seed=seed)


def test_predictor_pads_short_requests(predictor):
    """A short request returns [n, S, ...]: exactly the leading rows of the
    same images inside a full request; oversized requests are refused."""
    full = _mini(4, 3)
    short = {k: ({kk: vv[:2] for kk, vv in v.items()} if isinstance(v, dict) else v[:2])
             for k, v in full.items()}
    a, b = predictor(full, seed=9), predictor(short, seed=9)
    assert b["pred_pose_6d"].shape == (2, S, 144)
    assert b["pred_vertices"].shape == (2, S, V, 3)
    assert all(v.dtype == np.float32 and np.isfinite(v).all() for v in b.values())
    np.testing.assert_allclose(b["pred_pose_6d"], a["pred_pose_6d"][:2], rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError):
        predictor(_mini(5, 0))


def test_predictor_layout_matches_jax(predictor, setup):
    """The packed [B, S, sum(D)] layout: the same keys in sorted order, the
    same trailing shapes and offsets as the JAX Predictor's `_layout`."""
    predictor(_mini(4, 0))
    jcfg = JaxConfig(img_feat_dim=64, backbone_type="stub", scene_feat_dim=32,
                     pointnet_hidden_dim=16, transl_embed_dim=16, timestep_embed_dim=32,
                     input_process_dim=32, gcn_hid_dim=32, gcn_layers=2)
    jpred = JPredictor(init_egohmr(jax.random.PRNGKey(0), jcfg), jcfg, j_make_smpl(num_vertices=V),
                       JStats(jnp.zeros(144), jnp.ones(144)), j_make_schedule(50, "cosine", "ddim5"),
                       batch_size=4, num_samples=S, output_keys=J_MESH_KEYS)
    jpred.submit(to_jax(_mini(4, 0)))
    assert predictor._layout == [(k, tuple(t), o, n) for k, t, o, n in jpred._layout]


def test_map_batches_in_order(predictor):
    """Results come back in input order; each equals the blocking call on
    the same batch with the same seed (request i uses seed + i)."""
    batches = [_mini(4, i) for i in range(3)] + [_mini(3, 99)]
    outs = list(predictor.map_batches(iter(batches), seed=7))
    assert len(outs) == 4 and outs[-1]["pred_pose_6d"].shape[0] == 3
    ref = predictor(batches[2], seed=9)
    np.testing.assert_allclose(outs[2]["pred_pose_6d"], ref["pred_pose_6d"], rtol=0, atol=0)


def test_port_never_imports_jax():
    """No file under the package (its `tools/`, `viz/` and `utils/`
    included) and not chip_smoke.py imports JAX or egohmr_tpu, and importing
    the package's entry points and running the CPU serving path leaves JAX
    unloaded."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "egohmr_tpu_torch")
    sources = [os.path.join(root, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, files in os.walk(pkg) for f in files if f.endswith(".py")]
    walked = {os.path.relpath(f, pkg) for f in sources[1:]}
    assert {"tools/probe_int8_mma.py", "viz/renderer.py", "utils/checkpoint.py", "native.py",
            "eval/test_egohmr.py", "data/egobody.py", "train/loop.py", "train/train_egohmr.py",
            "data/prefetch.py", "utils/logging.py", "utils/profiling.py"} <= walked
    for f in sources:
        for node in ast.walk(ast.parse(open(f).read())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "egohmr_tpu"), (f, name)
    code = (
        "import sys, torch\n"
        "from egohmr_tpu_torch.models import EgoHMR, EgoHMRConfig, BodyRepStats, init_random_\n"
        "from egohmr_tpu_torch.diffusion import make_schedule\n"
        "from egohmr_tpu_torch.smpl import make_synthetic_model\n"
        "from egohmr_tpu_torch.data import synthetic_batch\n"
        "from egohmr_tpu_torch.serving import Predictor\n"
        "cfg = EgoHMRConfig(resnet_layers=18, img_feat_dim=512, scene_feat_dim=8,\n"
        "    pointnet_hidden_dim=8, transl_embed_dim=8, timestep_embed_dim=8,\n"
        "    input_process_dim=8, gcn_hid_dim=8, gcn_layers=1)\n"
        "p = Predictor(init_random_(EgoHMR(cfg), 0), cfg, make_synthetic_model(num_vertices=64),\n"
        "    BodyRepStats(torch.zeros(144), torch.ones(144)), make_schedule(50, 'cosine', 'ddim5'),\n"
        "    device='cpu', batch_size=2)\n"
        "out = p(synthetic_batch(1, num_scene_points=64, img_size=32))\n"
        "assert out['pred_pose_6d'].shape == (1, 1, 144)\n"
        "import egohmr_tpu_torch.eval.test_egohmr, egohmr_tpu_torch.tools.probe_int8_mma\n"
        "import egohmr_tpu_torch.train.train_egohmr, egohmr_tpu_torch.utils.profiling\n"
        "import egohmr_tpu_torch.viz, egohmr_tpu_torch.utils.checkpoint, egohmr_tpu_torch.native\n"
        "assert 'jax' not in sys.modules and 'egohmr_tpu' not in sys.modules\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_pack_dtype_float16(predictor, setup):
    """fp16 packing halves the readback; clients still get float32 arrays,
    equal to the f32-packed outputs to fp16 rounding."""
    _, (model, tcfg, smpl, stats, sched), _ = setup
    p16 = Predictor(model, tcfg, smpl, stats, sched, device="cpu", batch_size=4,
                    num_samples=S, output_keys=MESH_OUTPUT_KEYS, pack_dtype=torch.float16)
    batch = _mini(4, 11)
    ref, out = predictor(batch, seed=3), p16(batch, seed=3)
    for k, v in out.items():
        assert v.dtype == np.float32, k
        np.testing.assert_allclose(v, ref[k], rtol=2e-3, atol=2e-3, err_msg=k)


def test_predictor_warmup(predictor):
    """`warmup` runs one request to its end and, as in the JAX package,
    refuses to guess the traffic's shapes."""
    with pytest.raises(ValueError, match="representative batch"):
        predictor.warmup()
    assert predictor.warmup(_mini(4, 5)) is None
    assert predictor._layout is not None
