"""The port's measurement entry points on the CPU: the forward-only seam of
the guidance against egohmr_tpu, the bench's two DDIM-5 variants against
each other, and every mode of `python -m egohmr_tpu_torch.bench` and of
the two tools at `--quick --cpu --iters 1` (one JSON line under the JAX
bench's metric name), and their fast failure without a CUDA device.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egohmr_tpu.eval.pipeline import sample_bodies as j_sample_bodies
from egohmr_tpu.models import BodyRepStats as JStats
from egohmr_tpu.models import Condition as JCondition
from egohmr_tpu.models import make_guidance_fn as j_make_guidance_fn
from egohmr_tpu.smpl import make_synthetic_model as j_make_smpl
from egohmr_tpu_torch import bench
from egohmr_tpu_torch.data import synthetic_batch
from egohmr_tpu_torch.diffusion import make_schedule
from egohmr_tpu_torch.eval.pipeline import sample_bodies
from egohmr_tpu_torch.models import BodyRepStats, Condition, make_guidance_fn
from egohmr_tpu_torch.smpl import make_synthetic_model
from egohmr_tpu_torch.tools import probe_guided_backward, profile_serving

from .torch_parity import TINY

B, V, P = 3, 431, 1024


@pytest.fixture(scope="module")
def guidance_setup():
    """A scene dense around the body (hundreds of points in its bbox, so
    the collision loss is far from 0), the same numpy draws on both
    sides; the `Condition` fields guidance does not read are dummies."""
    rng = np.random.RandomState(0)
    betas = (rng.randn(B, 10) * 0.3).astype(np.float32)
    scene = (rng.randn(B, P, 3) * [0.35, 0.6, 0.25]).astype(np.float32)
    mean = (rng.randn(144) * 0.1).astype(np.float32)
    std = (1 + 0.2 * rng.rand(144)).astype(np.float32)
    x = (rng.randn(B, 144) * 0.3).astype(np.float32)

    def cond(cls, conv):
        fields = {f: conv(np.zeros((B, 1), np.float32)) for f in cls._fields}
        fields.update(pred_betas=conv(betas), scene_pcd=conv(scene))
        return cls(**fields)

    J = lambda a: jnp.asarray(np.array(a))  # noqa: E731
    T = lambda a: torch.tensor(np.array(a))  # noqa: E731
    jax_side = (j_make_smpl(num_vertices=V), cond(JCondition, J), JStats(J(mean), J(std)))
    port_side = (make_synthetic_model(num_vertices=V), cond(Condition, T),
                 BodyRepStats(T(mean), T(std)))
    return jax_side, port_side, x


def _guidance_pair(setup, **kw):
    (jsmpl, jcond, jstats), (smpl, cond, stats), x = setup
    jfn = j_make_guidance_fn({}, None, jsmpl, jcond, jstats, sdf_block_size=256, **kw)
    tfn = make_guidance_fn(None, None, smpl, cond, stats, **kw)
    want = np.asarray(jfn(jnp.asarray(x), jnp.zeros((B,), jnp.int32)))
    with torch.no_grad():  # as inside sample_bodies
        got = tfn(torch.tensor(x), torch.zeros(B, dtype=torch.int64))
    return want, got


@pytest.mark.parametrize("caps", [dict(), dict(max_scene_points=None, per_step_points=None)])
def test_forward_only_guidance_matches_jax(guidance_setup, caps):
    """grad_mode="forward-only" returns the loss x 1e-24 broadcast to x_t's
    shape, as JAX does: both under 1e-18 everywhere, one value per call,
    and equal at rtol 1e-4 once divided by 1e-24 (the loss is far from
    0 on this scene)."""
    want, got = _guidance_pair(guidance_setup, grad_mode="forward-only", **caps)
    assert got.shape == (B, 144) and got.dtype == torch.float32 and not got.requires_grad
    got = got.numpy()
    assert np.abs(want).max() < 1e-18 and np.abs(got).max() < 1e-18
    assert np.all(got == got.flat[0]) and np.all(want == want.flat[0])
    assert abs(want.flat[0] / 1e-24) > 1e-3
    np.testing.assert_allclose(got / 1e-24, want / 1e-24, rtol=1e-4)


def test_exact_mode_is_unchanged(guidance_setup):
    """grad_mode="exact" is the default, bit for bit, with and without the
    selection reuse (`tests/test_torch_guidance.py` holds the default to
    JAX); an unknown mode raises."""
    (_, _, _), (smpl, cond, stats), x = guidance_setup
    t = torch.zeros(B, dtype=torch.int64)
    with torch.no_grad():
        for refresh in (1, 3):
            fns = [make_guidance_fn(None, None, smpl, cond, stats,
                                    selection_refresh_every=refresh, **kw)
                   for kw in (dict(grad_mode="exact"), dict())]
            if refresh == 1:
                got, want = (fn(torch.tensor(x), t) for fn in fns)
            else:
                got, want = (fn.fn(torch.tensor(x), t, fn.init_state(None), True)[0]
                             for fn in fns)
            assert got.abs().max() > 1e-4
            np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="grad_mode"):
        make_guidance_fn(None, None, smpl, cond, stats, grad_mode="backward-only")


@pytest.mark.parametrize("backend", ["volsdf", "occupancy"])
def test_guidance_grad_mode_refuses_the_learned_backends(backend):
    """Anything but "exact" is a seam of the mesh SDF's guidance: both
    packages raise the same ValueError for a learned backend, before
    anything runs."""
    kw = dict(collision_backend=backend, guidance_grad_mode="forward-only")
    with pytest.raises(ValueError) as jerr:
        j_sample_bodies(None, None, None, None, None, {}, None, 1, **kw)
    with pytest.raises(ValueError) as terr:
        sample_bodies(None, None, None, None, None, {}, None, 1, **kw)
    assert str(terr.value) == str(jerr.value)
    assert "profiling seam" in str(terr.value)


def _tiny_run(pointnet_impl="fused"):
    cfg = bench.model_config(False, **TINY, pointnet_impl=pointnet_impl)
    cpu = torch.device("cpu")
    model = bench.random_model(cfg, cpu)
    smpl = make_synthetic_model(num_vertices=128)
    schedule = make_schedule(50, "cosine", "ddim5")
    batch = synthetic_batch(3, num_scene_points=300, img_size=32, seed=4, device=cpu)
    noise = torch.tensor(np.random.RandomState(5).randn(3, 144).astype(np.float32))
    return cfg, model, smpl, bench.unit_stats(cpu), schedule, batch, noise


def test_sample_bodies_forward_only_is_unguided():
    """Through `sample_bodies`, forward-only guidance runs the selection and
    the forward pass but applies a nil shift: guided DDIM-5 in f32 gives
    the unguided bodies of the same x_T (rtol 1e-6, atol 1e-7), while
    the exact guidance at raised weight moves them."""
    from egohmr_tpu_torch.diffusion import GuidanceConfig

    cfg, model, smpl, stats, schedule, batch, noise = _tiny_run()
    batch = dict(batch, scene_pcd_verts_full=batch["smpl_params"]["transl"][:, None]
                 + 0.4 * torch.tensor(np.random.RandomState(6).randn(3, 300, 3)
                                      .astype(np.float32)))

    def run(**kw):
        out, _ = sample_bodies(model, cfg, smpl, stats, schedule, batch, None, 1,
                               sampler="ddim", noise=noise, **kw)
        return out["pred_pose_6d"].numpy()

    plain = run()
    guided = dict(with_guidance=True, guidance=GuidanceConfig(ddim_scale=3e4))
    fwd = run(guidance_grad_mode="forward-only", **guided)
    np.testing.assert_allclose(fwd, plain, rtol=1e-6, atol=1e-7)
    assert np.abs(run(**guided) - plain).max() > 1e-4


@pytest.mark.parametrize("pointnet_impl", ["fused", "xla"])
def test_fused_pipeline_equals_reference_architecture(pointnet_impl):
    """In f32 the bench's fused pipeline (conditioning once, the GCN's
    conditioning projection hoisted) and its reference-architecture
    variant (the whole conditioning again at every step, the DDIM update
    written out) do the same work: the same pred_keypoints_3d for the same
    x_T at rtol 1e-4, atol 1e-5."""
    cfg, model, smpl, stats, schedule, batch, noise = _tiny_run(pointnet_impl)
    fused = bench.fused_pipeline(model, cfg, smpl, stats, schedule, batch, None, 1,
                                 bf16=False, noise=noise)
    fences = []
    ref = bench.reference_pipeline(model, cfg, smpl, stats, schedule, batch, noise,
                                   fence=lambda: fences.append(1))
    assert fused.shape == ref.shape == (3, 45, 3)
    assert len(fences) == schedule.num_timesteps + 1
    np.testing.assert_allclose(fused.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


# (argv, metric, unit): bench.py's metric names, bench.py:207 (the
# unreachable-device line), :522, :693, :783, :878, :1023;
# tools/profile_serving.py:154; tools/probe_guided_backward.py:105
BENCH_MODES = [
    ([], "ddim5_samples_per_sec_per_chip", "samples/s"),
    (["--guided"], "guided_ddpm50_samples_per_sec_per_chip", "samples/s"),
    (["--guided-ddim"], "guided_ddim5_samples_per_sec_per_chip", "samples/s"),
    (["--serving"], "serving_predictor_samples_per_sec_per_chip", "samples/s"),
    (["--serving", "--pack16"], "serving_predictor_samples_per_sec_per_chip_pack16",
     "samples/s"),
    (["--train"], "train_step_imgs_per_sec_per_chip", "imgs/s"),
    (["--host"], "host_pipeline_imgs_per_sec", "imgs/s"),
]
TOOLS = [
    (profile_serving, ["--sweep", "1", "--stream", "3", "--reps", "1"], "serving_profile"),
    (probe_guided_backward, [], "guided_ddpm50_backward_decomposition"),
]


def _one_json_line(capsys) -> dict:
    out = capsys.readouterr().out
    lines = [line for line in out.splitlines() if line.startswith("{")]
    assert len(lines) == 1, out
    return json.loads(lines[0])


@pytest.mark.parametrize("argv,metric,unit", BENCH_MODES, ids=lambda a: str(a))
def test_bench_mode_prints_one_json_line(argv, metric, unit, capsys):
    """Each mode at --quick --cpu --iters 1: one JSON line with bench.py's
    metric name, a positive value, the CPU named as the device; every
    request program a mode times is handed to the request hook first, and
    one untimed request of it runs."""
    names = []

    def hook(name, request):
        names.append(name)
        request()

    assert bench.main(argv + ["--quick", "--cpu", "--iters", "1"], request_hook=hook) == 0
    d = _one_json_line(capsys)
    assert (d["metric"], d["unit"]) == (metric, unit)
    assert d["value"] > 0 and np.isfinite(d["value"])
    assert d["extra"]["device"] == "cpu" and d["extra"]["platform"] == "cpu"
    if argv == []:
        assert d["vs_baseline"] > 0 and d["companion_benchmarks"] is None
        for k in ("vs_baseline_jitted", "vs_baseline_dispatch",
                  "vs_baseline_dispatch_local_projection"):
            assert d["extra"][k] > 0, k
        assert names == ["fused", "reference-architecture"]
    elif argv == ["--train"]:
        assert d["extra"]["precision"] == "bf16_mixed" and d["extra"]["collision_loss"]
        assert names == ["train step"]
    elif argv == ["--host"]:
        assert names == [] and d["vs_baseline"] > 0
    else:
        assert len(names) == 1


@pytest.mark.parametrize("tool,argv,metric", TOOLS, ids=lambda a: getattr(a, "__name__", ""))
def test_tool_prints_one_json_line(tool, argv, metric, capsys):
    """Each tool at --quick --cpu --iters 1: one JSON line with the JAX
    tool's metric name and its fields; on the CPU the device columns are
    null."""
    names = []
    assert tool.main(argv + ["--quick", "--cpu", "--iters", "1"],
                     request_hook=lambda name, request: names.append(name)) == 0
    d = _one_json_line(capsys)
    assert d["metric"] == metric and d["device"] == "cpu"
    if tool is profile_serving:
        for k in ("submit_ms", "d2h_ms", "blocking_ms", "device_ms_host_clock"):
            assert d[k] > 0, k
        assert d["device_ms"] is None and d["profile"]["kernel_launches"] is None
        assert list(d["steady_ms_by_inflight"]) == ["1"] and names == ["serving"]
    else:
        assert set(d["results"]) == {"exact-r3", "fwd-r3"}
        assert np.isfinite(d["backward_cost_ms_per_batch"])
        assert names == ["exact-r3", "fwd-r3"]


@pytest.mark.parametrize("run,argv,metric", [
    *[(bench.main, argv, metric) for argv, metric, _ in BENCH_MODES],
    *[(tool.main, [], metric) for tool, _, metric in TOOLS],
], ids=lambda a: str(a) if isinstance(a, list) else "")
def test_no_cuda_device_fails_fast(run, argv, metric, capsys, monkeypatch):
    """Without a CUDA device and without --cpu: exit 1 and one JSON line,
    the mode's metric with a null value and an error. Nothing runs on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "random_model", lambda *a, **k: pytest.fail("ran"))
    assert run(argv) == 1
    d = _one_json_line(capsys)
    assert d["metric"] == metric and d["value"] is None
    assert "no CUDA device" in d["error"]
