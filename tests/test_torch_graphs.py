"""The captured request programs on the CPU: the step noise drawn outside
the sampling loop (`draw_step_noise`, `sample_loop(step_noise=)`) against
the loop's own draws, bit for bit; `Predictor`'s request, which on the card
is one captured CUDA graph per shape, against `sample_bodies` on the same
x_T and step noise, and against the JAX package; `CapturedProgram`'s shape
key and launch accounting through an injected capture step; the
guidance's constants built once per device. The card's side (replay
against eager) is in `tests/test_torch_gpu.py` and `chip_smoke.py` phase
14."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egohmr_tpu_torch.collision.neural_occupancy import OccupancyConfig, PartFieldNet
from egohmr_tpu_torch.collision.neural_sdf import SDFNetConfig
from egohmr_tpu_torch.data import synthetic_batch, to_torch
from egohmr_tpu_torch.diffusion import (GuidanceConfig, draw_step_noise, make_schedule,
                                        sample_loop)
from egohmr_tpu_torch.eval import sample_bodies
from egohmr_tpu_torch.models import BodyRepStats, Condition, make_guidance_fn
from egohmr_tpu_torch.models import egohmr as tmodel
from egohmr_tpu_torch.serving import MESH_OUTPUT_KEYS, Pending, Predictor
from egohmr_tpu_torch.smpl import make_synthetic_model
from egohmr_tpu_torch.utils import graphs
from egohmr_tpu_torch.utils.graphs import CapturedProgram

from .torch_parity import tiny_pair, to_jax

V = 256


def _denoiser(d=144, seed=0):
    """x0 = tanh(x @ W + emb[t]), a stand-in for the GCN."""
    g = torch.Generator().manual_seed(seed)
    W, emb = torch.randn(d, d, generator=g) * 0.05, torch.randn(100, d, generator=g) * 0.1
    return lambda x, t: torch.tanh(x @ W + emb[t])


CHAINS = [("ddpm", "", 0.0), ("ddim", "ddim5", 0.5), ("ddim", "10,5", 1.0)]


@pytest.mark.parametrize("sampler,respacing,eta", CHAINS)
@pytest.mark.parametrize("shard", [None, (0, 2), (1, 2)])
def test_step_noise_drawn_outside_equals_the_loops_draws(sampler, respacing, eta, shard):
    """x_T and then `draw_step_noise` from one generator, handed to the loop,
    give the loop's own draws from the same seed bit for bit, whole and for
    each block of a 2-way split (each block's rows of the whole batch's
    draws)."""
    sched, den, rows = make_schedule(50, "cosine", respacing), _denoiser(), 3
    kw = dict(sampler=sampler, eta=eta, shard=shard)
    want = sample_loop(sched, den, torch.Generator().manual_seed(4), (rows, 144), **kw)[0]
    g = torch.Generator().manual_seed(4)
    n = rows * (shard[1] if shard else 1)
    x_T = torch.randn((n, 144), generator=g)
    if shard:
        x_T = x_T[shard[0] * rows:(shard[0] + 1) * rows]
    noise = draw_step_noise(sched, g, (rows, 144), sampler=sampler, eta=eta, shard=shard)
    assert noise.shape == (sched.num_timesteps - 1, rows, 144)
    got = sample_loop(sched, den, None, (rows, 144), noise=x_T, step_noise=noise, **kw)[0]
    assert torch.equal(got, want)


def test_step_noise_blocks_make_the_whole_batchs_draws():
    sched = make_schedule(50, "cosine", "")
    whole = draw_step_noise(sched, torch.Generator().manual_seed(2), (4, 144))
    blocks = [draw_step_noise(sched, torch.Generator().manual_seed(2), (2, 144), shard=(i, 2))
              for i in range(2)]
    assert torch.equal(torch.cat(blocks, dim=1), whole)


def test_ddim_eta_0_draws_no_step_noise_and_a_wrong_count_raises():
    sched, den = make_schedule(50, "cosine", "ddim5"), _denoiser()
    g = torch.Generator().manual_seed(1)
    noise = draw_step_noise(sched, g, (2, 144), sampler="ddim")
    assert noise.shape == (0, 2, 144)
    # nothing was drawn: the generator is where it started
    assert torch.equal(g.get_state(), torch.Generator().manual_seed(1).get_state())
    x_T = torch.randn(2, 144)
    a = sample_loop(sched, den, None, (2, 144), sampler="ddim", noise=x_T, step_noise=noise)[0]
    b = sample_loop(sched, den, None, (2, 144), sampler="ddim", noise=x_T)[0]
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="step_noise"):
        sample_loop(sched, den, None, (2, 144), sampler="ddpm", noise=x_T,
                    step_noise=torch.zeros(3, 2, 144))


# ------------------------------------------------------------- Predictor
@pytest.fixture(scope="module")
def port():
    jcfg, tcfg, params, model = tiny_pair(seed=2)
    rng = np.random.RandomState(3)
    stats = BodyRepStats(torch.tensor(rng.randn(144).astype(np.float32) * 0.1),
                         torch.tensor(1 + 0.2 * rng.rand(144).astype(np.float32)))
    return jcfg, tcfg, params, model, make_synthetic_model(num_vertices=V), stats


def _batch(n=2, points=400, img=64, seed=5):
    return synthetic_batch(n, num_scene_points=points, img_size=img, seed=seed)


# (sampler, respacing, collision backend or None for an unguided request)
REQUESTS = [("ddim", "ddim5", None), ("ddim", "ddim5", "sdf"), ("ddpm", "", "sdf"),
            ("ddpm", "", "volsdf"), ("ddpm", "", "occupancy")]


def _learned_net(backend):
    """A tiny learned collision net of `backend`, drawn from a seed."""
    widths = dict(latent_dim=8, hidden_dim=16, num_layers=3, part_embed_dim=4)
    cfg = SDFNetConfig(**widths) if backend == "volsdf" else OccupancyConfig(**widths)
    return PartFieldNet(cfg, generator=torch.Generator().manual_seed(7)).requires_grad_(False)


@pytest.mark.parametrize("sampler,respacing,backend", REQUESTS,
                         ids=["unguided-ddim5", "guided-ddim5", "guided-ddpm50",
                              "volsdf-ddpm50", "occupancy-ddpm50"])
def test_predictor_request_is_sample_bodies_on_the_drawn_noise(port, sampler, respacing,
                                                               backend):
    """A `Predictor` request on the CPU (bf16, as served) equals
    `sample_bodies` on the same replica, called directly with x_T and the
    step noise drawn from the request's seed in the request's order, bit
    for bit; `Predictor.eager` is the same request. Guided by the mesh SDF
    or by a learned net (a tiny one drawn from a seed), whose guided steps
    the request counts. On the CPU nothing is captured."""
    _, tcfg, _, model, smpl, stats = port
    sched = make_schedule(50, "cosine", respacing)
    S, seed = 2, 6
    guided = backend is not None
    net = _learned_net(backend) if backend in ("volsdf", "occupancy") else None
    pred = Predictor(model, tcfg, smpl, stats, sched, device="cpu", batch_size=2,
                     num_samples=S, sampler=sampler, with_guidance=guided,
                     guidance=GuidanceConfig(cond_grad_weight=60.0, ddim_scale=30.0),
                     collision_backend=backend or "sdf", collision_net=net,
                     output_keys=MESH_OUTPUT_KEYS)
    assert not pred.captured
    batch = _batch()
    got = pred(batch, seed=seed)
    g = torch.Generator().manual_seed(seed)
    x_T = torch.randn((2 * S, 144), generator=g)
    noise = draw_step_noise(sched, g, (2 * S, 144), sampler=sampler)
    rep, rsmpl, rstats, rsched, _ = pred._replicas[0]
    want, _ = sample_bodies(rep, pred.cfg, rsmpl, rstats, rsched, to_torch(batch, "cpu"), None,
                            S, sampler=sampler, with_guidance=guided, guidance=pred.guidance,
                            collision_backend=backend or "sdf",
                            occ_net=pred._collision_nets[0], noise=x_T, step_noise=noise)
    for k in MESH_OUTPUT_KEYS:
        assert got[k].shape == tuple(want[k].shape), k
        np.testing.assert_array_equal(got[k], want[k].float().numpy(), err_msg=k)
    again = pred.eager(batch, seed=seed)
    for k in got:
        np.testing.assert_array_equal(again[k], got[k], err_msg=k)
    assert pred._programs[0].programs == {}
    if net is not None:  # two requests, 11 guided steps each over 400 points
        assert pred.guided_steps == 2 * 11
        assert pred.field_rows == 2 * 11 * 2 * S * 24 * 400


def test_predictor_request_program_matches_jax(port):
    """The function a `Predictor` captures, run eagerly in f32 with the
    plain scene encoder on the JAX package's x_T: the JAX `sample_bodies`
    (unguided DDIM-5) within `tests/test_torch_pipeline.py`'s f32 bar,
    rtol/atol 1e-4."""
    from egohmr_tpu.diffusion import make_schedule as j_make_schedule
    from egohmr_tpu.eval.pipeline import sample_bodies as j_sample_bodies
    from egohmr_tpu.models import BodyRepStats as JStats
    from egohmr_tpu.smpl import make_synthetic_model as j_make_smpl

    jcfg, tcfg, params, model, smpl, stats = port
    S = 2
    pred = Predictor(model, tcfg, smpl, stats, make_schedule(50, "cosine", "ddim5"),
                     device="cpu", batch_size=2, num_samples=S, bf16=False,
                     pointnet_impl=tcfg.pointnet_impl, output_keys=MESH_OUTPUT_KEYS)
    batch = _batch(seed=8)
    key = jax.random.PRNGKey(3)
    jout, _ = j_sample_bodies(to_jax(params), jcfg, j_make_smpl(num_vertices=V),
                              JStats(jnp.asarray(stats.mean.numpy()),
                                     jnp.asarray(stats.std.numpy())),
                              j_make_schedule(50, "cosine", "ddim5"), to_jax(batch), key, S,
                              sampler="ddim")
    _, sub = jax.random.split(key)
    x_T = torch.tensor(np.asarray(jax.random.normal(sub, (2 * S, 144))))
    packed = pred._programs[0].eager(to_torch(batch, "cpu"), x_T, torch.zeros(0, 2 * S, 144))
    out = pred.result(Pending(packed, None, packed.shape[0]))
    for k in ("pred_keypoints_3d", "pred_vertices", "pred_betas"):
        np.testing.assert_allclose(out[k], np.asarray(jout[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_a_dropped_predictor_is_freed_at_once(port):
    """No reference cycle runs through a `Predictor`'s programs: dropping it
    frees it (and on the card its graphs and pools) without the cyclic
    collector, which could otherwise run inside another capture."""
    import gc
    import weakref

    _, tcfg, _, model, smpl, stats = port
    pred = Predictor(model, tcfg, smpl, stats, make_schedule(50, "cosine", "ddim5"),
                     device="cpu", batch_size=2)
    ref = weakref.ref(pred)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del pred
        assert ref() is None
    finally:
        if collecting:
            gc.enable()


def test_grid_and_cpu_predictors_are_not_captured(port):
    _, tcfg, _, model, smpl, stats = port
    sched = make_schedule(50, "cosine", "ddim5")
    flat = Predictor(model, tcfg, smpl, stats, sched, device=["cpu", "cpu"], batch_size=2)
    grid = Predictor(model, tcfg, smpl, stats, sched, device=[["cpu", "cpu"]], batch_size=2)
    assert not flat.captured and not grid.captured and len(flat._programs) == 2


# ------------------------------------------------------- CapturedProgram
class _FakeCard:
    """A capture step for the CPU: the capture runs the function once (its
    wrapper counts its launches through `count_launch`, as K1's and K2's
    do), and a replay recomputes the outputs from the static inputs with
    the wrapper silent, as a replayed graph calls none."""

    def __init__(self):
        self.counter = types.SimpleNamespace(launches=0)
        self.replaying = False
        self.captures = 0

    def fn(self, batch, scale):
        if not self.replaying:
            for _ in range(2):  # two kernel launches a request
                graphs.count_launch(self.counter)
        return {"s": (batch["img"].sum() + batch["scene"].sum()) * scale,
                "n": batch["scene"].new_tensor(batch["scene"].shape[1])}

    def capture(self, run, device):
        self.captures += 1
        out = run()

        def replay():
            self.replaying = True
            try:
                fresh = run()
            finally:
                self.replaying = False
            for k in out:
                out[k].copy_(fresh[k])

        return replay, out, 1024


def _tensors(points, img, seed):
    g = torch.Generator().manual_seed(seed)
    return {"img": torch.randn(2, 3, img, img, generator=g),
            "scene": torch.randn(2, points, 3, generator=g)}


def test_captured_program_keys_by_shape_and_replays_new_inputs():
    """One program per signature: the same shapes replay the first
    program on new values; another scene-point count or image size, or
    another value of a static argument, captures another."""
    card = _FakeCard()
    prog = CapturedProgram(card.fn, capture=card.capture)
    a, b = _tensors(64, 16, 0), _tensors(64, 16, 1)
    assert torch.equal(prog(a, 2.0)["s"], card.fn(a, 2.0)["s"])
    assert torch.equal(prog(b, 2.0)["s"], card.fn(b, 2.0)["s"])  # replayed on b's values
    assert len(prog.programs) == 1 and card.captures == 1
    prog(_tensors(32, 16, 2), 2.0)
    prog(_tensors(64, 8, 3), 2.0)
    prog(a, 3.0)
    assert len(prog.programs) == 4 and card.captures == 4
    assert prog.pool_bytes == 4 * 1024 and prog.capture_seconds > 0


def test_captured_program_counts_launches_once_per_replay():
    """The warm-up runs count (they launch for real), the capture's launches
    count nothing at capture, and each replay adds the capture's count
    once."""
    card = _FakeCard()
    prog = CapturedProgram(card.fn, capture=card.capture)
    a = _tensors(64, 16, 0)
    prog(a, 1.0)
    assert graphs.WARMUP_RUNS == 2
    assert card.counter.launches == 2 * 2 + 2  # two warm-ups and the first replay
    assert prog.programs[next(iter(prog.programs))].launches == ((card.counter, "launches", 2),)
    for _ in range(3):
        prog(a, 1.0)
    assert card.counter.launches == 6 + 3 * 2
    card.counter.launches = 0  # a caller's reset between phases
    prog(a, 1.0)
    assert card.counter.launches == 2


def test_captured_program_eager_and_the_cpu_path_are_the_function():
    """With the default capture step, CPU tensors run the function itself
    and capture nothing; `eager` is the function on any input."""
    card = _FakeCard()
    prog = CapturedProgram(card.fn)
    a = _tensors(64, 16, 0)
    assert torch.equal(prog(a, 1.0)["s"], card.fn(a, 1.0)["s"])
    assert torch.equal(prog.eager(a, scale=1.0)["s"], card.fn(a, 1.0)["s"])
    assert prog.programs == {}


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("argv,names", [
    ([], ["ddim5"]), (["--guided-ddim"], ["guided-ddim5"]),
    (["--guided"], ["guided"]), (["--serving"], ["serving"]), (["--train"], [])],
    ids=["default", "guided-ddim", "guided", "serving", "train"])
def test_bench_hands_the_hook_each_programs_replay(argv, names, capsys):
    """The request hook gets every captured program's request twice over:
    `request()` eagerly and `request.replay()` through the program, on the
    same inputs and draws. On the CPU the program is the function itself,
    so the two are bit-equal; `--train` runs eagerly and hands no replay."""
    from egohmr_tpu_torch import bench

    seen = {}

    def hook(name, request):
        seen[name] = request.replay is not None and _same(request(), request.replay())

    assert bench.main(argv + ["--quick", "--cpu", "--iters", "1"], request_hook=hook) == 0
    capsys.readouterr()
    replayed = [n for n, ok in seen.items() if ok]
    assert replayed == names and set(seen) - set(names) <= {"train step"}


def test_a_failed_capture_raises_naming_the_program_and_counts_nothing():
    card = _FakeCard()

    def broken(run, device):
        run()
        raise RuntimeError("operation not permitted when stream is capturing")

    prog = CapturedProgram(card.fn, name="test request", capture=broken)
    with pytest.raises(RuntimeError, match="test request: capturing the program of .*img"):
        prog(_tensors(64, 16, 0), 1.0)
    assert card.counter.launches == 4 and prog.programs == {}
    graphs.count_launch(card.counter)  # the failed capture's tally is gone
    assert card.counter.launches == 5 and graphs._capturing == []


# ------------------------------------------------------------- guidance
def test_guidance_constants_are_built_once_per_device():
    """`make_guidance_fn` takes its joint scale and its scene permutation
    from per-device caches: the same tensor objects on a second call, and
    the gradient bit-equal to one computed with freshly built constants."""
    rng = np.random.RandomState(0)
    B, P = 2, 2048
    fields = {f: torch.zeros(B, 1) for f in Condition._fields}
    fields.update(pred_betas=torch.tensor(rng.randn(B, 10).astype(np.float32) * 0.3),
                  scene_pcd=torch.tensor((rng.randn(B, P, 3) * [0.35, 0.6, 0.25])
                                         .astype(np.float32)))
    cond = Condition(**fields)
    smpl = make_synthetic_model(num_vertices=V)
    stats = BodyRepStats(torch.zeros(144), torch.ones(144))
    x = torch.tensor(rng.randn(B, 144).astype(np.float32) * 0.3)
    t = torch.zeros(B, dtype=torch.int64)
    tmodel._guide_joint_scale.cache_clear()
    tmodel._scene_permutation.cache_clear()
    fresh = make_guidance_fn(None, None, smpl, cond, stats)(x, t)
    cpu = torch.device("cpu")
    scale, perm = tmodel._guide_joint_scale(cpu), tmodel._scene_permutation(P, cpu)
    again = make_guidance_fn(None, None, smpl, cond, stats)(x, t)
    assert tmodel._guide_joint_scale(cpu) is scale and tmodel._scene_permutation(P, cpu) is perm
    assert tmodel._scene_permutation.cache_info().misses == 1
    assert torch.equal(again, fresh) and again.abs().max() > 0
