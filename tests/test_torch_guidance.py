"""Port parity: `make_guidance_fn`, the collision-score gradient of guided
sampling, against egohmr_tpu on the CPU (f32).

Guidance has no parameters: it reads `pred_betas` and `scene_pcd` of the
`Condition`, the SMPL tables and the pose statistics. Those come from a
numpy seed and cross as copies; the other `Condition` fields are dummies.
The scene is dense around the body, so hundreds of points lie in its bbox
and the caps really evict.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egohmr_tpu.diffusion import GuidanceConfig as JGuidanceConfig
from egohmr_tpu.diffusion import make_schedule as j_make_schedule
from egohmr_tpu.diffusion import sample_loop as j_sample_loop
from egohmr_tpu.models import BodyRepStats as JStats
from egohmr_tpu.models import Condition as JCondition
from egohmr_tpu.models import make_guidance_fn as j_make_guidance_fn
from egohmr_tpu.models.egohmr import _GUIDE_JOINT_SCALE as J_SCALE
from egohmr_tpu.smpl import make_synthetic_model as j_make_smpl
from egohmr_tpu_torch.collision import knn as k2
from egohmr_tpu_torch.diffusion import GuidanceConfig, StatefulGuidanceFn, make_schedule, sample_loop
from egohmr_tpu_torch.models import BodyRepStats, Condition, make_guidance_fn
from egohmr_tpu_torch.models.egohmr import _GUIDE_JOINT_SCALE
from egohmr_tpu_torch.smpl import make_synthetic_model

B, V, P = 3, 431, 2048
UPPER = [0, 3, 6, 9, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23]


@pytest.fixture(scope="module")
def setup():
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


def _both(setup, **kw):
    (jsmpl, jcond, jstats), (smpl, cond, stats), _ = setup
    jfn = j_make_guidance_fn({}, None, jsmpl, jcond, jstats, sdf_block_size=256, **kw)
    tfn = make_guidance_fn(None, None, smpl, cond, stats, **kw)
    return jfn, tfn


def test_joint_scale_equals_jax():
    np.testing.assert_array_equal(_GUIDE_JOINT_SCALE, J_SCALE)


@pytest.mark.parametrize("caps", [
    dict(max_scene_points=None, per_step_points=None),  # every point scored
    dict(max_scene_points=4096, per_step_points=None),  # pre-filter a no-op
    dict(max_scene_points=1024, per_step_points=None),  # pre-filter cuts
    dict(max_scene_points=1024, per_step_points=128),   # both; the cap evicts
    dict(),                                             # the defaults
])
def test_guidance_gradient_matches_jax(setup, caps):
    """The gradient [B, 144] with and without the pre-filter and the
    per-step cap: rtol 1e-4, atol 1e-6, the bar the JAX package holds its
    own two formulations to. With the cap at 128 the bbox holds more points
    than are kept, so this also holds the fixed permutation and the
    tie-break of the stable sort to JAX's. The gradient is non-zero, and
    exactly zero on the pelvis and the upper-body joints."""
    jfn, tfn = _both(setup, **caps)
    x = setup[2]
    want = np.asarray(jfn(jnp.asarray(x), jnp.zeros((B,), jnp.int32)))
    with torch.no_grad():  # as inside sample_bodies
        got = tfn(torch.tensor(x), torch.zeros(B, dtype=torch.int64))
    assert got.shape == (B, 144) and not got.requires_grad
    got = got.numpy()
    assert np.abs(want).max() > 1e-4
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got.reshape(B, 24, 6)[:, UPPER], 0.0)


def test_per_step_cap_is_exact_when_the_bbox_points_fit(setup):
    """With K2 above the bbox's point count the cap changes nothing:
    rtol 1e-6, atol 1e-7 against the uncapped gradient."""
    (_, _, _), (smpl, cond, stats), x = setup
    sparse = cond._replace(scene_pcd=cond.scene_pcd[:, :600] * 3.0)
    full = make_guidance_fn(None, None, smpl, sparse, stats, per_step_points=None)
    cap = make_guidance_fn(None, None, smpl, sparse, stats, per_step_points=256)
    t = torch.zeros(B, dtype=torch.int64)
    a, b = full(torch.tensor(x), t).numpy(), cap(torch.tensor(x), t).numpy()
    assert np.abs(a).max() > 0
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


def test_gradient_matches_finite_differences_of_the_full_mesh_loss(setup):
    """The guidance returns minus the gradient of the batch-mean collision
    loss, scaled per joint, from the selective re-pose. Held here to central
    differences of the same loss computed from the FULL posed mesh (`lbs`,
    not `lbs_apply_select`) with the selection of x frozen, which is what
    makes the loss differentiable: along the returned direction d the
    per-body loss must fall at the rate B * sum(d^2 / joint scale). rtol
    2e-2 (f32 central differences at h = 0.5)."""
    from egohmr_tpu_torch.collision import bbox_mask, collision_loss, nearest_vertex
    from egohmr_tpu_torch.collision.sdf import gather_rows
    from egohmr_tpu_torch.geometry import rot6d_to_rotmat
    from egohmr_tpu_torch.smpl import lbs, vertex_normals

    (_, _, _), (smpl, cond, stats), x = setup
    fn = make_guidance_fn(None, None, smpl, cond, stats, max_scene_points=None,
                          per_step_points=None)
    pts = cond.scene_pcd

    def verts(xt):
        rot = rot6d_to_rotmat(xt * stats.std + stats.mean, "diffusion").reshape(B, 24, 3, 3)
        return lbs(smpl, cond.pred_betas, rot[:, :1], rot[:, 1:], pose2rot=False).vertices

    xt = torch.tensor(x)
    v = verts(xt)
    idx = nearest_vertex(pts, v).idx
    normals = gather_rows(vertex_normals(v, smpl.faces), idx)
    sign = torch.sign(torch.sum((pts - gather_rows(v, idx)) * normals, dim=-1))
    mask = bbox_mask(pts, v).float()

    def loss(xt):
        dist = torch.linalg.norm(pts - gather_rows(verts(xt), idx), dim=-1)
        return collision_loss(sign * dist, mask)

    d = fn(xt, torch.zeros(B, dtype=torch.int64))
    scale = torch.tensor(_GUIDE_JOINT_SCALE).repeat_interleave(6)
    h = 0.5
    rate = (loss(xt - h * d) - loss(xt + h * d)) / (2 * h)
    want = B * (d ** 2 / scale.clamp(min=1.0)).sum(-1)
    assert (want > 1e-5).all()
    torch.testing.assert_close(rate, want, rtol=2e-2, atol=0)


def test_stateful_form_equals_plain_on_a_refresh_step(setup):
    """On a refresh step the stateful guidance selects from the current
    x_t: its gradient equals the plain one bit for bit, and so does a
    reuse of the selection just made at the same x_t."""
    (_, _, _), (smpl, cond, stats), x = setup
    kw = dict(per_step_points=128)
    exact = make_guidance_fn(None, None, smpl, cond, stats, **kw)
    stateful = make_guidance_fn(None, None, smpl, cond, stats,
                                selection_refresh_every=2, **kw)
    assert isinstance(stateful, StatefulGuidanceFn) and stateful.refresh_every == 2
    xt, t = torch.tensor(x), torch.zeros(B, dtype=torch.int64)
    want = exact(xt, t)
    g_refresh, sel = stateful.fn(xt, t, stateful.init_state(xt), True)
    g_reuse, _ = stateful.fn(xt, t, sel, False)
    torch.testing.assert_close(g_refresh, want, rtol=0, atol=0)
    torch.testing.assert_close(g_reuse, want, rtol=0, atol=0)


def test_stateful_sampling_refreshes_every_nth_guided_step(setup, monkeypatch):
    """Through `sample_loop`: with refresh_every=2 over the 4 guided steps
    of DDIM-5 the selection (and so the nearest-vertex search) runs on the
    1st and 3rd guided step only; refresh_every=1 as a stateful form equals
    the plain guidance bit for bit."""
    from egohmr_tpu_torch.models import egohmr as tmodel

    (_, _, _), (smpl, cond, stats), x = setup
    calls = []
    real = tmodel.nearest_vertex
    monkeypatch.setattr(tmodel, "nearest_vertex",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    sched = make_schedule(50, "cosine", "ddim5")
    den = lambda xt, t: 0.9 * xt  # noqa: E731
    run = lambda fn: sample_loop(sched, den, None, (B, 144), sampler="ddim",  # noqa: E731
                                 guidance_fn=fn, noise=torch.tensor(x))[0]
    plain = make_guidance_fn(None, None, smpl, cond, stats)
    a = run(plain)
    assert len(calls) == 4
    calls.clear()
    b = run(StatefulGuidanceFn(lambda x_: None, lambda x_, t, s, r: (plain(x_, t), s), 1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    calls.clear()
    c = run(make_guidance_fn(None, None, smpl, cond, stats, selection_refresh_every=2))
    assert len(calls) == 2
    assert torch.isfinite(c).all() and (c - a).abs().max() < 0.1


@pytest.mark.parametrize("sampler,respacing", [("ddim", "ddim5"), ("ddpm", "")])
def test_guided_sampling_with_the_real_guidance_matches_jax(setup, sampler, respacing,
                                                            monkeypatch):
    """`sample_loop` with the collision guidance and a fixed linear
    denoiser, zero step noise on both sides: guided DDIM-5 (4 guided steps)
    and guided DDPM-50 (11 guided steps) end within rtol 1e-3, atol 1e-4 of
    JAX. Looser than the single gradient's 1e-4: each guided step feeds its
    f32 differences into the next selection. The weights are raised (the
    loss is a mean of squared depths of a few centimetres, so its gradient
    is small) until the guidance moves the sample by over a hundred times
    that bar."""
    import jax

    from egohmr_tpu_torch.diffusion import sampler as tsampler

    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    monkeypatch.setattr(tsampler, "_step_noise", lambda x, g, shard: torch.zeros_like(x))
    jfn, tfn = _both(setup)
    x = setup[2]
    W = (np.random.RandomState(5).randn(144, 144) * 0.05).astype(np.float32)
    jW, tW = jnp.asarray(W), torch.tensor(W)
    weights = dict(cond_grad_weight=60.0, ddim_scale=30.0)
    jkw = dict(sampler=sampler, noise=jnp.asarray(x), guidance=JGuidanceConfig(**weights))
    want, _ = j_sample_loop(j_make_schedule(50, "cosine", respacing),
                            lambda xt, t: jnp.tanh(xt @ jW), jax.random.PRNGKey(0),
                            (B, 144), guidance_fn=jfn, **jkw)
    free, _ = j_sample_loop(j_make_schedule(50, "cosine", respacing),
                            lambda xt, t: jnp.tanh(xt @ jW), jax.random.PRNGKey(0),
                            (B, 144), **jkw)
    before = k2.launches
    with torch.no_grad():
        got, _ = sample_loop(make_schedule(50, "cosine", respacing),
                             lambda xt, t: torch.tanh(xt @ tW), torch.Generator(), (B, 144),
                             sampler=sampler, guidance_fn=tfn,
                             guidance=GuidanceConfig(**weights),
                             noise=torch.tensor(x))
    assert k2.launches == before  # CPU tensors never count as kernel launches
    effect = np.abs(np.asarray(want) - np.asarray(free)).max()
    assert effect > 1e-2, effect
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
