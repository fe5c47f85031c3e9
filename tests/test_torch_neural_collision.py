"""Port parity of the learned collision backends against egohmr_tpu on the
CPU (f32): the watertight synthetic body, the occupancy and signed-distance
queries in both layouts and all three activations, their guidance and
guided sampling, the learned collision ratio of `evaluate_batch`, one
distillation step of each net, the shipped artifacts' agreement on the
port's own draws, and the COAP/VolumetricSMPL converters.

The same seeded NumPy inputs and weights go through both packages; JAX
weights reach the port through `interop.collision_net_from_jax`."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from egohmr_tpu.collision import neural_occupancy as jocc
from egohmr_tpu.collision import neural_sdf as jsdf
from egohmr_tpu.diffusion import GuidanceConfig as JGuidanceConfig
from egohmr_tpu.diffusion import make_schedule as j_make_schedule
from egohmr_tpu.diffusion import sample_loop as j_sample_loop
from egohmr_tpu.interop.coap_convert import convert_coap as j_convert_coap
from egohmr_tpu.interop.volsmpl_convert import convert_volsmpl as j_convert_volsmpl
from egohmr_tpu.models import BodyRepStats as JStats
from egohmr_tpu.models import Condition as JCondition
from egohmr_tpu.smpl import lbs as j_lbs
from egohmr_tpu.smpl import make_synthetic_model as j_make_smpl
from egohmr_tpu.smpl import make_synthetic_watertight_model as j_watertight
from egohmr_tpu_torch.collision import knn as k2
from egohmr_tpu_torch.collision import neural_occupancy as tocc
from egohmr_tpu_torch.collision import neural_sdf as tsdf
from egohmr_tpu_torch.diffusion import GuidanceConfig, make_schedule, sample_loop
from egohmr_tpu_torch.interop import collision_net_from_jax, collision_net_to_jax
from egohmr_tpu_torch.interop.coap_convert import convert_coap
from egohmr_tpu_torch.interop.volsmpl_convert import convert_volsmpl
from egohmr_tpu_torch.models import BodyRepStats, Condition
from egohmr_tpu_torch.smpl import lbs, make_synthetic_model, make_synthetic_watertight_model

from .test_coap_convert import _fabricate_state_dict
from .torch_parity import to_np

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "artifacts")
B, P, V = 2, 96, 128
UPPER = [0, 3, 6, 9, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23]
SMALL = dict(latent_dim=16, hidden_dim=32, num_layers=3)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _nets(backend: str, layout: str, activation: str, seed: int = 1):
    """(JAX params, JAX config, port net) on the same weights. `layout`:
    'shared' (no part code), 'shared+embed' or 'per_part' (a fabricated
    COAP/VolumetricSMPL release through each package's converter)."""
    jmod = jocc if backend == "occupancy" else jsdf
    if layout == "per_part":
        sd = _fabricate_state_dict(np.random.RandomState(seed))
        conv = j_convert_coap if backend == "occupancy" else j_convert_volsmpl
        params, cfg = conv(sd, activation=activation)
        params = _np_tree(params)
    else:
        cls = jocc.OccupancyConfig if backend == "occupancy" else jsdf.SDFNetConfig
        cfg = cls(**SMALL, part_embed_dim=8 if layout == "shared+embed" else 0,
                  activation=activation)
        init = jocc.init_occupancy if backend == "occupancy" else jsdf.init_sdfnet
        params = _np_tree(init(jax.random.PRNGKey(seed), cfg))
    tcls = tocc.OccupancyConfig if backend == "occupancy" else tsdf.SDFNetConfig
    net = collision_net_from_jax(params, tcls(**dataclasses.asdict(cfg)))
    return jmod, params, cfg, net


@pytest.fixture(scope="module")
def posed():
    """Posed bodies of the random-face synthetic model and scene points
    around them, both packages."""
    rng = np.random.RandomState(0)
    betas = (rng.randn(B, 10) * 0.5).astype(np.float32)
    aa = (rng.randn(B, 24, 3) * 0.2).astype(np.float32)
    pts = (rng.randn(B, P, 3) * [0.3, 0.5, 0.2]).astype(np.float32)
    jm, tm = j_make_smpl(num_vertices=V), make_synthetic_model(num_vertices=V)
    jout = j_lbs(jm, jnp.asarray(betas), jnp.asarray(aa[:, 0]),
                 jnp.asarray(aa[:, 1:].reshape(B, 69)), pose2rot=True)
    tout = lbs(tm, torch.tensor(betas), torch.tensor(aa[:, 0]),
               torch.tensor(aa[:, 1:].reshape(B, 69)), pose2rot=True)
    return (jm, jout, jnp.asarray(betas), jnp.asarray(pts)), \
        (tm, tout, torch.tensor(betas), torch.tensor(pts))


@pytest.mark.parametrize("kw", [{}, dict(seed=3, rings=6, segs=8)], ids=["default", "small"])
def test_watertight_body_equals_jax(kw):
    """`make_synthetic_watertight_model` array for array, 3,504 vertices by
    default."""
    want, got = j_watertight(**kw), make_synthetic_watertight_model(**kw)
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.shape == w.shape and np.array_equal(g, w), name
    if not kw:
        assert got.num_vertices == 3504


def _straddle(backend, params, cfg, jside):
    """`params` with the last decoder bias shifted so that the composed field
    of `jside`'s points has its median at the threshold: points on both
    sides, and many near it."""
    jm, jout, jbetas, jpts = jside
    raw = np.asarray(jocc.part_field_raw(params, cfg, jm, jout, jbetas, jpts))
    shift = -np.median(raw.max(axis=1) if backend == "occupancy" else raw.min(axis=1))
    params = jax.tree_util.tree_map(lambda a: a, params)  # a new tree, same leaves
    last = params["part_decoder" if cfg.per_part_networks else "decoder"][-1]
    last["b"] = (last["b"] + shift).astype(np.float32)
    return params


def _query(backend, jmod, params, cfg, net, jside, tside):
    (jm, jout, jbetas, jpts), (_, tout, tbetas, tpts) = jside, tside
    if backend == "occupancy":
        want = jmod.occupancy_query(params, cfg, jm, jout, jbetas, jpts)
        got = tocc.occupancy_query(net, tout, tbetas, tpts)
    else:
        want = jmod.sdf_query(params, cfg, jm, jout, jbetas, jpts)
        got = tsdf.sdf_query(net, tout, tbetas, tpts)
    return np.asarray(want), to_np(got)


@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "softplus"])
@pytest.mark.parametrize("layout", ["shared", "shared+embed", "per_part"])
@pytest.mark.parametrize("backend", ["occupancy", "volsdf"])
def test_query_matches_jax(posed, backend, layout, activation):
    """`occupancy_query` / `sdf_query` [B, P] at rtol 1e-5, atol 1e-6, and
    inside/outside decided alike except within 1e-5 of the threshold (the
    shared layout runs ReLU whatever `activation` says, as in JAX)."""
    jmod, params, cfg, net = _nets(backend, layout, activation)
    params = _straddle(backend, params, cfg, posed[0])
    net = collision_net_from_jax(params, net.cfg)
    want, got = _query(backend, jmod, params, cfg, net, *posed)
    assert got.shape == (B, P)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    thresh = 0.5 if backend == "occupancy" else 0.0
    flips = (got > thresh) != (want > thresh)
    assert np.all(np.abs(want[flips] - thresh) < 1e-5)
    # the inputs put points on both sides
    assert 0 < np.mean(want > thresh) < 1


def test_part_field_and_chunks(posed, monkeypatch):
    """`part_field_raw` [B, 24, P] equals JAX's; `field_in_chunks` with small
    chunks (so that the points are split) equals the unchunked query."""
    jmod, params, cfg, net = _nets("volsdf", "shared+embed", "relu")
    (jm, jout, jbetas, jpts), (_, tout, tbetas, tpts) = posed
    want = np.asarray(jocc.part_field_raw(params, cfg, jm, jout, jbetas, jpts))
    got = to_np(tocc.part_field_raw(net, tout, tbetas, tpts))
    assert got.shape == (B, 24, P)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    monkeypatch.setattr(tocc, "QUERY_ROWS", B * 24 * 10)  # chunks of 10 points
    head = lambda raw: tsdf.sdf_from_raw(net.cfg, raw)  # noqa: E731
    chunked = tocc.field_in_chunks(net, tout, tbetas, tpts, head)
    np.testing.assert_allclose(to_np(chunked), to_np(tsdf.sdf_query(net, tout, tbetas, tpts)),
                               rtol=1e-6, atol=1e-7)


def test_losses_match_jax():
    """The collision losses and `masked_mean_loss`, masked and not."""
    rng = np.random.RandomState(4)
    v = rng.randn(3, 40).astype(np.float32) * 0.3 + 0.4
    m = (rng.rand(3, 40) > 0.5).astype(np.float32)
    for jf, tf in ((jocc.occupancy_collision_loss, tocc.occupancy_collision_loss),
                   (jsdf.sdf_collision_loss, tsdf.sdf_collision_loss)):
        for mask in (None, m):
            want = np.asarray(jf(jnp.asarray(v), None if mask is None else jnp.asarray(mask)))
            got = tf(torch.tensor(v), None if mask is None else torch.tensor(mask))
            np.testing.assert_allclose(to_np(got), want, rtol=1e-6, atol=1e-9)


@pytest.fixture(scope="module")
def guide_setup():
    """A condition whose scene is dense around the body, pose statistics
    and a starting x, both packages."""
    rng = np.random.RandomState(0)
    Bg, Pg = 3, 1500
    betas = (rng.randn(Bg, 10) * 0.3).astype(np.float32)
    scene = (rng.randn(Bg, Pg, 3) * [0.3, 0.5, 0.2]).astype(np.float32)
    mean = (rng.randn(144) * 0.1).astype(np.float32)
    std = (1 + 0.2 * rng.rand(144)).astype(np.float32)
    x = (rng.randn(Bg, 144) * 0.3).astype(np.float32)

    def cond(cls, conv):
        fields = {f: conv(np.zeros((Bg, 1), np.float32)) for f in cls._fields}
        fields.update(pred_betas=conv(betas), scene_pcd=conv(scene))
        return cls(**fields)

    J = lambda a: jnp.asarray(np.array(a))  # noqa: E731
    T = lambda a: torch.tensor(np.array(a))  # noqa: E731
    return ((j_make_smpl(num_vertices=V), cond(JCondition, J), JStats(J(mean), J(std))),
            (make_synthetic_model(num_vertices=V), cond(Condition, T),
             BodyRepStats(T(mean), T(std))), x)


def _load_both(artifact):
    """(JAX params, JAX config, port net) of a shipped artifact."""
    path = os.path.join(ARTIFACTS, artifact)
    if artifact.startswith("volsdf"):
        return (*jsdf.load_sdfnet(path), tsdf.load_sdfnet(path))
    return (*jocc.load_occupancy(path), tocc.load_occupancy(path))


# learned nets for the guidance: the shipped artifacts (shared layout, with
# and without the part code), and a fabricated per-part release whose leg
# parts' output bias is moved so that they win the max (occupancy) or the
# min (signed distance) over parts, inside the body: random per-part nets
# otherwise leave the composed field to a part the guidance does not move
NETS = {"occupancy": ["occupancy_synthetic.npz", "occupancy_synthetic_signed.npz", "per_part"],
        "volsdf": ["volsdf_synthetic.npz", "per_part"]}
LEG_PARTS = [1, 2, 4, 5, 7, 8, 10, 11]


def _guides(guide_setup, backend, source, **kw):
    (jsmpl, jcond, jstats), (smpl, cond, stats), _ = guide_setup
    if source == "per_part":
        _, params, cfg, net = _nets(backend, "per_part", "leaky_relu")
        params["part_decoder"][-1]["b"][LEG_PARTS] += 3.0 if backend == "occupancy" else -1.0
        net = collision_net_from_jax(params, net.cfg)
    else:
        params, cfg, net = _load_both(source)
    if backend == "occupancy":
        jfn = jocc.make_occupancy_guidance_fn(params, cfg, jsmpl, jcond, jstats, **kw)
        tfn = tocc.make_occupancy_guidance_fn(net, smpl, cond, stats, **kw)
    else:
        jfn = jsdf.make_volsdf_guidance_fn(params, cfg, jsmpl, jcond, jstats, **kw)
        tfn = tsdf.make_volsdf_guidance_fn(net, smpl, cond, stats, **kw)
    return jax.jit(jfn), tfn


@pytest.mark.parametrize("backend,source", [(b, n) for b in NETS for n in NETS[b]])
@pytest.mark.parametrize("max_scene_points", [4096, 512])
def test_guidance_gradient_matches_jax(guide_setup, backend, source, max_scene_points):
    """The learned guidance's gradient [B, 144] at rtol 1e-4, atol 1e-6 (the
    mesh-SDF guidance's bar), with the scene pre-filter a no-op and
    cutting; non-zero, and zero on the pelvis and upper body."""
    jfn, tfn = _guides(guide_setup, backend, source, max_scene_points=max_scene_points)
    x = guide_setup[2]
    want = np.asarray(jfn(jnp.asarray(x), jnp.zeros((3,), jnp.int32)))
    with torch.no_grad():  # as inside sample_bodies
        got = tfn(torch.tensor(x), torch.zeros(3, dtype=torch.int64))
    assert got.shape == (3, 144) and not got.requires_grad
    got = got.numpy()
    assert np.abs(want).max() > 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got.reshape(3, 24, 6)[:, UPPER], 0.0)


# (backend, net, guidance weights as multiples of the reference's, DDIM and
# DDPM): the guidance moves the sample by over 1e-3, ten times the bar. At
# larger weights a learned field's guided DDPM is chaotic: the two
# packages' f32 differences, 1e-7 in one gradient, grow over the 11 guided
# steps to the size of the guidance's effect
SAMPLED = [("occupancy", "occupancy_synthetic.npz", {"ddim": 10.0, "ddpm": 1.0}),
           ("volsdf", "per_part", {"ddim": 10.0, "ddpm": 10.0})]


@pytest.mark.parametrize("backend,source,scale", SAMPLED, ids=[c[0] for c in SAMPLED])
@pytest.mark.parametrize("sampler,respacing", [("ddim", "ddim5"), ("ddpm", "")])
def test_guided_sampling_matches_jax(guide_setup, backend, source, scale, sampler, respacing,
                                     monkeypatch):
    """`sample_loop` with the learned guidance and a fixed denoiser, zero
    step noise on both sides: guided DDIM-5 and DDPM-50 end within rtol
    1e-3, atol 1e-4 of JAX."""
    from egohmr_tpu_torch.diffusion import sampler as tsampler

    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    monkeypatch.setattr(tsampler, "_step_noise", lambda x, g, shard: torch.zeros_like(x))
    jfn, tfn = _guides(guide_setup, backend, source)
    x = guide_setup[2]
    W = (np.random.RandomState(5).randn(144, 144) * 0.05).astype(np.float32)
    jW, tW = jnp.asarray(W), torch.tensor(W)
    weights = dict(cond_grad_weight=2.0 * scale[sampler], ddim_scale=1.0 * scale[sampler])
    jkw = dict(sampler=sampler, noise=jnp.asarray(x), guidance=JGuidanceConfig(**weights))
    run = lambda fn: j_sample_loop(  # noqa: E731
        j_make_schedule(50, "cosine", respacing), lambda xt, t: jnp.tanh(xt @ jW),
        jax.random.PRNGKey(0), (3, 144), guidance_fn=fn, **jkw)[0]
    want, free = np.asarray(run(jfn)), np.asarray(run(None))
    before = k2.launches
    with torch.no_grad():
        got, _ = sample_loop(make_schedule(50, "cosine", respacing),
                             lambda xt, t: torch.tanh(xt @ tW), torch.Generator(), (3, 144),
                             sampler=sampler, guidance_fn=tfn, guidance=GuidanceConfig(**weights),
                             noise=torch.tensor(x))
    assert k2.launches == before
    effect = np.abs(want - free).max()
    assert effect > 1e-3, effect
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


def _jax_adam_step(loss_fn, params, lr, steps):
    opt = optax.adam(optax.cosine_decay_schedule(lr, steps))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    updates, _ = opt.update(grads, opt.init(params))
    return float(loss), optax.apply_updates(params, updates)


@pytest.mark.parametrize("backend,label_mode", [("occupancy", "proximity"),
                                                ("occupancy", "signed"),
                                                ("volsdf", "winding")])
def test_one_distillation_step_matches_jax(backend, label_mode):
    """One distillation step of each net on a batch drawn by JAX's
    `sample_labeled_batch` (on the watertight body), from the same weights:
    the loss at rtol 1e-5, and the weights after one Adam step under the
    cosine schedule at the training tests' Adam bar (rtol 1e-4 for all but
    5e-4 of the elements: Adam's first step moves each element by about lr
    whatever its gradient's size, so an element whose gradient is within
    f32 noise of 0 may move the other way)."""
    jm = j_watertight(rings=6, segs=8)
    tm = make_synthetic_watertight_model(rings=6, segs=8)
    betas, out, pts, sdf = jax.jit(lambda k: jocc.sample_labeled_batch(
        k, jm, batch_bodies=2, points_per_body=128, label_mode=label_mode))(jax.random.PRNGKey(7))
    jmod, params, cfg, net = _nets(backend, "shared+embed", "relu")
    params = jax.tree_util.tree_map(jnp.asarray, params)
    lr, steps = 1e-3, 10
    if backend == "occupancy":
        label = jax.nn.sigmoid(-cfg.label_sharpness * sdf)

        def jloss(p):
            occ = jocc.occupancy_query(p, cfg, jm, out, betas, pts)
            return jnp.mean(jnp.square(occ - label))

        tloss = tocc.occupancy_distill_loss
    else:
        label, sign = jnp.clip(sdf, -cfg.trunc, cfg.trunc), jnp.sign(sdf)

        def jloss(p):
            pred = jsdf.sdf_query(p, cfg, jm, out, betas, pts)
            return (jnp.mean(jnp.square(pred - label))
                    + 0.1 * jnp.mean(jnp.maximum(0.01 - sign * pred, 0.0)))

        tloss = tsdf.sdf_distill_loss
    want_loss, want_params = _jax_adam_step(jloss, params, lr, steps)
    T = lambda a: torch.tensor(np.array(a))  # noqa: E731
    tout = lbs(tm, T(betas), T(out.full_pose[:, :1]), T(out.full_pose[:, 1:]), pose2rot=False)
    batch = tocc.LabeledBatch(T(betas), tout, T(pts), T(sdf))
    opt, sched = tocc.make_distill_optimizer(net, lr, steps)
    got_loss = float(tocc.distill_step(net, opt, sched, tloss, batch))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    want_flat = np.concatenate([np.ravel(w) for w in jax.tree_util.tree_leaves(want_params)])
    got_flat = np.concatenate([np.ravel(g) for g in
                               jax.tree_util.tree_leaves(collision_net_to_jax(net))])
    loose = int(np.sum(~np.isclose(got_flat, want_flat, rtol=1e-4, atol=0)))
    assert loose <= 5e-4 * got_flat.size, (loose, got_flat.size)
    assert np.abs(got_flat - want_flat).max() <= 2.5 * lr
    assert sched.get_last_lr()[0] == pytest.approx(lr * 0.5 * (1 + np.cos(np.pi / steps)))


@pytest.mark.parametrize("artifact", ["occupancy_synthetic.npz", "occupancy_synthetic_signed.npz",
                                      "volsdf_synthetic.npz"])
def test_shipped_artifact_meets_its_bar_on_the_ports_draws(artifact):
    """Each shipped artifact loads into the port with JAX's weights, and its
    held-out agreement on the port's own draws (4 bodies x 512 points, the
    body and label mode of its sidecar) reaches its bar less 0.02."""
    path = os.path.join(ARTIFACTS, artifact)
    with open(path + ".json") as f:
        meta = json.load(f)
    body = (make_synthetic_watertight_model() if meta["body"] == "synthetic_watertight"
            else make_synthetic_model(num_vertices=6890))
    g = torch.Generator().manual_seed(123)
    kw = dict(n_bodies=4, points_per_body=512, label_mode=meta["label_mode"],
              sign_k=meta.get("sign_k", 4))
    if artifact.startswith("volsdf"):
        jparams, jcfg = jsdf.load_sdfnet(path)
        net = tsdf.load_sdfnet(path)
        acc, bar = tsdf.sdf_agreement(net, body, g, **kw)["sign_agreement"], meta["agreement_bar"]
    else:
        jparams, jcfg = jocc.load_occupancy(path)
        net = tocc.load_occupancy(path)
        acc, bar = tocc.occupancy_agreement(net, body, g, **kw), meta["accuracy_bar"]
    assert dataclasses.asdict(net.cfg) == dataclasses.asdict(jcfg)
    assert not any(p.requires_grad for p in net.parameters()) and not net.training
    for w, t in zip(jax.tree_util.tree_leaves(jparams),
                    jax.tree_util.tree_leaves(collision_net_to_jax(net))):
        np.testing.assert_array_equal(t, np.asarray(w))
    assert acc >= bar - 0.02, (acc, meta)


def _assert_trees_equal(jtree, ttree):
    assert jax.tree_util.tree_structure(_np_tree(jtree)) == jax.tree_util.tree_structure(ttree)
    for w, g in zip(jax.tree_util.tree_leaves(jtree), jax.tree_util.tree_leaves(ttree)):
        assert isinstance(g, np.ndarray)
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("which", ["coap", "volsmpl"])
def test_converters_match_jax(which):
    """Both converters give JAX's arrays and config on fabricated release
    state dicts: the default naming, an alternate one, biasless layers, and
    for VolumetricSMPL the Lightning `state_dict` wrapper with an
    attach-point prefix."""
    jconv, tconv = ((j_convert_coap, convert_coap) if which == "coap"
                    else (j_convert_volsmpl, convert_volsmpl))
    rng = np.random.RandomState(2)
    cases = [_fabricate_state_dict(rng),
             _fabricate_state_dict(rng, prefix=("encoders.{k}", "decoders.{k}")),
             _fabricate_state_dict(rng, with_bias=False)]
    if which == "volsmpl":
        inner = {f"coap.{k}": v for k, v in _fabricate_state_dict(rng).items()}
        cases += [{"state_dict": inner},
                  {f"volume.{k}": v for k, v in _fabricate_state_dict(rng).items()}]
    for sd in cases:
        (jp, jc), (tp, tc) = jconv(sd), tconv(sd)
        _assert_trees_equal(jp, tp)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    # the feature contract relaxed
    sd = _fabricate_state_dict(rng, enc_dims=(17, 48, 32))
    _assert_trees_equal(jconv(sd, strict_feature_contract=False)[0],
                        tconv(sd, strict_feature_contract=False)[0])


@pytest.mark.parametrize("which", ["coap", "volsmpl"])
def test_converter_errors_match_jax(which):
    """The same inputs are refused by both packages, with the same words."""
    jconv, tconv = ((j_convert_coap, convert_coap) if which == "coap"
                    else (j_convert_volsmpl, convert_volsmpl))
    rng = np.random.RandomState(3)
    bad_part = _fabricate_state_dict(rng)
    key = "part_encoders.3.net.0.weight"
    bad_part[key] = np.zeros((7, 22), np.float32)
    bad_dec = _fabricate_state_dict(rng, dec_dims=(35, 64, 2))
    cases = [({"totally.different.weight": np.zeros((4, 4))}, {}, "no per-part module pattern"),
             (_fabricate_state_dict(rng, enc_dims=(17, 48, 32)), {}, "22 dims per part"),
             (_fabricate_state_dict(rng, dec_dims=(30, 64, 1)), {}, "decoder expects 30-d input"),
             (bad_part, {}, "part 3"),
             (bad_dec, {}, "decoder output dim 2"),
             (_fabricate_state_dict(rng), dict(num_parts=16), "decomposes the body into 24")]
    for sd, kw, match in cases:
        for conv in (jconv, tconv):
            with pytest.raises(ValueError, match=match):
                conv(sd, **kw)


@pytest.mark.parametrize("which", ["coap", "volsmpl"])
def test_release_checkpoint_loads_like_jax(which, tmp_path):
    """A release `.pt` (a Lightning dict with a `state_dict`) loads through
    `load_occupancy` / `load_sdfnet` in both packages to the same weights and
    config, and a converted net saved as `.npz` with its sidecar reloads
    through the port's loader (the per-part layout rebuilt from the
    arrays)."""
    from egohmr_tpu_torch.utils.checkpoint import save_npz

    sd = _fabricate_state_dict(np.random.RandomState(6))
    path = str(tmp_path / "release.ckpt")
    torch.save({"state_dict": {k: torch.tensor(v) for k, v in sd.items()}, "epoch": 3}, path)
    jload, tload, key = ((jocc.load_occupancy, tocc.load_occupancy, "occupancy_config")
                         if which == "coap" else
                         (jsdf.load_sdfnet, tsdf.load_sdfnet, "sdf_config"))
    (jp, jc), net = jload(path), tload(path)
    assert dataclasses.asdict(net.cfg) == dataclasses.asdict(jc) and net.cfg.per_part_networks
    _assert_trees_equal(jp, collision_net_to_jax(net))
    npz = str(tmp_path / "converted.npz")
    save_npz(npz, collision_net_to_jax(net))
    with open(npz + ".json", "w") as f:
        json.dump({key: dataclasses.asdict(net.cfg)}, f)
    again = tload(npz)
    assert again.cfg == net.cfg
    _assert_trees_equal(jp, collision_net_to_jax(again))
    (jp2, jc2) = jload(npz)
    _assert_trees_equal(jp2, collision_net_to_jax(again))

