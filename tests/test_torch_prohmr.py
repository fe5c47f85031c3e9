"""Port parity of stage 1 (`egohmr_tpu_torch.models.prohmr`,
`models.discriminator` and `train.prohmr_loop`) against egohmr_tpu at a
tiny config (ResNet-18, flow hidden 32 in 2 steps of 1 block, a PointNet of
width 32, 200 scene points, batch 3): the interop mirrors, the reference
key layout, `initialize`, `forward` field by field, `compute_loss` in eval
and in training with the JAX draws handed in, the gradients of the
generator and of the discriminator, and one G+D step. Weights are the JAX
init with the flow's identity-like leaves randomised
(`torch_parity.randomize`)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from egohmr_tpu.interop import torch_export as jexport
from egohmr_tpu.models import discriminator as jdisc
from egohmr_tpu.models import prohmr as jprohmr
from egohmr_tpu.smpl import make_synthetic_model as j_make_smpl
from egohmr_tpu.train import prohmr_loop as jloop
from egohmr_tpu_torch.data import synthetic_batch, to_torch
from egohmr_tpu_torch.interop import (
    discriminator_state_dict_from_jax,
    export_discriminator,
    export_prohmr,
)
from egohmr_tpu_torch.models import Discriminator, ProHMR, ProHMRLossWeights
from egohmr_tpu_torch.models import discriminator_forward, prohmr
from egohmr_tpu_torch.smpl import make_synthetic_model
from egohmr_tpu_torch.train import prohmr_loop
from egohmr_tpu_torch.train import trainable_tensors
from egohmr_tpu_torch.train.prohmr_loop import TRAINED_BUFFERS

from .torch_parity import jax_stage1_draws, randomize, tiny_prohmr_pair, to_jax, to_np

B, S, P, V = 3, 3, 200, 300
LR = 1e-4
# the BatchNorm running statistics: written by the forward pass, not
# differentiated (JAX's gradient there is zero)
STATS = ("running_mean", "running_var", "num_batches_tracked")


class World:
    """Both sides of one tiny stage-1 set-up: weights, a batch with a male
    and two female bodies, three distinct SMPL models (neutral, male,
    female), a discriminator and a mocap batch."""

    def __init__(self, seed=0, **overrides):
        self.jcfg, self.cfg, self.params, self.model = tiny_prohmr_pair(seed, **overrides)
        self.batch = synthetic_batch(B, num_scene_points=P, img_size=64, seed=seed + 5)
        self.batch["gender"] = np.array([0, 1, 1], np.int32)
        self.jsmpl = [j_make_smpl(seed=s, num_vertices=V) for s in range(3)]
        self.smpl = [make_synthetic_model(seed=s, num_vertices=V) for s in range(3)]
        self.dparams = randomize(jdisc.init_discriminator(jax.random.PRNGKey(seed + 10)), seed)
        self.disc = Discriminator()
        self.disc.load_state_dict(discriminator_state_dict_from_jax(self.dparams), strict=True)
        rng = np.random.RandomState(seed + 7)
        self.mocap = {"body_pose": (rng.randn(B, 69) * 0.3).astype(np.float32),
                      "betas": (rng.randn(B, 10) * 0.5).astype(np.float32)}

    def tbatch(self):
        return to_torch(self.batch, "cpu")


@pytest.fixture(scope="module")
def world():
    return World()


def _close(got, want, name, rtol=1e-4):
    got, want = to_np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max(),
                               err_msg=name)


# ------------------------------------------------------------ weights
def test_export_mirrors_match_jax_key_for_key(world):
    """The port's NumPy `export_prohmr` and `export_discriminator` equal
    egohmr_tpu's, key for key and value for value, and the model's own
    `state_dict` after a strict load holds the same keys."""
    for got, want in ((export_prohmr(world.params), jexport.export_prohmr(to_jax(world.params))),
                      (export_discriminator(world.dparams),
                       jexport.export_discriminator(to_jax(world.dparams)))):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert set(world.model.state_dict()) == set(export_prohmr(world.params))
    assert {"discriminator." + k for k in world.disc.state_dict()} == \
        set(export_discriminator(world.dparams))
    assert world.disc.D_conv1.weight.shape == (32, 9, 1, 1)


def test_reference_layout_loads_strictly(world):
    """A reference-layout stage-1 `state_dict` (`export_prohmr` with the
    state nflows stores: ActNorm's `initialized`, the couplings'
    `identity_features` and `transform_features`) loads into `ProHMR` with
    `strict=True`, to the same weights as
    `prohmr_state_dict_from_jax`; and the JAX converter reads the port's
    `state_dict` back to the tree it came from."""
    from egohmr_tpu.interop.torch_convert import convert_prohmr
    from egohmr_tpu_torch.flow import coupling_split

    sd = {k: torch.tensor(np.asarray(v)) for k, v in
          jexport.export_prohmr(to_jax(world.params)).items()}
    b = "flow.flow._transform._transforms."
    for k in range(world.cfg.flow_layers):
        ident, trans = coupling_split(144, k)
        sd[f"{b}{3 * k}.initialized"] = torch.tensor(True)
        sd[f"{b}{3 * k + 2}.identity_features"] = torch.tensor(ident)
        sd[f"{b}{3 * k + 2}.transform_features"] = torch.tensor(trans)
    model = ProHMR(world.cfg)
    model.load_state_dict(sd, strict=True)
    want = world.model.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    back = convert_prohmr({k: v.numpy() for k, v in model.state_dict().items()},
                          num_layers=world.cfg.flow_layers,
                          num_blocks_per_layer=world.cfg.flow_depth, resnet_layers=18)
    for (path, a), b_ in zip(jax.tree_util.tree_leaves_with_path(back),
                             jax.tree_util.tree_leaves(world.params)):
        np.testing.assert_array_equal(np.asarray(a).reshape(np.shape(b_)), b_, err_msg=str(path))


def test_fused_impl_on_cpu_takes_the_plain_encoder(world):
    """`pointnet_impl="fused"` runs K1 only on the card: on CPU tensors the
    context is the plain f32 encoder's, bit for bit, as the JAX package's
    off the TPU."""
    from dataclasses import replace

    with torch.no_grad():
        a = prohmr.conditioning_feats(world.model, world.cfg, world.tbatch())
        b = prohmr.conditioning_feats(world.model, replace(world.cfg, pointnet_impl="fused"),
                                      world.tbatch())
    assert torch.equal(a, b)


# ------------------------------------------------------------ forward
@pytest.mark.parametrize("scene_cano", [False, True], ids=["whole_scene", "scene_cano"])
def test_forward_matches_jax_field_by_field(world, scene_cano):
    """Eval `forward` with S = 3 from the same z (sample 0 the mode): every
    `ProHMROutput` field at rtol 1e-4, atol 1e-4 x the field's largest
    magnitude; the mode's z is zero and the samples differ from it."""
    key = jax.random.PRNGKey(3)
    jout, _ = jax.jit(lambda p, b: jprohmr.forward(p, world.jcfg, world.jsmpl[0], b, key, S,
                                                   scene_cano=scene_cano))(
        to_jax(world.params), to_jax(world.batch))
    z = np.zeros((B, S, 144), np.float32)
    z[:, 1:] = np.asarray(jax.random.normal(key, (B, S - 1, 144)))
    with torch.no_grad():
        out = prohmr.forward(world.model, world.cfg, world.smpl[0], world.tbatch(), S,
                             z=torch.tensor(z), scene_cano=scene_cano)
    assert out._fields == jout._fields
    for name in out._fields:
        _close(getattr(out, name), getattr(jout, name), name)
    assert (out.pred_pose_6d[:, 0] - out.pred_pose_6d[:, 1]).abs().max() > 1e-2


def test_forward_draws_from_the_generator(world):
    """Without `z`, samples 1.. come from the generator (the mode stays
    z = 0): the same seed gives the same samples, the mode is the z = 0
    run's."""
    def run(seed):
        with torch.no_grad():
            return prohmr.forward(world.model, world.cfg, world.smpl[0], world.tbatch(), S,
                                  generator=torch.Generator().manual_seed(seed))

    a, b, c = run(1), run(1), run(2)
    with torch.no_grad():
        mode = prohmr.forward(world.model, world.cfg, world.smpl[0], world.tbatch(), 1)
    assert torch.equal(a.pred_pose_6d, b.pred_pose_6d)
    assert not torch.equal(a.pred_pose_6d[:, 1:], c.pred_pose_6d[:, 1:])
    torch.testing.assert_close(a.pred_pose_6d[:, :1], mode.pred_pose_6d, rtol=1e-5, atol=1e-6)


def test_initialize_matches_jax():
    """`initialize`: the context at the forward's bar (rtol 1e-4, atol 1e-4
    x its largest); on that context and the batch's GT poses, each ActNorm's
    scale exp(log_scale) equals JAX's `initialize_actnorms` at rtol 1e-5, and
    its shift lies within twice JAX's own spread: the largest change of
    JAX's shifts when its input poses move by one ulp (2.0e-5 at the second
    step here: over a batch of 3 a GT rotation entry varies by 0.0037, so
    the first step scales it by 270 and its shifts reach 268). Nothing else
    moves."""
    from egohmr_tpu.flow import initialize_actnorms as j_init_actnorms

    w = World(seed=1)
    jctx, _ = jax.jit(lambda p, b: jprohmr.conditioning_feats(p, w.jcfg, b))(
        to_jax(w.params), to_jax(w.batch))
    before = {k: v.clone() for k, v in w.model.state_dict().items()}
    with torch.no_grad():
        ctx = prohmr.conditioning_feats(w.model, w.cfg, w.tbatch())
        gt6d = to_np(prohmr.gt_pose_prohmr_6d(w.tbatch()))
    _close(ctx, jctx, "context")
    want, moved = (j_init_actnorms(to_jax(w.params["flow"]), w.jcfg.glow_config(),
                                   jnp.asarray(x), jnp.asarray(to_np(ctx)))
                   for x in (gt6d, np.nextafter(gt6d, np.float32(np.inf))))
    prohmr.initialize(w.model, w.cfg, w.tbatch())
    for k, (an, _, _) in enumerate(w.model.flow.flow.steps()):
        jan = want["steps"][k]["actnorm"]
        np.testing.assert_allclose(np.exp(to_np(an.log_scale)[0]),
                                   np.exp(np.asarray(jan["log_scale"])), rtol=1e-5)
        shift = np.asarray(jan["shift"])
        spread = np.abs(np.asarray(moved["steps"][k]["actnorm"]["shift"]) - shift).max()
        assert 0 < spread < 1e-4
        np.testing.assert_allclose(to_np(an.shift)[0], shift, rtol=0, atol=2 * spread,
                                   err_msg=f"step {k}")
    for k, v in w.model.state_dict().items():
        if not k.endswith(("log_scale", "shift")):
            assert torch.equal(v, before[k]), k


# ------------------------------------------------------------ losses
def test_compute_loss_eval_matches_jax(world):
    """Eval `compute_loss` (no NLL noise) on the same outputs: the loss and
    every term at rtol 1e-4."""
    key = jax.random.PRNGKey(4)

    @jax.jit
    def jax_side(jp, jb):
        jout, _ = jprohmr.forward(jp, world.jcfg, world.jsmpl[0], jb, key, S)
        return jprohmr.compute_loss(jp, world.jcfg, jprohmr.ProHMRLossWeights(),
                                    *world.jsmpl[1:], jb, jout, None, train=False)[1]

    jterms = jax_side(to_jax(world.params), to_jax(world.batch))
    z = np.zeros((B, S, 144), np.float32)
    z[:, 1:] = np.asarray(jax.random.normal(key, (B, S - 1, 144)))
    with torch.no_grad():
        out = prohmr.forward(world.model, world.cfg, world.smpl[0], world.tbatch(), S,
                             z=torch.tensor(z))
        _, terms = prohmr.compute_loss(world.model, world.cfg, ProHMRLossWeights(),
                                       *world.smpl[1:], world.tbatch(), out, train=False)
    assert set(terms) == set(jterms)
    for k in jterms:
        np.testing.assert_allclose(float(terms[k]), float(jterms[k]), rtol=1e-4, err_msg=k)
    assert float(terms["loss_v2v_exp"]) > 0 and float(terms["loss_nll"]) != 0


@pytest.fixture(scope="module")
def train_grads():
    """Training-mode `generator_loss` on both sides with the JAX draws, and
    the discriminator loss on its fakes: losses, terms, gradients (of G,
    `init_betas` and `init_cam` included, and of D) and the BatchNorm
    running statistics of the forward."""
    w = World(seed=2)
    wts = jprohmr.ProHMRLossWeights()
    key = jax.random.PRNGKey(5)
    jargs = (w.jcfg, wts, *w.jsmpl, to_jax(w.batch), key)

    def jg(p, dp):
        return jloop.generator_loss(p, dp, *jargs)

    (jtotal, (jterms, jnew, jfake)), jgrad = jax.jit(jax.value_and_grad(jg, has_aux=True))(
        to_jax(w.params), to_jax(w.dparams))
    (jd, jdterms), jdgrad = jax.jit(jax.value_and_grad(
        lambda dp, *f: jloop.discriminator_loss(dp, wts, to_jax(w.mocap), *f), has_aux=True))(
        to_jax(w.dparams), *jfake)

    trained = trainable_tensors(w.model, TRAINED_BUFFERS)
    draws = jax_stage1_draws(key, w.cfg, B)
    w.disc.requires_grad_(False)
    total, terms, fake = prohmr_loop.generator_loss(
        w.model, w.disc, w.cfg, ProHMRLossWeights(), *w.smpl, w.tbatch(), **draws)
    total.backward()
    w.disc.requires_grad_(True)
    d, dterms = prohmr_loop.discriminator_loss(w.disc, ProHMRLossWeights(),
                                               to_torch(w.mocap, "cpu"), *fake)
    d.backward()
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(jtotal=float(jtotal), jterms=jterms, jfake=jfake, jnew=host(jnew),
                jgrad=export_prohmr(host(jgrad)), jd=float(jd), jdterms=jdterms,
                jdgrad=export_discriminator(host(jdgrad), ""),
                total=float(total.detach()), terms={k: v.detach() for k, v in terms.items()},
                d=float(d.detach()), dterms={k: v.detach() for k, v in dterms.items()},
                trained=trained, w=w)


def test_train_loss_and_terms_match_jax(train_grads):
    """The generator's total, every term (`loss_gen` included) and the
    discriminator's loss at rtol 1e-4; the BatchNorm running statistics of
    the train-mode forward at rtol 1e-5."""
    g = train_grads
    np.testing.assert_allclose(g["total"], g["jtotal"], rtol=1e-4)
    assert set(g["terms"]) == set(g["jterms"]) and "loss_gen" in g["terms"]
    for k, v in g["jterms"].items():
        np.testing.assert_allclose(float(g["terms"][k]), float(v), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(g["d"], g["jd"], rtol=1e-4)
    np.testing.assert_allclose(float(g["dterms"]["loss_disc"]),
                               float(g["jdterms"]["loss_disc"]), rtol=1e-4)
    want = export_prohmr(g["jnew"])
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        _close(g["w"].model.state_dict()[k], want[k], k, rtol=1e-5)


def test_generator_gradients_match_jax(train_grads):
    """Every trained tensor's gradient, `init_betas` and `init_cam`
    included: rtol 1e-3, atol 1e-3 x the tensor's largest; the
    discriminator's weights take no gradient from the generator's loss."""
    g = train_grads
    assert set(TRAINED_BUFFERS) <= set(g["trained"])
    for k, t in g["trained"].items():
        _close(t.grad, g["jgrad"][k], k, rtol=1e-3)
    assert all(p.grad is not None for p in g["w"].disc.parameters())  # D's own loss only
    assert not any(k.endswith(STATS) for k in g["trained"])


def test_discriminator_matches_jax(train_grads):
    """The discriminator on identical inputs (JAX's fakes and the mocap
    poses): its logits at rtol 1e-5, atol 1e-6, and the gradient of its loss
    to every weight at rtol 1e-3, atol 1e-3 x the tensor's largest. (On each
    side's own fakes, which differ at f32 noise, a ReLU of `D_conv2` near
    zero can switch between the sides and move a column of
    `D_alljoints_fc1`'s gradient: the step test holds that to 2 lr.)"""
    from egohmr_tpu.geometry import aa_to_rotmat as j_aa_to_rotmat

    g = train_grads
    w = g["w"]
    rot = np.asarray(j_aa_to_rotmat(jnp.asarray(w.mocap["body_pose"]).reshape(-1, 3)))
    rot = rot.reshape(B, 23, 3, 3)
    want = jdisc.discriminator_forward(to_jax(w.dparams), jnp.asarray(rot),
                                       jnp.asarray(w.mocap["betas"]))
    disc = Discriminator()
    disc.load_state_dict(discriminator_state_dict_from_jax(w.dparams), strict=True)
    with torch.no_grad():
        got = discriminator_forward(disc, torch.tensor(rot), torch.tensor(w.mocap["betas"]))
    assert got.shape == (B, 25)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)
    fake = [torch.tensor(np.asarray(f)) for f in g["jfake"]]
    d, _ = prohmr_loop.discriminator_loss(disc, ProHMRLossWeights(), to_torch(w.mocap, "cpu"),
                                          *fake)
    d.backward()
    np.testing.assert_allclose(float(d.detach()), g["jd"], rtol=1e-5)
    for k, p in disc.named_parameters():
        _close(p.grad, g["jdgrad"][k], k, rtol=1e-3)


# ------------------------------------------------------------ one step
def test_one_g_d_step_matches_jax():
    """One G+D step through `make_prohmr_train_step` on both sides, from the
    same weights and fresh AdamW states, on the JAX draws (the bars of the
    stage-2 step test): every element within 2 lr, at most 5e-4 of them
    beyond rtol 1e-4; `init_betas` and `init_cam` moved by Adam's first step
    (about lr) and equal at rtol 1e-4; the BatchNorm statistics at rtol
    1e-5; the metrics at rtol 1e-4."""
    w = World(seed=3)
    wts = jprohmr.ProHMRLossWeights()
    opt, dopt = optax.adamw(LR, weight_decay=1e-4), optax.adamw(LR, weight_decay=1e-4)
    params, dparams = to_jax(w.params), to_jax(w.dparams)
    step = jloop.make_prohmr_train_step(w.jcfg, wts, *w.jsmpl, opt, dopt)
    key = jax.random.PRNGKey(6)
    new, dnew, _, _, jm = step(params, dparams, opt.init(params), dopt.init(dparams),
                               to_jax(w.batch), to_jax(w.mocap), key)
    g_opt, d_opt = prohmr_loop.make_optimizers(w.model, w.disc, LR, 1e-4)
    tstep = prohmr_loop.make_prohmr_train_step(w.cfg, ProHMRLossWeights(), *w.smpl, g_opt, d_opt)
    m = tstep(w.model, w.disc, w.tbatch(), to_torch(w.mocap, "cpu"),
              **jax_stage1_draws(key, w.cfg, B))
    assert set(m) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-4, err_msg=k)

    want = {**export_prohmr(jax.tree_util.tree_map(np.asarray, new)),
            **{"D." + k: v for k, v in
               export_discriminator(jax.tree_util.tree_map(np.asarray, dnew), "").items()}}
    got = {**{k: to_np(v) for k, v in w.model.state_dict().items()},
           **{"D." + k: to_np(v) for k, v in w.disc.state_dict().items()}}
    start = {**export_prohmr(w.params), **{"D." + k: v for k, v in
                                           export_discriminator(w.dparams, "").items()}}
    loose, n = 0, 0
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            _close(got[k], v, k, rtol=1e-5)
            continue
        if k.endswith("num_batches_tracked"):
            continue
        # Adam's first step is about +-lr: 2 lr where the two sides' gradient
        # signs differ, plus the f32 rounding of the weight
        np.testing.assert_allclose(got[k], v, rtol=0, atol=2 * LR * (1 + 1e-3), err_msg=k)
        loose += int((np.abs(got[k] - v) > 1e-4 * np.abs(v) + 1e-8).sum())
        n += v.size
    assert loose <= 5e-4 * n, (loose, n)
    for k in TRAINED_BUFFERS:
        moved = np.abs(want[k] - start[k])
        assert (moved > LR / 2).all(), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
