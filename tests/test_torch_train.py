"""Port parity of stage-2 training's forward and backward: train-mode
BatchNorm, the GCN's non-local block, ResNet in train mode, `stage2_loss`
(loss, terms, gradients, BatchNorm statistics) and `compute_loss`, against
egohmr_tpu on the same weights, batch and draws (t, noise and the
condition-drop mask drawn on the JAX side as its
`train/loop.py:stage2_loss` draws them, and handed to the port). The steps
themselves are `test_torch_train_step.py`'s."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egohmr_tpu.diffusion import make_schedule as j_make_schedule
from egohmr_tpu.models import BodyRepStats as JStats
from egohmr_tpu.models import LossWeights as JWeights
from egohmr_tpu.models.egohmr import _ADJ
from egohmr_tpu.nn import core as jcore
from egohmr_tpu.nn.gcn import modulated_gcn_forward as j_gcn_forward
from egohmr_tpu.nn.gcn import nonlocal_block as j_nonlocal_block
from egohmr_tpu.nn.resnet import resnet_forward as j_resnet_forward
from egohmr_tpu.smpl import make_synthetic_model as j_make_smpl
from egohmr_tpu.train import loop as jloop
from egohmr_tpu_torch.data import synthetic_batch, to_torch
from egohmr_tpu_torch.diffusion import make_schedule
from egohmr_tpu_torch.interop import export_arrays
from egohmr_tpu_torch.models import BodyRepStats, LossWeights
from egohmr_tpu_torch.nn import core as tcore
from egohmr_tpu_torch.nn.gcn import modulated_gcn_forward as t_gcn_forward
from egohmr_tpu_torch.nn.gcn import nonlocal_block as t_nonlocal_block
from egohmr_tpu_torch.nn.resnet import resnet_forward as t_resnet_forward
from egohmr_tpu_torch.smpl import make_synthetic_model
from egohmr_tpu_torch.train import stage2_loss, trainable_tensors

from .torch_parity import tiny_pair, to_jax, to_np

B, P, V, T = 4, 64, 64, 50
# a GCN of 1 layer x 16; cond_mask_prob 0.5 so that the drop masks the
# tests draw have true entries
SMALL = dict(gcn_layers=1, gcn_hid_dim=16, cond_mask_prob=0.5)
# biases whose gradient is zero up to rounding: those that feed a BatchNorm
# (the graph convolutions', the non-local block's W.0 and, through the
# softmax's rows summing to 1, its g), and phi's, which shifts each row of
# the softmax's logits by a constant
ZERO_GRAD = (".gconv.bias", "non_local.W.0.bias", "non_local.g.bias", "non_local.phi.bias")
TERMS = ("loss", "loss_v2v", "loss_keypoints_3d", "loss_keypoints_3d_full",
         "loss_keypoints_2d_full", "loss_betas", "loss_body_pose", "loss_global_orient",
         "loss_pose_6d_ortho", "loss_coap_penetration")


# ------------------------------------------------------------ batch norm
def _bn(c, seed):
    """A JAX BatchNorm dict and a torch BatchNorm1d holding the same values."""
    rng = np.random.RandomState(seed)
    p = {"scale": 1 + 0.1 * rng.randn(c), "bias": 0.1 * rng.randn(c),
         "mean": 0.3 * rng.randn(c), "var": 1 + rng.rand(c)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    bn = torch.nn.BatchNorm1d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(p["scale"]))
        bn.bias.copy_(torch.tensor(p["bias"]))
        bn.running_mean.copy_(torch.tensor(p["mean"]))
        bn.running_var.copy_(torch.tensor(p["var"]))
    return p, bn


@pytest.mark.parametrize("layout", ["gcn", "resnet"])
def test_batchnorm_train_matches_jax(layout):
    """f32: output, the new running statistics (unbiased by n/(n-1),
    momentum 0.1) and the gradients through the batch statistics, to x,
    scale and bias. `gcn`: [B, 24, C] over (batch, joints); `resnet`: the
    port's NCHW against JAX's NHWC, over (N, H, W)."""
    c = 8
    p, bn = _bn(c, 0)
    rng = np.random.RandomState(1)
    shape, axes = ((5, 24, c), (0, 1)) if layout == "gcn" else ((3, 5, 6, c), (0, 1, 2))
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    cot = rng.randn(*shape).astype(np.float32)

    def jfn(xx, scale, bias):
        return jcore.batchnorm({**to_jax(p), "scale": scale, "bias": bias}, xx,
                               train=True, reduce_axes=axes)

    want, new = jfn(jnp.asarray(x), jnp.asarray(p["scale"]), jnp.asarray(p["bias"]))
    _, pullback = jax.vjp(lambda *a: jfn(*a)[0], jnp.asarray(x), jnp.asarray(p["scale"]),
                          jnp.asarray(p["bias"]))
    gx, gs, gb = pullback(jnp.asarray(cot))

    def nchw(a):  # the port's layout of a [B, ..., C] array, and back
        return a if layout == "gcn" else a.transpose(0, 3, 1, 2)

    def back(t):
        return t if layout == "gcn" else t.permute(0, 2, 3, 1)

    xt = torch.tensor(nchw(x).copy(), requires_grad=True)
    got = tcore.batchnorm(bn, xt, -1 if layout == "gcn" else 1, train=True)
    (got * torch.tensor(nchw(cot).copy())).sum().backward()
    np.testing.assert_allclose(to_np(back(got)), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(bn.running_mean), np.asarray(new["mean"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(to_np(bn.running_var), np.asarray(new["var"]), rtol=1e-5)
    np.testing.assert_allclose(to_np(back(xt.grad)), np.asarray(gx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(bn.weight.grad), np.asarray(gs), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_np(bn.bias.grad), np.asarray(gb), rtol=1e-4, atol=1e-4)


def test_batchnorm_train_bf16_stats_match_f32():
    """bf16 activations: the output stays bf16, the statistics are f32 and
    differ from the f32 ones only through the bf16 rounding of the input,
    to the bars of the JAX package's own test; and the port's bf16 run
    equals JAX's bf16 run."""
    p, bn32 = _bn(8, 3)
    _, bn16 = _bn(8, 3)
    x = (np.random.RandomState(3).randn(64, 8) * 3.0 + 1.0).astype(np.float32)
    y32 = tcore.batchnorm(bn32, torch.tensor(x), -1, train=True)
    y16 = tcore.batchnorm(bn16, torch.tensor(x).to(torch.bfloat16), -1, train=True)
    assert y16.dtype == torch.bfloat16
    assert bn16.running_mean.dtype == torch.float32 and bn16.running_var.dtype == torch.float32
    np.testing.assert_allclose(to_np(bn16.running_mean), to_np(bn32.running_mean), atol=5e-2)
    np.testing.assert_allclose(to_np(bn16.running_var), to_np(bn32.running_var),
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(to_np(y16), to_np(y32), atol=0.12)
    want, new = jcore.batchnorm(to_jax(p), jnp.asarray(x).astype(jnp.bfloat16), train=True,
                                reduce_axes=(0,))
    np.testing.assert_allclose(to_np(y16), np.asarray(want, np.float32), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(to_np(bn16.running_var), np.asarray(new["var"]), rtol=1e-5)


# ------------------------------------------------------------ non-local
@pytest.fixture(scope="module")
def nonlocal_pair():
    """A strict `load_state_dict` of `state_dict_from_jax` of a JAX tree
    with the non-local block (tiny_pair loads strictly)."""
    return tiny_pair(seed=4, gcn_nonlocal_layer=True, gcn_layers=1, gcn_hid_dim=16)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_nonlocal_block_matches_jax(nonlocal_pair, train):
    """The block alone and the whole GCN with it, at rtol/atol 2e-5; in
    training, the block's BatchNorm statistics over (batch, nodes) too."""
    _, cfg, params, model = nonlocal_pair
    jp = to_jax(params["diffusion_model"])
    x = np.random.RandomState(5).randn(3, 24, cfg.gcn_hid_dim).astype(np.float32)
    want, new = j_nonlocal_block(jp["non_local"], jnp.asarray(x), train=train, axis_name=None)
    nl = model.diffusion_model.non_local
    saved = {k: v.clone() for k, v in nl.state_dict().items()}
    got = t_nonlocal_block(nl, torch.tensor(x), train=train)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(to_np(nl.W[1].running_var), np.asarray(new["bn"]["var"]),
                               rtol=1e-5)
    nl.load_state_dict(saved)

    xg = np.random.RandomState(6).randn(3, 24, cfg.gcn_in_dim).astype(np.float32)
    want, _ = j_gcn_forward(jp, _ADJ, jnp.asarray(xg), train=train)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    got = t_gcn_forward(model.diffusion_model, torch.tensor(_ADJ), torch.tensor(xg), train=train)
    model.load_state_dict(saved)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_nonlocal_state_dict_equals_export_egohmr(nonlocal_pair):
    """The non-local block's keys and values, as the JAX package's own
    exporter writes them (1x1 convs and the output BatchNorm)."""
    from egohmr_tpu.interop.torch_export import export_egohmr

    _, _, params, model = nonlocal_pair
    want = export_egohmr(params)
    got = model.state_dict()
    keys = [k for k in want if ".non_local." in k]
    assert len(keys) == 13 and set(got) == set(want)
    for k in keys:
        np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k], np.float32), err_msg=k)


def _nonlocal_cond(nonlocal_pair):
    """The same eval-mode condition on both sides, with (x_t, t)."""
    from egohmr_tpu.models import compute_condition as j_cond
    from egohmr_tpu_torch.models import compute_condition

    jcfg, cfg, params, model = nonlocal_pair
    batch = synthetic_batch(3, num_scene_points=P, img_size=64, seed=9)
    x = np.random.RandomState(2).randn(3, 144).astype(np.float32)
    t = np.array([0, 17, 49])
    jc, _ = j_cond(to_jax(params), jcfg, to_jax(batch))
    with torch.no_grad():
        cond = compute_condition(model, cfg, to_torch(batch, "cpu"))
    return jc, cond, x, t


def test_denoise_x0_matches_jax(nonlocal_pair):
    """`denoise_x0` as training runs it (JAX's fuse=False, train=True), with
    the non-local block: the prediction at rtol/atol 2e-5 and every GCN
    BatchNorm's new running statistics at rtol 1e-5."""
    from egohmr_tpu.models.egohmr import denoise_x0 as j_denoise_x0
    from egohmr_tpu_torch.models import denoise_x0

    jcfg, cfg, params, model = nonlocal_pair
    jc, cond, x, t = _nonlocal_cond(nonlocal_pair)
    want, new = j_denoise_x0(to_jax(params), jcfg, jc, jnp.asarray(x), jnp.asarray(t),
                             fuse=False, train=True)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        got = denoise_x0(model, cfg, cond, torch.tensor(x), torch.tensor(t))
    got_sd = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(saved)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)
    want_sd = export_arrays(jax.tree_util.tree_map(np.asarray, new))
    keys = [k for k in got_sd if k.startswith("diffusion_model.")
            and k.endswith(("running_mean", "running_var"))]
    assert keys and any(".non_local." in k for k in keys)
    for k in keys:
        assert not np.array_equal(to_np(got_sd[k]), to_np(saved[k])), k
        np.testing.assert_allclose(to_np(got_sd[k]), want_sd[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_fused_denoise_fn_with_nonlocal_matches_jax(nonlocal_pair):
    """The sampler's fused predictor (cond and uncond in one doubled batch,
    the visible joints from the cond half) with the non-local block, against
    JAX's `make_denoise_fn(fuse=True)`: rtol and atol 2e-5."""
    from egohmr_tpu.models.egohmr import make_denoise_fn as j_make_denoise_fn
    from egohmr_tpu_torch.models import make_denoise_fn

    jcfg, cfg, params, model = nonlocal_pair
    jc, cond, x, t = _nonlocal_cond(nonlocal_pair)
    want = j_make_denoise_fn(to_jax(params), jcfg, jc, fuse=True)(jnp.asarray(x),
                                                                  jnp.asarray(t))
    with torch.no_grad():
        got = make_denoise_fn(model, cfg, cond, fuse=True)(torch.tensor(x), torch.tensor(t))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_resnet18_train_mode_matches_jax():
    """Every BatchNorm of the stem and the blocks on the batch's statistics:
    the features and all the new running statistics."""
    _, _, params, model = tiny_pair(seed=6)
    x = np.random.RandomState(8).randn(3, 64, 64, 3).astype(np.float32)
    want, new = j_resnet_forward(to_jax(params["backbone"]), jnp.asarray(x), train=True)
    got = t_resnet_forward(model.backbone, torch.tensor(x), train=True)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    want_sd = export_arrays({**params, "backbone": jax.tree_util.tree_map(np.asarray, new)})
    for k, v in model.state_dict().items():
        if k.startswith("backbone.") and k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(to_np(v), want_sd[k], rtol=1e-5, atol=1e-6, err_msg=k)


# ------------------------------------------------------------ the step
def jax_draws(key, batch_size: int, prob: float):
    """(t, noise, drop) as `egohmr_tpu.train.loop.stage2_loss` draws them
    from `key` for a one-device step."""
    sample_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(batch_size))
    ks = jax.vmap(lambda k: jax.random.split(k, 3))(sample_keys)
    t = jax.vmap(lambda k: jax.random.randint(k, (), 0, T))(ks[:, 0])
    noise = jax.vmap(lambda k: jax.random.normal(k, (144,)))(ks[:, 1])
    drop = jax.vmap(lambda k: jax.random.bernoulli(k, prob, ()))(ks[:, 2])
    return {"t": torch.tensor(np.array(t), dtype=torch.int64),
            "noise": torch.tensor(np.array(noise)), "drop": torch.tensor(np.array(drop))}


class World:
    """The JAX and the port side of one tiny training set-up."""

    def __init__(self, seed=0, **overrides):
        self.jcfg, self.cfg, self.params, self.model = tiny_pair(seed=seed, **{**SMALL, **overrides})
        self.batch = synthetic_batch(B, num_scene_points=P, img_size=64, seed=seed + 3)
        self.jsmpl = [j_make_smpl(seed=s, num_vertices=V) for s in range(3)]
        self.smpl = [make_synthetic_model(seed=s, num_vertices=V) for s in range(3)]
        self.jschedule = j_make_schedule(T, "cosine", "")
        self.schedule = make_schedule(T, "cosine", "")
        self.jstats = JStats(jnp.zeros(144), jnp.ones(144))
        self.stats = BodyRepStats(torch.zeros(144), torch.ones(144))

    def jax_loss(self, params, key, **kw):
        return jloop.stage2_loss(params, self.jcfg, JWeights(), self.jschedule, self.jstats,
                                 *self.jsmpl, to_jax(self.batch), key, **kw)

    def port_loss(self, model, draws, **kw):
        return stage2_loss(model, self.cfg, LossWeights(), self.schedule, self.stats,
                           *self.smpl, to_torch(self.batch, "cpu"), **draws, **kw)


CASES = {"plain": dict(coll=False, extra={}),
         "collision": dict(coll=True, extra={}),
         "nonlocal": dict(coll=False, extra=dict(gcn_nonlocal_layer=True))}


@pytest.fixture(scope="module", params=list(CASES))
def f32_loss(request):
    """Both sides' f32 loss, terms, gradients and BatchNorm statistics on
    the same draws; the collision case scores the 32 scene points nearest
    the body's bbox."""
    case = CASES[request.param]
    w = World(**case["extra"])
    key = jax.random.PRNGKey(11)
    kw = dict(use_collision=case["coll"], max_collision_points=32)
    (jtotal, (jterms, jnew)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: w.jax_loss(p, key, **kw), has_aux=True))(to_jax(w.params))
    draws = jax_draws(key, B, w.cfg.cond_mask_prob)
    trained = trainable_tensors(w.model)
    total, terms = w.port_loss(w.model, draws, **kw)
    total.backward()
    return dict(
        case=request.param, draws=draws, want_terms={k: float(v) for k, v in jterms.items()},
        got_terms={k: float(v.detach()) for k, v in terms.items()},
        want_grads=export_arrays(jax.tree_util.tree_map(np.asarray, jgrads)),
        want_pe_grad=np.asarray(jgrads["embed_timestep"]["pe"]),
        got_grads={k: to_np(t.grad) for k, t in trained.items()},
        want_state=export_arrays(jax.tree_util.tree_map(np.asarray, jnew)),
        got_state={k: to_np(v) for k, v in w.model.state_dict().items()})


def test_draws_drop_some_conditions(f32_loss):
    drop = f32_loss["draws"]["drop"]
    assert drop.any() and not drop.all()


def test_stage2_loss_terms_match_jax(f32_loss):
    """The loss and each of its nine terms at rtol 1e-4; the collision term
    is non-zero where it is on. That term is a mean over the six scene
    points inside the body's bbox, so it carries the f32 difference of the
    predicted vertices unaveraged (up to 3.7e-5 m here, from ResNet's
    train-mode features): rtol 1e-3. On identical vertices it agrees to
    rtol 1e-5 (`test_compute_loss_matches_jax_on_the_same_outputs`)."""
    want, got = f32_loss["want_terms"], f32_loss["got_terms"]
    assert set(got) == set(want) == set(TERMS)
    for k in TERMS:
        rtol = 1e-3 if k == "loss_coap_penetration" else 1e-4
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-7, err_msg=k)
    assert (want["loss_coap_penetration"] > 0) == (f32_loss["case"] == "collision")


def test_stage2_loss_gradients_match_jax(f32_loss):
    """Every gradient at rtol 1e-3, atol 1e-3 x the leaf's largest magnitude,
    the timestep table `pe` (a trained leaf in JAX) and `init_betas`
    included. The biases of `ZERO_GRAD` have a gradient of zero up to
    rounding on both sides: held to 1e-5 x the largest gradient."""
    want, got = f32_loss["want_grads"], f32_loss["got_grads"]
    want = {k: v for k, v in want.items()
            if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    assert set(got) == set(want) | {"embed_timestep.pe"}
    want["embed_timestep.pe"] = f32_loss["want_pe_grad"]
    assert np.abs(want["embed_timestep.pe"]).max() > 0
    top = max(np.abs(v).max() for v in want.values())
    for k in want:
        atol = 1e-5 * top if k.endswith(ZERO_GRAD) else 1e-3 * np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=atol, err_msg=k)


def test_stage2_loss_batchnorm_statistics_match_jax(f32_loss):
    """The running statistics the forward pass wrote, at rtol 1e-5 with atol
    1e-5 x the leaf's largest magnitude: the batch means deep in the ResNet
    carry the convolutions' f32 summation-order differences."""
    want, got = f32_loss["want_state"], f32_loss["got_state"]
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) > 40
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5 * np.abs(want[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_compute_loss_matches_jax_on_the_same_outputs(train):
    """`compute_loss` on the JAX model's outputs and condition, with the
    collision term on (top-32 scene points, K2's plain version here):
    every term at rtol 1e-5, and in eval the per-sample visible-joint error
    sums and counts (the second body stands outside the image)."""
    from egohmr_tpu.models import compute_condition as j_cond
    from egohmr_tpu.models import compute_loss as j_loss
    from egohmr_tpu.models import make_denoise_fn as j_denoise
    from egohmr_tpu.models import model_outputs as j_outputs
    from egohmr_tpu_torch.models import Condition, compute_loss

    w = World(seed=7)
    w.batch["smpl_params"]["transl"][1, 0] = 4.0
    jp, jb = to_jax(w.params), to_jax(w.batch)

    @jax.jit
    def jax_side(jp, jb):
        jc, _ = j_cond(jp, w.jcfg, jb)
        x = jax.random.normal(jax.random.PRNGKey(1), (B, 144))
        jout = j_outputs(w.jcfg, w.jsmpl[0], jc,
                         j_denoise(jp, w.jcfg, jc)(x, jnp.full((B,), 9)), w.jstats)
        _, want = j_loss(w.jcfg, JWeights(), *w.jsmpl, jb, jc, jout, train=train,
                         use_collision=True, max_collision_points=32)
        return jc, jout, want

    jc, jout, want = jax_side(jp, jb)
    cond = Condition(*(torch.tensor(np.array(a)) for a in jc))
    outputs = {k: torch.tensor(np.array(v)) for k, v in jout.items()}
    _, got = compute_loss(w.cfg, LossWeights(), *w.smpl, to_torch(w.batch, "cpu"), cond,
                          outputs, train=train, use_collision=True, max_collision_points=32)
    assert set(got) == set(want)
    assert float(want["loss_coap_penetration"]) > 0
    if not train:
        assert 0 < int(want["joint_vis_num_batch"]) <= 3 * 24
    for k in want:
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k], np.float32), rtol=1e-5,
                                   atol=1e-8, err_msg=k)
