"""Port parity of the stage-2 training step: AdamW against optax, one and
three f32 steps through `make_train_step` against the JAX package's, bf16
mixed precision (loss, gradients, state dtypes), the overfit check and what
the optimizer covers. The set-up is `test_torch_train.py`'s."""
import jax
import numpy as np
import pytest
import torch

from egohmr_tpu.models import LossWeights as JWeights
from egohmr_tpu.train import loop as jloop
from egohmr_tpu_torch.data import synthetic_batch, to_torch
from egohmr_tpu_torch.interop import export_arrays, state_dict_from_jax
from egohmr_tpu_torch.models import LossWeights
from egohmr_tpu_torch.train import TrainConfig, make_optimizer, make_train_step, trainable_tensors

from .test_torch_train import B, P, ZERO_GRAD, World, jax_draws
from .torch_parity import to_jax, to_np


def _flat(params, model):
    """{name: (JAX value, port value)} over every trained tensor, `pe`
    included, and the BatchNorm running statistics."""
    want = export_arrays(params)
    got = {k: to_np(v) for k, v in model.state_dict().items()}
    out = {k: (want[k], got[k]) for k in want if not k.endswith("num_batches_tracked")}
    out["embed_timestep.pe"] = (params["embed_timestep"]["pe"], to_np(model.embed_timestep.pe))
    return out


def test_adamw_equals_optax_on_the_same_gradients():
    """`make_optimizer`'s AdamW (decoupled decay, every trained tensor, `pe`
    and `init_betas` included) against `egohmr_tpu`'s masked `optax.adamw`,
    three steps on the same gradients: rtol 1e-5, atol 1e-7."""
    import optax

    w = World(seed=1)
    tcfg = TrainConfig(lr=1e-3, weight_decay=1e-2)
    jopt = jloop.make_optimizer(tcfg)
    params = to_jax(w.params)
    state = jopt.init(params)
    opt = make_optimizer(w.model, tcfg)
    trained = trainable_tensors(w.model)
    rng = np.random.RandomState(0)

    @jax.jit
    def jstep(g, state, params):
        upd, state = jopt.update(g, state, params)
        return optax.apply_updates(params, upd), state

    g0 = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), w.params)
    for i in range(3):
        g = jax.tree_util.tree_map(lambda a: a * (-0.3) ** i + 0.1 * i, g0)
        flat = export_arrays(g)
        for k, t in trained.items():
            t.grad = torch.tensor(g["embed_timestep"]["pe"] if k == "embed_timestep.pe"
                                  else flat[k])
        opt.step()
        params, state = jstep(to_jax(g), state, params)
    pairs = _flat(jax.tree_util.tree_map(np.asarray, params), w.model)
    for k in trained:
        want, got = pairs[k]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7, err_msg=k)


def _load_jax_state(model, opt, params, state):
    """Set the port's model and AdamW to a JAX step's params and optax
    state: weights, BatchNorm statistics, `pe`, Adam's moments and count."""
    import optax

    pnp = jax.tree_util.tree_map(np.asarray, params)
    model.load_state_dict(state_dict_from_jax(pnp), strict=True)
    with torch.no_grad():
        model.embed_timestep.pe.copy_(torch.tensor(pnp["embed_timestep"]["pe"]))
    masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    adam = next(x for x in jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState))

    def flat(tree):  # BatchNorm statistics are masked out: zeros there
        full = jax.tree_util.tree_map(
            lambda m, p: np.zeros(np.shape(p), np.float32) if masked(m) else np.asarray(m),
            tree, pnp, is_leaf=masked)
        return {**export_arrays(full), "embed_timestep.pe": full["embed_timestep"]["pe"]}

    mu, nu = flat(adam.mu), flat(adam.nu)
    for k, t in trainable_tensors(model).items():
        opt.state[t] = {"step": torch.tensor(float(adam.count)),
                        "exp_avg": torch.tensor(mu[k]), "exp_avg_sq": torch.tensor(nu[k])}


@pytest.fixture(scope="module")
def three_steps():
    """Three f32 steps at lr 1e-4 on both sides, the port run twice: on its
    own from the start, and with each step started from JAX's state before
    it. Returns (tcfg, JAX and port tensors after each step of the free
    run, the same for the steps from JAX's state, each side's losses, JAX's
    params before each step)."""
    w = World(seed=1)
    forced = World(seed=1)
    tcfg = TrainConfig(lr=1e-4, mixed_precision=False)
    jopt = jloop.make_optimizer(tcfg)
    jstep = jloop.make_train_step(w.jcfg, jloop.TrainConfig(**vars(tcfg)), JWeights(),
                                  w.jschedule, w.jstats, *w.jsmpl, jopt)
    params = to_jax(w.params)
    state = jopt.init(params)
    opt = make_optimizer(w.model, tcfg)
    step = make_train_step(w.cfg, tcfg, LossWeights(), w.schedule, w.stats, *w.smpl, opt)
    fopt = make_optimizer(forced.model, tcfg)
    fstep = make_train_step(w.cfg, tcfg, LossWeights(), w.schedule, w.stats, *w.smpl, fopt)
    jlosses, losses, after, after_forced, before = [], [], [], [], []
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        before.append(jax.tree_util.tree_map(np.asarray, params))
        _load_jax_state(forced.model, fopt, params, state)
        params, state, m = jstep(params, state, to_jax(w.batch), key)
        jlosses.append(float(m["loss"]))
        draws = jax_draws(key, B, w.cfg.cond_mask_prob)
        losses.append(float(step(w.model, to_torch(w.batch, "cpu"), **draws)["loss"]))
        fstep(forced.model, to_torch(w.batch, "cpu"), **draws)
        now = jax.tree_util.tree_map(np.asarray, params)
        after.append(_flat(now, w.model))
        after_forced.append(_flat(now, forced.model))
    return tcfg, after, after_forced, jlosses, losses, before


def test_one_f32_step_matches_jax(three_steps):
    """One f32 step through `make_train_step` on both sides: each trained
    tensor at rtol 1e-4 (`pe`'s drawn rows and `init_betas` included) and
    the BatchNorm statistics from the forward pass at rtol 1e-5. Adam's
    first step moves an element by lr g / (|g| + 1e-8), about lr x sign(g),
    so where f32 does not settle the sign of g, or g is near Adam's epsilon,
    the two sides may differ by up to 2 lr: the biases of `ZERO_GRAD`, and
    at most 5e-4 of the other elements (in the ResNet and the betas head,
    whose gradients reach 1e-9)."""
    tcfg, after, _, jlosses, losses, before = three_steps
    start = before[0]
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-4)
    loose, n = 0, 0
    for k, (want, got) in after[0].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                                       err_msg=k)
            continue
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * tcfg.lr, err_msg=k)
        if not k.endswith(ZERO_GRAD):
            loose += int((np.abs(got - want) > 1e-4 * np.abs(want) + 1e-8).sum())
            n += want.size
    assert loose <= 5e-4 * n, (loose, n)
    pe_j, pe_t = after[0]["embed_timestep.pe"]
    rows = np.abs(pe_j - start["embed_timestep"]["pe"]).max(1) > tcfg.lr / 2
    assert 1 <= rows.sum() <= B  # the drawn rows took an Adam step, the rest decay only
    np.testing.assert_allclose(pe_t[rows], pe_j[rows], rtol=1e-4, atol=1e-8)
    betas_j, _ = after[0]["beta_layer.init_betas"]
    moved = np.abs(betas_j - start["beta_layer"]["init_betas"].reshape(1, 10))
    assert (moved > tcfg.lr / 2).all()  # JAX trains init_betas too: Adam's first step, ~lr


# the share of elements beyond rtol 1e-4 allowed at each of the three steps
# from JAX's state, over the whole model (read: 6.6e-5, 2.7e-3, 2.5e-4;
# `tests/train_step_drift.py`). Step 2 lands where JAX's own gradient is
# ill-conditioned: each of four one-ulp perturbations of its weights moves
# its gradient by 1.6-4.4% of a tensor's largest element (of
# backbone.layer3.0.conv2.weight, for three of them), against 0.12% at
# step 3.
LOOSE_PER_STEP = (5e-4, 5e-3, 5e-4)


def test_three_f32_steps_track_jax(three_steps):
    """Three f32 AdamW steps through `make_train_step`.

    Each step started from JAX's state before it (weights, BatchNorm
    statistics, `pe`, Adam's moments and count) against JAX's step: every
    element within 2 lr, the BatchNorm statistics at rtol 1e-5, the rows of
    `pe` drawn so far and `init_betas` at rtol 1e-4, and the elements
    beyond rtol 1e-4 counted: at most `LOOSE_PER_STEP` of the model, 1e-3
    of each tensor outside the ResNet and 10% of each ResNet tensor (Adam
    turns the f32 noise of a gradient element near zero or near Adam's
    epsilon into up to 2 lr, as in the one-step test).

    The port's own three steps from the start: each loss at rtol 1e-3 and
    every element within 2 lr a step. Free runs part at f32 noise (JAX
    against itself from a start one ulp away: 0.6% and 11% of the elements
    beyond rtol 1e-4 after steps 2 and 3; the port 20% and 62%), so only
    the steps from JAX's state are counted elementwise."""
    tcfg, after, forced, jlosses, losses, before = three_steps
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    for k, (want, got) in after[2].items():
        if not k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, want, rtol=0, atol=2 * tcfg.lr * 3, err_msg=k)
    for i, pairs in enumerate(forced):
        loose, n = 0, 0
        for k, (want, got) in pairs.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                                           err_msg=f"step {i + 1} {k}")
                continue
            np.testing.assert_allclose(got, want, rtol=0, atol=2 * tcfg.lr,
                                       err_msg=f"step {i + 1} {k}")
            if k.endswith(ZERO_GRAD):
                continue
            bad = int((np.abs(got - want) > 1e-4 * np.abs(want) + 1e-8).sum())
            share = 0.1 if k.startswith("backbone.") else 1e-3
            assert bad <= share * want.size, (i + 1, k, bad, want.size)
            loose, n = loose + bad, n + want.size
        assert loose <= LOOSE_PER_STEP[i] * n, (i + 1, loose, n)
        pe_j, pe_t = pairs["embed_timestep.pe"]
        rows = np.abs(pe_j - before[i]["embed_timestep"]["pe"]).max(1) > tcfg.lr / 2
        assert 1 <= rows.sum() <= B * (i + 1)  # drawn so far: Adam's momentum moves them on
        np.testing.assert_allclose(pe_t[rows], pe_j[rows], rtol=1e-4, atol=1e-8)
        betas_j, betas_t = pairs["beta_layer.init_betas"]
        np.testing.assert_allclose(betas_t, betas_j, rtol=1e-4, atol=1e-8)


# ------------------------------------------------------------ bf16 mixed
@pytest.fixture(scope="module")
def mixed():
    """Both sides' f32 and bf16-mixed gradients on the same weights and
    draws, and the port's losses."""
    w = World(seed=2)
    key = jax.random.PRNGKey(13)
    draws = jax_draws(key, B, w.cfg.cond_mask_prob)
    jloss, jgrads = {}, {}
    for mp in (False, True):
        v, g = jax.jit(jax.value_and_grad(lambda p: w.jax_loss(
            p, key, use_collision=False, mixed_precision=mp)[0]))(to_jax(w.params))
        g = jax.tree_util.tree_map(np.asarray, g)
        jloss[mp] = float(v)
        jgrads[mp] = {**export_arrays(g), "embed_timestep.pe": g["embed_timestep"]["pe"]}
    grads, losses = {}, {}
    trained = trainable_tensors(w.model)
    for mp in (False, True):
        saved = {k: v.clone() for k, v in w.model.state_dict().items()}
        for t in trained.values():
            t.grad = None
        loss, _ = w.port_loss(w.model, draws, use_collision=False, mixed_precision=mp)
        loss.backward()
        grads[mp] = {k: t.grad.clone() for k, t in trained.items()}
        losses[mp] = float(loss.detach())
        w.model.load_state_dict(saved)
    return jloss, losses, jgrads, grads


def _cosine(a: dict, b: dict, keys) -> float:
    x = np.concatenate([np.asarray(a[k], np.float64).reshape(-1) for k in keys])
    y = np.concatenate([np.asarray(b[k], np.float64).reshape(-1) for k in keys])
    return float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))


def test_mixed_loss_matches_jax_mixed(mixed):
    jloss, losses, _, _ = mixed
    assert abs(losses[True] - jloss[True]) <= 2e-2 * abs(jloss[True]), (losses, jloss)


def test_mixed_gradients_are_f32_and_as_close_to_f32_as_jax(mixed):
    """Every gradient lands f32 on the f32 masters. The flattened mixed
    gradient's cosine against the f32 one on the same draws is at least the
    JAX package's own on the same weights and draws, less 0.01, over the
    whole model and outside the ResNet. JAX's bar of 0.99 (its stub
    backbone) is not met by either package with a train-mode ResNet: bf16
    noise in the backbone's large gradient brings JAX to about 0.88 here,
    and to 0.074 at full width (`tests/grad_cosine_full_width.py`, where
    the port reads 0.082); outside the ResNet both stay near 0.98."""
    _, _, jgrads, grads = mixed
    for k, g in grads[True].items():
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), k
    port = {mp: {k: to_np(v) for k, v in grads[mp].items()} for mp in grads}
    everything = sorted(port[True])
    head = [k for k in everything if not k.startswith("backbone.")]
    for keys in (everything, head):
        cos, jcos = _cosine(port[False], port[True], keys), _cosine(jgrads[False], jgrads[True], keys)
        assert cos >= jcos - 0.01, (len(keys), cos, jcos)
    assert _cosine(port[False], port[True], head) > 0.98


@pytest.mark.parametrize("mixed_precision", [False, True], ids=["f32", "bf16-mixed"])
def test_stage2_loss_with_given_draws_equals_jax(mixed_precision):
    """`grad_cosine_full_width.jax_stage2_loss`, JAX's `stage2_loss` with t,
    the noise and the drop mask handed in, equals JAX's own on the draws
    that its key gives: loss and terms at rtol 1e-6, with a drop mask that
    drops."""
    import jax.numpy as jnp

    from .grad_cosine_full_width import jax_stage2_loss

    w = World(seed=6)
    key = jax.random.PRNGKey(17)
    draws = jax_draws(key, B, w.cfg.cond_mask_prob)
    assert draws["drop"].any()
    want, (wterms, _) = w.jax_loss(to_jax(w.params), key, use_collision=False,
                                   mixed_precision=mixed_precision)
    got, terms = jax_stage2_loss(to_jax(w.params), w.jcfg, JWeights(), w.jschedule, w.jstats,
                                 *w.jsmpl, to_jax(w.batch),
                                 *(jnp.asarray(draws[k].numpy()) for k in ("t", "noise", "drop")),
                                 use_collision=False, mixed_precision=mixed_precision)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for k, v in wterms.items():
        np.testing.assert_allclose(float(terms[k]), float(v), rtol=1e-6, err_msg=k)


def test_mixed_steps_keep_all_state_f32():
    """Two mixed steps: every parameter, buffer and AdamW state tensor stays
    f32, the BatchNorm variances positive, the losses finite."""
    w = World(seed=3)
    tcfg = TrainConfig()
    assert tcfg.mixed_precision
    opt = make_optimizer(w.model, tcfg)
    step = make_train_step(w.cfg, tcfg, LossWeights(), w.schedule, w.stats, *w.smpl, opt)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        terms = step(w.model, to_torch(w.batch, "cpu"), gen)
        assert all(torch.isfinite(v) for v in terms.values())
    for k, v in w.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert v.dtype == torch.float32, k
        if k.endswith("running_var"):
            assert (v > 0).all(), k
    assert w.model.embed_timestep.pe.dtype == torch.float32
    n = 0
    for state in opt.state.values():
        for k, v in state.items():
            if torch.is_tensor(v) and v.numel() > 1:
                assert v.dtype == torch.float32, k
                n += 1
    assert n == 2 * len(trainable_tensors(w.model))


def test_training_overfits_fixed_batch():
    """Repeated bf16-mixed steps at lr 1e-3 on one fixed batch drive the
    loss below 0.8 of its start (the JAX package's bar and step count)."""
    w = World(seed=4, cond_mask_prob=0.01)
    w.batch = synthetic_batch(B, num_scene_points=P, img_size=32, seed=7)
    tcfg = TrainConfig(lr=1e-3)
    opt = make_optimizer(w.model, tcfg)
    step = make_train_step(w.cfg, tcfg, LossWeights(), w.schedule, w.stats, *w.smpl, opt)
    batch = to_torch(w.batch, "cpu")
    gen = torch.Generator().manual_seed(42)
    losses = [float(step(w.model, batch, gen)["loss"]) for _ in range(120)]
    early, late = np.mean(losses[:5]), np.mean(losses[-5:])
    assert np.isfinite(late) and late < 0.8 * early, (early, late)


def test_optimizer_covers_what_optax_updates():
    """AdamW's tensors are every parameter plus `pe`, no BatchNorm running
    statistic; the state_dict keys are those of the reference layout."""
    w = World(seed=5)
    opt = make_optimizer(w.model, TrainConfig())
    ids = {id(p) for g in opt.param_groups for p in g["params"]}
    named = dict(w.model.named_parameters())
    assert ids == {id(p) for p in named.values()} | {id(w.model.embed_timestep.pe)}
    for k, b in w.model.named_buffers():
        if k != "embed_timestep.pe":
            assert id(b) not in ids, k
    assert "embed_timestep.pe" not in w.model.state_dict()
