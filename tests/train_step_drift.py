"""How far three f32 training steps part, on the CPU at the tiny config of
`tests/test_torch_train_step.py` (World(seed=1), keys 20, 21, 22, lr 1e-4).

For each step, the share of trained elements (the biases of `ZERO_GRAD`
aside) beyond rtol 1e-4 of JAX's, for: the port's own run from the start;
the port's step started from JAX's state before it; and JAX again, from a
start one ulp away (every weight times 1 +- 2^-24). Also JAX's own
gradient's sensitivity at each step's weights: for four one-ulp
perturbations drawn in turn, the largest change, over tensors, of the
gradient, as a share of the tensor's largest element. Prints one JSON
object.

    JAX_PLATFORMS=cpu python -m tests.train_step_drift
"""
import json

import jax
import numpy as np

from egohmr_tpu.models import LossWeights as JWeights
from egohmr_tpu.train import loop as jloop
from egohmr_tpu_torch.data import to_torch
from egohmr_tpu_torch.interop import export_arrays
from egohmr_tpu_torch.models import LossWeights
from egohmr_tpu_torch.train import TrainConfig, make_optimizer, make_train_step

from .test_torch_train import B, ZERO_GRAD, World, jax_draws
from .test_torch_train_step import _flat, _load_jax_state
from .torch_parity import to_jax


def one_ulp(params, rng: np.random.RandomState):
    """Every trained f32 leaf times 1 +- 2^-24; BatchNorm statistics kept."""

    def f(path, a):
        a = np.asarray(a)
        if getattr(path[-1], "key", None) in ("mean", "var") or a.dtype != np.float32:
            return a
        return (a * (1 + rng.choice([-1, 1], a.shape) * 2.0 ** -24)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, jax.tree_util.tree_map(np.asarray, params))


def loose_share(pairs, other=None) -> float:
    """Share of trained elements beyond rtol 1e-4 (+1e-8) of JAX's."""
    bad = n = 0
    for k, (want, got) in pairs.items():
        if k.endswith(("running_mean", "running_var")) or k.endswith(ZERO_GRAD):
            continue
        got = got if other is None else other[k][0]
        bad += int((np.abs(got - want) > 1e-4 * np.abs(want) + 1e-8).sum())
        n += want.size
    return bad / n


def main() -> None:
    w, forced, w2 = World(seed=1), World(seed=1), World(seed=1)
    tcfg = TrainConfig(lr=1e-4, mixed_precision=False)
    jopt = jloop.make_optimizer(tcfg)
    jstep = jloop.make_train_step(w.jcfg, jloop.TrainConfig(**vars(tcfg)), JWeights(),
                                  w.jschedule, w.jstats, *w.jsmpl, jopt)
    grad = jax.jit(jax.grad(lambda p, key: w.jax_loss(p, key, use_collision=False)[0]))
    rng = np.random.RandomState(0)
    params, pparams = to_jax(w.params), to_jax(one_ulp(w.params, rng))
    state, pstate = jopt.init(params), jopt.init(pparams)
    opt = make_optimizer(w.model, tcfg)
    step = make_train_step(w.cfg, tcfg, LossWeights(), w.schedule, w.stats, *w.smpl, opt)
    fopt = make_optimizer(forced.model, tcfg)
    fstep = make_train_step(w.cfg, tcfg, LossWeights(), w.schedule, w.stats, *w.smpl, fopt)
    out = {k: [] for k in ("port_free", "port_from_jax_state", "jax_one_ulp_start",
                           "jax_grad_one_ulp_change")}
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        ga = export_arrays(jax.tree_util.tree_map(np.asarray, grad(params, key)))
        changes = []
        for _ in range(4):
            gb = export_arrays(jax.tree_util.tree_map(
                np.asarray, grad(to_jax(one_ulp(params, rng)), key)))
            changes.append(max(
                (float(np.abs(ga[k] - gb[k]).max() / np.abs(ga[k]).max()), k) for k in ga
                if not k.endswith(("running_mean", "running_var", "num_batches_tracked")
                                  + ZERO_GRAD) and np.abs(ga[k]).max() > 0))
        out["jax_grad_one_ulp_change"].append(changes)
        _load_jax_state(forced.model, fopt, params, state)
        params, state, _ = jstep(params, state, to_jax(w.batch), key)
        pparams, pstate, _ = jstep(pparams, pstate, to_jax(w.batch), key)
        draws = jax_draws(key, B, w.cfg.cond_mask_prob)
        step(w.model, to_torch(w.batch, "cpu"), **draws)
        fstep(forced.model, to_torch(w.batch, "cpu"), **draws)
        now = jax.tree_util.tree_map(np.asarray, params)
        out["port_free"].append(loose_share(_flat(now, w.model)))
        out["port_from_jax_state"].append(loose_share(_flat(now, forced.model)))
        out["jax_one_ulp_start"].append(loose_share(
            _flat(now, w2.model), _flat(jax.tree_util.tree_map(np.asarray, pparams), w2.model)))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
