"""Stage 1's first training steps after the ActNorm init, JAX package and
port, on the same weights, batches and draws, as both training CLIs take
them.

`initialize` sets the flow's ActNorms from one batch's GT poses and the
eval-mode context (BatchNorm on its running statistics), and training takes
the NLL of the next batch's noised GT poses under the train-mode context
(BatchNorm on the batch's statistics). Then each G+D step takes the next
synthetic batch, a mocap batch from `np.random.RandomState(0)` (pose x 0.3,
betas x 0.5) and AdamW at lr 1e-4, weight decay 1e-4, from
`init_prohmr(PRNGKey(0))` and `init_discriminator(PRNGKey(10))`, with the
draws of `PRNGKey(1)` split once a step: the CLIs' stream at seed 0. The
tests hold the port to JAX at a tiny config. Run as a script, it reads both
at full width (`ProHMRConfig()`) on the CPU and prints one JSON object:
each side's metrics per step and the smallest standard deviation each
ActNorm was set from:

    JAX_PLATFORMS=cpu python -m tests.test_torch_stage1_nll [--batch 4] [--points 2000] [--steps 4]

A few minutes on 8 CPU cores at the defaults (the JAX side compiles
ResNet-50's training step).
"""
from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from egohmr_tpu.models import discriminator as jdisc
from egohmr_tpu.models import prohmr as jprohmr
from egohmr_tpu.smpl import make_synthetic_model as j_make_smpl
from egohmr_tpu.train import prohmr_loop as jloop
from egohmr_tpu_torch.data import synthetic_batch, to_torch
from egohmr_tpu_torch.interop import (
    discriminator_state_dict_from_jax,
    prohmr_state_dict_from_jax,
)
from egohmr_tpu_torch.models import Discriminator, prohmr
from egohmr_tpu_torch.smpl import make_synthetic_model
from egohmr_tpu_torch.train import prohmr_loop

from .torch_parity import jax_stage1_draws

LR = WD = 1e-4
TINY = dict(resnet_layers=18, img_feat_dim=512, scene_feat_dim=32, pointnet_hidden_dim=32,
            flow_hidden=32, flow_layers=2, flow_depth=1, fc_head_hidden=32)


def steps_after_init(batch: int, points: int, steps: int, img_size: int = 224,
                     vertices: int = 6890, **cfg) -> dict:
    """Both sides' metrics for `steps` G+D steps on `synthetic_batch(seed=i
    + 1)`, after the ActNorm init on `seed=0`, at `ProHMRConfig(**cfg)`."""
    B = batch
    jcfg, tcfg = jprohmr.ProHMRConfig(**cfg), prohmr.ProHMRConfig(**cfg)
    params = jprohmr.init_prohmr(jax.random.PRNGKey(0), jcfg)
    dparams = jdisc.init_discriminator(jax.random.PRNGKey(10))
    batches = [synthetic_batch(B, num_scene_points=points, img_size=img_size, seed=s)
               for s in range(steps + 1)]
    rng = np.random.RandomState(0)
    mocap = [{"body_pose": rng.randn(B, 69).astype(np.float32) * 0.3,
              "betas": rng.randn(B, 10).astype(np.float32) * 0.5} for _ in range(steps)]
    key, subs = jax.random.PRNGKey(1), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        subs.append(sub)

    def jtree(t):
        return jax.tree_util.tree_map(jnp.asarray, t)

    model = prohmr.ProHMR(tcfg)
    model.load_state_dict(prohmr_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                          strict=True)
    disc = Discriminator()
    disc.load_state_dict(discriminator_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, dparams)), strict=True)

    jsmpl = j_make_smpl(num_vertices=vertices)
    opt, dopt = optax.adamw(LR, weight_decay=WD), optax.adamw(LR, weight_decay=WD)
    jstep = jloop.make_prohmr_train_step(jcfg, jprohmr.ProHMRLossWeights(), jsmpl, jsmpl, jsmpl,
                                         opt, dopt)
    params = jprohmr.initialize(params, jcfg, jtree(batches[0]))
    state = (params, dparams, opt.init(params), dopt.init(dparams))
    want = []
    for i in range(steps):
        *state, m = jstep(*state, jtree(batches[i + 1]), jtree(mocap[i]), subs[i])
        want.append({k: float(v) for k, v in m.items()})

    smpl = make_synthetic_model(num_vertices=vertices)
    prohmr.initialize(model, tcfg, to_torch(batches[0], "cpu"))
    stds = [float(torch.exp(-an.log_scale.detach()).min())
            for an, _, _ in model.flow.flow.steps()]
    g_opt, d_opt = prohmr_loop.make_optimizers(model, disc, LR, WD)
    tstep = prohmr_loop.make_prohmr_train_step(tcfg, prohmr.ProHMRLossWeights(), smpl, smpl,
                                               smpl, g_opt, d_opt)
    got = []
    for i in range(steps):
        m = tstep(model, disc, to_torch(batches[i + 1], "cpu"), to_torch(mocap[i], "cpu"),
                  **jax_stage1_draws(subs[i], tcfg, B))
        got.append({k: float(v) for k, v in m.items()})
    return {"jax": want, "port": got, "actnorm_min_std": stds}


@pytest.fixture(scope="module")
def tiny_steps():
    return steps_after_init(4, 200, 4, img_size=64, vertices=300, **TINY)


def test_nll_after_the_actnorm_init_matches_jax(tiny_steps):
    """At a tiny config (ResNet-18, a 2-step Glow at hidden 32, batch 4):
    the loss and the NLL on the batch after the init at rtol 1e-4."""
    want, got = tiny_steps["jax"][0], tiny_steps["port"][0]
    for k in ("loss", "loss_nll"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_cli_steps_after_the_init_match_jax(tiny_steps):
    """The next three G+D steps of the CLIs' stream: every metric at rtol
    1e-3, the bar of the stage-2 free run (Adam turns f32 noise in the
    gradients into steps of up to 2 lr, so the runs part slowly)."""
    assert len(tiny_steps["port"]) == len(tiny_steps["jax"]) == 4
    for i, (want, got) in enumerate(zip(tiny_steps["jax"], tiny_steps["port"])):
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-3, err_msg=f"step {i} {k}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--points", type=int, default=2000)
    p.add_argument("--steps", type=int, default=4)
    args = p.parse_args()
    print(json.dumps(steps_after_init(args.batch, args.points, args.steps)))
