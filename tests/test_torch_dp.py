"""Data parallelism in the PyTorch port, part 2: the stage-2 step at world
2 against the JAX package's `make_train_step(mesh=make_mesh(2))`, the
stage-2 and stage-1 steps at world 2 against the port's world 1, and the
three CLIs (`train_egohmr` and `train_prohmr` 2 steps resumed to 4,
`test_egohmr` unguided and guided) at world 2 against world 1. Ranks are
processes on a gloo group (`torch_dp_worker.spawn`), at the tiny widths
of the other port tests; the helpers, sync BatchNorm, the point-sharded
encoder and the `Predictor` are `test_torch_parallel.py`'s."""
import dataclasses
import glob
import json
import os
import pickle
import shutil

import jax
import numpy as np
import optax
import pytest
import torch

from egohmr_tpu.models import LossWeights as JWeights
from egohmr_tpu.parallel import make_mesh
from egohmr_tpu.train import loop as jloop
from egohmr_tpu_torch.data import synthetic_batch
from egohmr_tpu_torch.interop import export_arrays
from egohmr_tpu_torch.models import Discriminator, init_discriminator_
from egohmr_tpu_torch.parallel import DataParallel
from egohmr_tpu_torch.utils.checkpoint import restore_checkpoint

from . import torch_dp_worker as worker
from .test_torch_train import B, P, T, V, ZERO_GRAD, World, jax_draws
from .torch_parity import tiny_prohmr_pair, to_jax

LR = 1e-4
WORLD = 2


# ------------------------------------------------------------ the steps
def _jax_dp_step(w, key, mixed_precision):
    """JAX's DP step over make_mesh(2): (loss, the gradients before AdamW
    read back from Adam's first moment, the BatchNorm statistics)."""
    tcfg = jloop.TrainConfig(lr=LR, mixed_precision=mixed_precision)
    jopt = jloop.make_optimizer(tcfg)
    params = to_jax(w.params)
    step = jloop.make_train_step(w.jcfg, tcfg, JWeights(), w.jschedule, w.jstats, *w.jsmpl,
                                 jopt, mesh=make_mesh(WORLD))
    new, state, metrics = step(params, jopt.init(params), to_jax(w.batch), key)
    adam = next(x for x in jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState))
    masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    mu = jax.tree_util.tree_map(lambda m, p: np.zeros(np.shape(p), np.float32) if masked(m)
                                else np.asarray(m) / 0.1, adam.mu, params, is_leaf=masked)
    grads = {**export_arrays(mu), "embed_timestep.pe": mu["embed_timestep"]["pe"]}
    grads = {k: v for k, v in grads.items()
             if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    bn = {k: v for k, v in export_arrays(jax.tree_util.tree_map(np.asarray, new)).items()
          if k.endswith(("running_mean", "running_var"))}
    return float(metrics["loss"]), grads, bn


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """`step_cases` at world 2 and at world 1, and JAX's DP step over 2
    devices, f32 and bf16-mixed, on the same weights, batch and draws."""
    root = str(tmp_path_factory.mktemp("dp_steps"))
    w = World(seed=1)
    key = jax.random.PRNGKey(21)
    jcfg1, cfg1, _, model1 = tiny_prohmr_pair(seed=2)
    disc = init_discriminator_(Discriminator(), seed=9)
    mrng = np.random.RandomState(4)
    inp = {"cfg": dataclasses.asdict(w.cfg), "state": w.model.state_dict(), "V": V, "T": T,
           "batch": w.batch, "draws": jax_draws(key, B, w.cfg.cond_mask_prob), "lr": LR,
           "s1_cfg": dataclasses.asdict(cfg1), "s1_state": model1.state_dict(),
           "s1_disc": disc.state_dict(),
           "s1_batch": synthetic_batch(B, num_scene_points=P, img_size=64, seed=4),
           "s1_mocap": {"body_pose": (0.3 * mrng.randn(B, 69)).astype(np.float32),
                        "betas": (0.5 * mrng.randn(B, 10)).astype(np.float32)}}
    torch.save(inp, os.path.join(root, "inputs.pt"))
    ctx = worker.spawn(worker.step_cases, WORLD, root, join=False)
    jax_out = {name: _jax_dp_step(w, key, mp) for name, mp in (("f32", False), ("bf16", True))}
    one = {f"jax_draws_{name}": worker.stage2_step(inp, None, mixed_precision=mp,
                                                   draws=inp["draws"])
           for name, mp in (("f32", False), ("bf16", True))}
    one["generator"] = worker.stage2_step(inp, None, mixed_precision=False, steps=2, seed=5)
    one["collision"] = worker.stage2_step(inp, None, mixed_precision=False, seed=6,
                                          use_collision=True)
    one["stage1"] = worker.stage1_step(inp, None)
    while not ctx.join():
        pass
    yield jax_out, one, worker.load(root, "steps", WORLD)
    shutil.rmtree(root, ignore_errors=True)


def _grads_close(got, want, rtol, scale=1e-3):
    """Each gradient at `rtol`, atol `scale` x the leaf's largest magnitude;
    the biases of `ZERO_GRAD`, whose gradient is zero up to rounding, at 1e-5
    x the model's largest gradient."""
    top = max(np.abs(np.asarray(v)).max() for v in want.values())
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        atol = 1e-5 * top if k.endswith(ZERO_GRAD) else scale * np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=k)


def _cosine(a, b, keys):
    x = np.concatenate([np.asarray(a[k]).reshape(-1) for k in keys]).astype(np.float64)
    y = np.concatenate([np.asarray(b[k]).reshape(-1) for k in keys]).astype(np.float64)
    return x @ y / (np.linalg.norm(x) * np.linalg.norm(y))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_stage2_dp_step_matches_jax_mesh_step(steps, precision):
    """The port's step at world 2 against JAX's `make_train_step` over
    `make_mesh(2)` on JAX's draws (keyed by the global sample index, so each
    rank takes its rows). f32: the loss at rtol 1e-4, every gradient before
    AdamW at rtol 1e-3 (the 1-way bars of `test_torch_train.py`), the
    BatchNorm statistics, synchronised over both ranks, at rtol 1e-5 with
    atol 1e-5 x the leaf's largest magnitude. bf16-mixed: the loss at rtol
    2e-3, and the gradient by its cosine to JAX's: bf16 rounding in the
    train-mode ResNet parts the two packages' gradients elementwise already
    at world 1 (`test_torch_train_step.py` compares them by cosine too).
    The port's world-1 gradient reads 0.910 against JAX's DP one over the
    whole model and 0.975 outside the ResNet; the bars are 0.85 and 0.95."""
    jax_out, _, out = steps
    jloss, jgrads, jbn = jax_out[precision]
    for o in out:
        terms, grads, state = o[f"jax_draws_{precision}"]
        grads = {k: v.numpy() for k, v in grads.items()}
        if precision == "f32":
            np.testing.assert_allclose(terms[0]["loss"], jloss, rtol=1e-4)
            _grads_close(grads, jgrads, rtol=1e-3)
            for k, v in jbn.items():
                np.testing.assert_allclose(state[k].numpy(), v, rtol=1e-5,
                                           atol=1e-5 * np.abs(v).max(), err_msg=k)
        else:
            np.testing.assert_allclose(terms[0]["loss"], jloss, rtol=2e-3)
            assert _cosine(grads, jgrads, list(jgrads)) > 0.85
            assert _cosine(grads, jgrads, [k for k in jgrads if not k.startswith("backbone.")]) > 0.95
            assert all(g.dtype == np.float32 for g in grads.values())


@pytest.mark.parametrize("case", ["jax_draws_f32", "jax_draws_bf16", "collision"])
def test_stage2_dp_step_equals_world1(steps, case):
    """World 2 against the port's world 1 on the same draws: the loss
    (rtol 1e-4 f32, 2e-3 bf16-mixed), the gradients and the BatchNorm
    statistics (rtol 1e-5, atol 1e-5 x the leaf's largest). f32: every
    gradient at rtol 1e-4, atol 1e-4 x the leaf's largest (the largest gap
    reads 3.4e-5 of it, in the train-mode ResNet), the biases of
    `ZERO_GRAD`, zero up to rounding, at 1e-5 x the model's largest
    gradient. bf16-mixed: bf16 rounding, which the two runs' summation
    orders place differently, parts single elements by up to 1% of a
    leaf's largest, so each module's gradient is held by its cosine to
    world 1's, above 0.999 (read: 0.9999 and above). The collision case
    scores the bodies against the scene in the loss (the generator's
    draws)."""
    _, one, out = steps
    wterms, wgrads, wstate = one[case]
    bf16 = case.endswith("bf16")
    want = {k: v.numpy() for k, v in wgrads.items()}
    for o in out:
        terms, grads, state = o[case]
        np.testing.assert_allclose(terms[0]["loss"], wterms[0]["loss"],
                                   rtol=2e-3 if bf16 else 1e-4)
        if case == "collision":
            assert terms[0]["loss_coap_penetration"] > 0
            np.testing.assert_allclose(terms[0]["loss_coap_penetration"],
                                       wterms[0]["loss_coap_penetration"], rtol=1e-4)
        got = {k: v.numpy() for k, v in grads.items()}
        if not bf16:
            _grads_close(got, want, rtol=1e-4, scale=1e-4)
            continue
        for module in {k.split(".")[0] for k in want}:
            keys = [k for k in want if k.startswith(module + ".")]
            assert _cosine(got, want, keys) > 0.999, module
        for k, v in wstate.items():
            if k.endswith(("running_mean", "running_var")):
                torch.testing.assert_close(state[k], v, rtol=1e-5,
                                           atol=1e-5 * float(v.abs().max()), msg=k)


def test_generator_draws_are_shard_invariant(steps):
    """Two f32 steps with the generator's own draws (t, noise, the drop
    mask, each made for the whole batch on every rank): both ranks' terms
    equal world 1's at rtol 1e-4, and both replicas are equal bit for bit
    and within 2 lr a step of world 1's weights (Adam moves an element by
    about lr x sign(g), and where f32 rounding decides the sign of a
    gradient near zero the two may part by 2 lr)."""
    _, one, out = steps
    wterms, _, wstate = one["generator"]
    for o in out:
        terms, _, state = o["generator"]
        for a, b in zip(terms, wterms):
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-7, err_msg=k)
        for k, v in wstate.items():
            torch.testing.assert_close(state[k], out[0]["generator"][2][k], rtol=0, atol=0)
            if v.is_floating_point():
                torch.testing.assert_close(state[k], v, rtol=1e-4, atol=2 * LR * 2, msg=k)


def test_stage1_dp_step_equals_world1(steps):
    """Two stage-1 G+D steps at world 2 (z and nll_noise drawn for the whole
    batch on every rank, the backbone's BatchNorms synchronised, both
    models' gradients averaged): each term at rtol 1e-4 of world 1's, the
    two ranks' generator and discriminator equal bit for bit, and within 2
    lr a step of world 1's."""
    _, one, out = steps
    wterms, wmodel, wdisc = one["stage1"]
    for o in out:
        terms, model, disc = o["stage1"]
        for a, b in zip(terms, wterms):
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-7, err_msg=k)
        for mine, theirs, rank0 in ((model, wmodel, out[0]["stage1"][1]),
                                    (disc, wdisc, out[0]["stage1"][2])):
            for k, v in theirs.items():
                torch.testing.assert_close(mine[k], rank0[k], rtol=0, atol=0)
                if v.is_floating_point():
                    torch.testing.assert_close(mine[k], v, rtol=1e-4, atol=2 * LR * 2, msg=k)


# ----------------------------------------------------------------- the CLIs
@pytest.fixture(scope="module")
def clis(tmp_path_factory):
    """The CLIs of `torch_dp_worker.run_clis` at world 2 (spawned) and at
    world 1 (here), under one root; and an unguided DDPM evaluation at
    world 1, which the guided one is held apart from."""
    from egohmr_tpu_torch.eval import test_egohmr

    root = str(tmp_path_factory.mktemp("dp_clis"))
    ctx = worker.spawn(worker.cli_cases, WORLD, root, join=False)
    with pytest.MonkeyPatch.context() as mp:
        one = worker.run_clis(root, "world1", mp.setattr)
        unguided = test_egohmr.main(worker.EVAL_ARGS + [
            "--timestep_respacing_eval", "ddpm", "--with_coap_grad", "false",
            "--save_root", os.path.join(root, "world1_eval_ddpm")])
    while not ctx.join():
        pass
    yield root, one, unguided, worker.load(root, "clis", WORLD)
    shutil.rmtree(root, ignore_errors=True)


def _metrics(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("stage", ["s2", "s1"])
def test_training_clis_world2_equal_world1(clis, stage):
    """`train_egohmr` (s2, f32, the collision loss from step 1, validation
    every step) and `train_prohmr` (s1), 2 steps resumed to 4 at world 2
    (batch 4, 2 a rank) and at world 1: every tensor of the last
    checkpoints within 2 lr a step, Adam's bound (Adam moves an element by
    about lr x sign(g), and the f32 rounding that parts the two runs'
    gradients by 3e-5 of a leaf's largest element decides that sign where g
    is near zero; a running mean follows its BatchNorm's input bias there),
    the logged losses at rtol 1e-4 at step 0 and 1e-3 after it, and only
    rank 0 wrote: one line per step in `metrics.jsonl` and one log file
    per run."""
    root = clis[0]
    d2, d1 = (os.path.join(root, f"{t}_{stage}") for t in ("world2", "world1"))
    a = restore_checkpoint(os.path.join(d2, "checkpoints", "step_3.pt"))
    b = restore_checkpoint(os.path.join(d1, "checkpoints", "step_3.pt"))
    assert a["step"] == b["step"] == 3
    for k, v in b["model"].items():
        if v.is_floating_point():
            torch.testing.assert_close(a["model"][k], v, rtol=1e-4, atol=2 * LR * 4, msg=k)
        else:
            torch.testing.assert_close(a["model"][k], v, rtol=0, atol=0)
    m2, m1 = _metrics(d2), _metrics(d1)
    losses = [r for r in m2 if "loss" in r]
    assert [r["step"] for r in losses] == [0, 1, 2, 3]
    for x, y in zip(losses, [r for r in m1 if "loss" in r]):
        # from the same weights at step 0; after it, weights 2 lr a step apart
        np.testing.assert_allclose(x["loss"], y["loss"], rtol=1e-4 if x["step"] == 0 else 1e-3)
    assert len(glob.glob(os.path.join(d2, "*.log"))) <= 2
    if stage == "s2":  # validation ran on rank 0 at steps 1 and 3
        assert [r["step"] for r in m2 if "val_keypoints_3d_vis" in r] == [1, 3]


@pytest.mark.parametrize("run", list(worker.EVAL_RUNS))
def test_eval_cli_world2_equals_world1(clis, run):
    """`test_egohmr` at world 2, each rank sampling and scoring half of
    every batch and the per-image results gathered in rank order, against
    world 1: every summary key at rtol 1e-5, and `results.pkl`, image by
    image in the same order, at rtol 1e-5. In the guided DDPM run the
    guidance moves the samples by more than ten times that bar from the
    unguided DDPM run of the same seed, so a rank that averaged the
    guidance over its own half of the batch would fail."""
    root, one, unguided, out = clis
    for summary in [o[run] for o in out]:
        assert set(summary) == set(one[run])
        for k, v in one[run].items():
            np.testing.assert_allclose(summary[k], v, rtol=1e-5, atol=1e-7, err_msg=k)

    def pkl(tag):
        path = glob.glob(os.path.join(root, tag, "*", "results_seed_*.pkl"))
        assert len(path) == 1, path
        with open(path[0], "rb") as f:
            return pickle.load(f)

    got, want = pkl(f"world2_eval_{run}"), pkl(f"world1_eval_{run}")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    if run == "guided_ddpm":
        moved = np.abs(want["pred_pose_6d"] - pkl("world1_eval_ddpm")["pred_pose_6d"])
        assert moved.max() > 10 * 1e-5 * np.abs(want["pred_pose_6d"]).max(), moved.max()
        assert unguided.keys() == one[run].keys()


def test_clis_refuse_a_batch_the_world_does_not_divide(monkeypatch, tmp_path):
    """At a world of 2, a `--batch_size` of 3 raises in each CLI before any
    work: nothing runs 1-way in its place."""
    from egohmr_tpu_torch.eval import test_egohmr
    from egohmr_tpu_torch.train import train_egohmr, train_prohmr

    dp = DataParallel(rank=0, size=2, group=None, device=torch.device("cpu"))
    for cli in (train_egohmr, train_prohmr, test_egohmr):
        monkeypatch.setattr(cli, "resolve_data_parallel", lambda *a: (dp.device, dp))
        with pytest.raises(ValueError, match="does not divide"):
            cli.main(["--device", "cpu", "--synthetic", "--batch_size", "3",
                      "--save_dir", str(tmp_path)] if cli is not test_egohmr else
                     ["--device", "cpu", "--synthetic", "--batch_size", "3"])
