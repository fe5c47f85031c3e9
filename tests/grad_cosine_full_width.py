"""The bf16-mixed gradient's cosine to the f32 one, JAX package and port, on
the CPU at full width.

Both packages take the weights, batch and draws that `chip_smoke.py`'s
`train` phase takes for its gradient check: `init_random_(EgoHMR(), seed=0,
training=True)`, `synthetic_batch(16, num_scene_points=20000, seed=30)`,
the synthetic SMPL at V = 6890, and `train_draws(16, 0.01)` for t, the
noise and the condition-drop mask. The JAX side runs
`jax.grad` of `jax_stage2_loss`, which is
`egohmr_tpu.train.loop.stage2_loss` with those draws handed in; the port
runs `egohmr_tpu_torch.train.stage2_loss`. Prints one JSON object: for
each side the cosine over the whole model, the ResNet, the rest and each
top-level module, with the f32 gradient's norm, and the weights'
fingerprint (`weights_fingerprint`) that `chip_smoke.py` checks before it
compares its own reading with JAX's.

    JAX_PLATFORMS=cpu python -m tests.grad_cosine_full_width [--batch 16]

Full width is ResNet-50 at 224 x 224 and a 20,000-point cloud: on 8 CPU
cores the run takes about a minute and its memory peaks near 17 GiB, in
the JAX side's compiled gradient (`--batch 2 --points 2000` for a quick
look). `tests/test_torch_train_step.py` holds `jax_stage2_loss` to the JAX
package's `stage2_loss` on the JAX draws.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

MODULES = ("backbone", "scene_enc", "transl_enc", "diffusion_model", "embed_timestep",
           "input_process", "beta_layer")


def train_draws(batch_size: int, cond_mask_prob: float, seed: int = 3):
    """(t, noise, drop) as NumPy arrays from `seed`, for a 50-step schedule;
    `chip_smoke.py` makes the same."""
    rng = np.random.RandomState(seed)
    t = rng.randint(0, 50, batch_size).astype(np.int64)
    noise = rng.randn(batch_size, 144).astype(np.float32)
    drop = rng.rand(batch_size) < cond_mask_prob
    return t, noise, drop


def weights_fingerprint(state_dict) -> float:
    """Sum of squares of every floating tensor, in float64: equal weights
    give equal fingerprints whatever the device."""
    return float(sum(float((v.double() ** 2).sum()) for v in state_dict.values()
                     if v.is_floating_point()))


def jax_stage2_loss(params, cfg, weights, schedule, stats, smpl_neutral, smpl_male,
                    smpl_female, batch, t, noise, drop, *, use_collision: bool,
                    mixed_precision: bool, max_collision_points=4096):
    """`egohmr_tpu.train.loop.stage2_loss` on one device with t [B], noise
    [B, 144] and the condition-drop mask [B] given instead of drawn from a
    key: the same calls in the same order. Returns (loss, terms)."""
    import jax.numpy as jnp

    from egohmr_tpu.diffusion import q_sample
    from egohmr_tpu.models import compute_condition, compute_loss, model_outputs
    from egohmr_tpu.models.egohmr import denoise_x0
    from egohmr_tpu.nn.core import cast_params_bf16
    from egohmr_tpu.train.loop import gt_pose_to_x_start

    x_start = gt_pose_to_x_start(batch, stats)
    x_t = q_sample(schedule, x_start, t, noise)
    fwd_params = params
    if mixed_precision:
        fwd_params = cast_params_bf16(params)
        batch = dict(batch, img=batch["img"].astype(jnp.bfloat16))
    # the drop is applied here, as compute_condition applies its own draw
    cond, _ = compute_condition(fwd_params, dataclasses.replace(cfg, cond_mask_prob=0.0),
                                batch, train=True)
    cond = cond._replace(cond=jnp.where(drop[:, None, None], cond.cond_uncond, cond.cond))
    x_t_in = x_t.astype(jnp.bfloat16) if mixed_precision else x_t
    x0_pred, _ = denoise_x0(fwd_params, cfg, cond, x_t_in, schedule.timestep_map[t],
                            fuse=False, train=True)
    if mixed_precision:
        x0_pred = x0_pred.astype(jnp.float32)
        cond = type(cond)(*(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x
                            for x in cond))
    outputs = model_outputs(cfg, smpl_neutral, cond, x0_pred, stats)
    return compute_loss(cfg, weights, smpl_neutral, smpl_male, smpl_female, batch, cond,
                        outputs, train=True, use_collision=use_collision,
                        max_collision_points=max_collision_points)


def cosines(f32: dict, mixed: dict) -> dict:
    """{part: (cosine, f32 norm)} over flattened gradients, in float64."""
    def cos(keys):
        a = np.concatenate([np.asarray(f32[k], np.float64).reshape(-1) for k in keys])
        b = np.concatenate([np.asarray(mixed[k], np.float64).reshape(-1) for k in keys])
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))), float(np.linalg.norm(a))

    keys = sorted(f32)
    parts = {"all": keys, "outside the ResNet": [k for k in keys if not k.startswith("backbone.")]}
    for m in MODULES:
        parts[m] = [k for k in keys if k.startswith(m + ".")]
    return {name: cos(ks) for name, ks in parts.items() if ks}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--points", type=int, default=20000)
    args = ap.parse_args(argv)

    import torch

    from egohmr_tpu_torch.data import synthetic_batch, to_torch
    from egohmr_tpu_torch.diffusion import make_schedule
    from egohmr_tpu_torch.models import BodyRepStats, EgoHMR, EgoHMRConfig, LossWeights, init_random_
    from egohmr_tpu_torch.smpl import make_synthetic_model
    from egohmr_tpu_torch.train import stage2_loss, trainable_tensors

    cfg = EgoHMRConfig()
    model = init_random_(EgoHMR(cfg), seed=0, training=True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    pe = model.embed_timestep.pe.detach().numpy().copy()
    batch = synthetic_batch(args.batch, num_scene_points=args.points, seed=30)
    t, noise, drop = train_draws(args.batch, cfg.cond_mask_prob)
    out = {"batch": args.batch, "points": args.points, "drops": int(drop.sum()),
           "weights_fingerprint": weights_fingerprint(init)}

    # ---- the port
    smpl = make_synthetic_model(num_vertices=6890)
    stats = BodyRepStats(torch.zeros(144), torch.ones(144))
    schedule = make_schedule(50, "cosine", "")
    tb = to_torch(batch, "cpu")
    trained = trainable_tensors(model)
    grads, secs = {}, {}
    for mp in (False, True):
        model.load_state_dict(init)
        for x in trained.values():
            x.grad = None
        t0 = time.perf_counter()
        loss, _ = stage2_loss(model, cfg, LossWeights(), schedule, stats, smpl, smpl, smpl, tb,
                              use_collision=False, mixed_precision=mp, t=torch.tensor(t),
                              noise=torch.tensor(noise), drop=torch.tensor(drop))
        loss.backward()
        secs[mp] = time.perf_counter() - t0
        grads[mp] = {k: x.grad.numpy().copy() for k, x in trained.items()}
    out["port"] = {"cosines": cosines(grads[False], grads[True]), "seconds": secs[False] + secs[True]}
    del model, trained, grads, tb

    # ---- the JAX package, on the same weights, batch and draws
    import jax
    import jax.numpy as jnp

    from egohmr_tpu.diffusion import make_schedule as j_make_schedule
    from egohmr_tpu.interop.torch_convert import convert_egohmr
    from egohmr_tpu.models import BodyRepStats as JStats
    from egohmr_tpu.models import EgoHMRConfig as JConfig
    from egohmr_tpu.models import LossWeights as JWeights
    from egohmr_tpu.smpl import make_synthetic_model as j_make_smpl

    from egohmr_tpu_torch.interop import export_arrays

    jcfg = JConfig()
    params = convert_egohmr({k: v.numpy().copy() for k, v in init.items()},
                            num_layers=jcfg.gcn_layers, resnet_layers=jcfg.resnet_layers)
    params["embed_timestep"]["pe"] = pe
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)), params)
    jsmpl = j_make_smpl(num_vertices=6890)
    jstats = JStats(jnp.zeros(144), jnp.ones(144))
    jsched = j_make_schedule(50, "cosine", "")
    jb = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)), batch)
    jgrads = {}
    for mp in (False, True):
        t0 = time.perf_counter()
        g = jax.jit(jax.grad(lambda p: jax_stage2_loss(
            p, jcfg, JWeights(), jsched, jstats, jsmpl, jsmpl, jsmpl, jb, jnp.asarray(t),
            jnp.asarray(noise), jnp.asarray(drop), use_collision=False,
            mixed_precision=mp)[0]))(params)
        g = jax.tree_util.tree_map(np.asarray, g)
        secs[mp] = time.perf_counter() - t0
        jgrads[mp] = {**export_arrays(g), "embed_timestep.pe": g["embed_timestep"]["pe"]}
    out["jax"] = {"cosines": cosines(jgrads[False], jgrads[True]),
                  "seconds": secs[False] + secs[True]}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
