"""Ranks of the data-parallel tests of the PyTorch port.

`spawn` starts `world` processes with `torch.multiprocessing`; each sets
torchrun's environment variables, joins a gloo process group on a `file://`
store under the test's directory (no TCP port: the suite runs several
workers at once), takes one CPU thread and calls one of the case functions
below, which read their inputs from `<root>/inputs.pt` and write what the
test compares to `<root>/<case>_rank<r>.pt`. This module imports no JAX:
the children import it.
"""
import functools
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# the tiny widths of `torch_parity.TINY` and `TINY_PROHMR`
TINY = dict(resnet_layers=18, img_feat_dim=512, scene_feat_dim=32,
            pointnet_hidden_dim=32, transl_embed_dim=16, timestep_embed_dim=32,
            input_process_dim=32, gcn_hid_dim=64, gcn_layers=2)
TINY_PROHMR = dict(resnet_layers=18, img_feat_dim=512, scene_feat_dim=32,
                   pointnet_hidden_dim=32, flow_hidden=32, flow_layers=2, flow_depth=1,
                   fc_head_hidden=32)
# the CLIs' synthetic batches at a small size
SMALL_BATCH = dict(img_size=64, num_scene_points=256)


def spawn(case, world: int, root: str, join: bool = True):
    """Run `case(dp, root)` on `world` ranks; with `join=False` return the
    context to `.join()` later."""
    init = "file://" + os.path.join(root, f"store_{case.__name__}_{world}")
    return mp.spawn(_entry, args=(world, init, case, root), nprocs=world, join=join)


def _entry(rank, world, init, case, root):
    from egohmr_tpu_torch.parallel import init_data_parallel

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        case(init_data_parallel("cpu"), root)
    finally:
        dist.destroy_process_group()


def _save(root, name, dp, obj):
    torch.save(obj, os.path.join(root, f"{name}_rank{dp.rank}.pt"))


def load(root, name, world):
    return [torch.load(os.path.join(root, f"{name}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ------------------------------------------------------------ the helpers
def helper_cases(dp, root):
    """gather_rows (f32 and int64), replicate, mean_grads over two dtypes,
    mean_metrics and all_reduce_sum's forward and backward."""
    from egohmr_tpu_torch.parallel import (all_reduce_sum, gather_rows, mean_grads,
                                           mean_metrics, replicate, rows)

    n = 3 * dp.size
    x = torch.arange(n * 2, dtype=torch.float32).reshape(n, 2)
    out = {"gather_f32": gather_rows(dp, x[rows(dp, n)]),
           "gather_i64": gather_rows(dp, torch.arange(n)[rows(dp, n)])}
    torch.manual_seed(dp.rank)
    lin = torch.nn.Linear(3, 2)
    lin.register_buffer("count", torch.tensor([dp.rank + 5]))
    out["replicated"] = {k: v.clone() for k, v in replicate(dp, lin).state_dict().items()}
    a = torch.zeros(4, requires_grad=True)
    b = torch.zeros(2, 3, dtype=torch.float64, requires_grad=True)
    a.grad = torch.full((4,), float(dp.rank + 1))
    b.grad = torch.full((2, 3), 10.0 * (dp.rank + 1), dtype=torch.float64)
    mean_grads(dp, [a, b])
    out["mean_grads"] = (a.grad.clone(), b.grad.clone())
    out["mean_metrics"] = mean_metrics(dp, {"loss": torch.tensor(float(dp.rank)),
                                            "other": torch.tensor(2.0 * dp.rank)})
    # d/dx_r of sum_r' c_r' . (sum_r x_r w): w * sum_r' c_r', on every rank
    xr = torch.full((3,), float(dp.rank + 1), requires_grad=True)
    w = torch.tensor([1.0, 2.0, 3.0])
    y = all_reduce_sum(dp, xr * w)
    (y * (dp.rank + 1)).sum().backward()
    out["all_reduce_sum"] = (y.detach(), xr.grad.clone())
    _save(root, "helpers", dp, out)


# ----------------------------------------- sync BatchNorm, sharded encoder
def bn_and_encoder_cases(dp, root):
    """Sync BatchNorm forward and backward on the rank's rows of two
    layouts, and the point-sharded encoder on the rank's points."""
    from egohmr_tpu_torch.nn import ResnetPointnet, batchnorm, pointnet_forward_point_sharded
    from egohmr_tpu_torch.parallel import mean_grads, rows

    inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    out = {}
    for layout, case in inp["bn"].items():
        bn = torch.nn.BatchNorm1d(case["c"])
        bn.load_state_dict(case["state"])
        mine = rows(dp, case["x"].shape[0])
        x = case["x"][mine].clone().requires_grad_(True)
        y = batchnorm(bn, x, case["channel_dim"], train=True, dp=dp)
        (y * case["cot"][mine]).sum().backward()
        mean_grads(dp, [bn.weight, bn.bias])
        out[layout] = {"y": y.detach(), "gx": x.grad, "gw": bn.weight.grad * dp.size,
                       "gb": bn.bias.grad * dp.size, "mean": bn.running_mean.clone(),
                       "var": bn.running_var.clone()}
    enc = ResnetPointnet(*inp["enc_dims"])
    enc.load_state_dict(inp["enc_state"])
    pts = inp["points"]
    out["encoder"] = pointnet_forward_point_sharded(
        enc, pts[:, rows(dp, pts.shape[1])].contiguous(), dp)
    _save(root, "bn_encoder", dp, out)


# -------------------------------------------------------- the train steps
def _stage2_world(inp, device="cpu"):
    from egohmr_tpu_torch.diffusion import make_schedule
    from egohmr_tpu_torch.models import BodyRepStats, EgoHMR, EgoHMRConfig
    from egohmr_tpu_torch.smpl import make_synthetic_model

    cfg = EgoHMRConfig(**inp["cfg"])
    smpl = [make_synthetic_model(seed=s, num_vertices=inp["V"]) for s in range(3)]
    stats = BodyRepStats(torch.zeros(144), torch.ones(144))
    return cfg, smpl, stats, make_schedule(inp["T"], "cosine", "")


def stage2_step(inp, dp, *, mixed_precision, steps=1, draws=None, seed=None, use_collision=False):
    """`steps` stage-2 steps at lr `inp["lr"]` from `inp["state"]` on the
    rank's rows of `inp["batch"]`: handed-in draws (the rank's rows of
    `draws`), or a generator seeded `seed`. Returns (terms of each step,
    the trained tensors' gradients of the last step, the state after)."""
    from egohmr_tpu_torch.data import to_torch
    from egohmr_tpu_torch.models import EgoHMR, LossWeights
    from egohmr_tpu_torch.parallel import rows, shard_batch
    from egohmr_tpu_torch.train import TrainConfig, make_optimizer, make_train_step
    from egohmr_tpu_torch.train import trainable_tensors

    cfg, smpl, stats, schedule = _stage2_world(inp)
    model = EgoHMR(cfg)
    model.load_state_dict(inp["state"])
    tcfg = TrainConfig(lr=inp["lr"], mixed_precision=mixed_precision,
                       use_collision_loss=use_collision, max_collision_points=32)
    opt = make_optimizer(model, tcfg)
    step = make_train_step(cfg, tcfg, LossWeights(), schedule, stats, *smpl, opt, dp=dp)
    batch = shard_batch(dp, to_torch(inp["batch"], "cpu"))
    gen = torch.Generator().manual_seed(seed) if seed is not None else None
    mine = rows(dp, inp["batch"]["img"].shape[0])
    terms = []
    for _ in range(steps):
        kw = {k: v[mine] for k, v in draws.items()} if draws is not None else {}
        terms.append({k: float(v) for k, v in step(model, batch, gen, **kw).items()})
    grads = {k: t.grad.clone() for k, t in trainable_tensors(model).items()}
    state = {k: v.clone() for k, v in model.state_dict().items()}
    state["embed_timestep.pe"] = model.embed_timestep.pe.detach().clone()
    return terms, grads, state


def stage1_step(inp, dp, steps=2, seed=7):
    """`steps` G+D steps from `inp["s1_state"]` with a generator seeded
    `seed`; returns (terms of each step, the states of both models after)."""
    from egohmr_tpu_torch.data import to_torch
    from egohmr_tpu_torch.models import Discriminator, ProHMRConfig, ProHMRLossWeights
    from egohmr_tpu_torch.models.prohmr import ProHMR
    from egohmr_tpu_torch.parallel import shard_batch
    from egohmr_tpu_torch.smpl import make_synthetic_model
    from egohmr_tpu_torch.train.prohmr_loop import make_optimizers, make_prohmr_train_step

    cfg = ProHMRConfig(**inp["s1_cfg"])
    model, disc = ProHMR(cfg), Discriminator()
    model.load_state_dict(inp["s1_state"])
    disc.load_state_dict(inp["s1_disc"])
    opt, dopt = make_optimizers(model, disc, lr=inp["lr"])
    smpl = [make_synthetic_model(seed=s, num_vertices=inp["V"]) for s in range(3)]
    step = make_prohmr_train_step(cfg, ProHMRLossWeights(), *smpl, opt, dopt, dp=dp)
    batch = shard_batch(dp, to_torch(inp["s1_batch"], "cpu"))
    mocap = shard_batch(dp, to_torch(inp["s1_mocap"], "cpu"))
    gen = torch.Generator().manual_seed(seed)
    terms = [{k: float(v) for k, v in step(model, disc, batch, mocap, gen).items()}
             for _ in range(steps)]
    return terms, {k: v.clone() for k, v in model.state_dict().items()}, \
        {k: v.clone() for k, v in disc.state_dict().items()}


def step_cases(dp, root):
    """The stage-2 step on JAX's draws (f32 and bf16-mixed), the stage-2
    step on the generator's draws over two steps, with and without the
    collision loss, and the stage-1 G+D step."""
    inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    out = {}
    for name, mp_ in (("f32", False), ("bf16", True)):
        out[f"jax_draws_{name}"] = stage2_step(inp, dp, mixed_precision=mp_,
                                               draws=inp["draws"])
    out["generator"] = stage2_step(inp, dp, mixed_precision=False, steps=2, seed=5)
    out["collision"] = stage2_step(inp, dp, mixed_precision=False, seed=6,
                                   use_collision=True)
    out["stage1"] = stage1_step(inp, dp)
    _save(root, "steps", dp, out)


# ----------------------------------------------------------------- the CLIs
def small_clis():
    """Patch the CLIs to the tiny widths and small synthetic batches."""
    from egohmr_tpu_torch.data import synthetic_batch
    from egohmr_tpu_torch.eval import test_egohmr
    from egohmr_tpu_torch.models import EgoHMRConfig, ProHMRConfig
    from egohmr_tpu_torch.train import train_egohmr, train_prohmr

    small = functools.partial(synthetic_batch, **SMALL_BATCH)
    patches = [(train_egohmr, "EgoHMRConfig", functools.partial(EgoHMRConfig, **TINY)),
               (test_egohmr, "EgoHMRConfig", functools.partial(EgoHMRConfig, **TINY)),
               (train_prohmr, "ProHMRConfig", functools.partial(ProHMRConfig, **TINY_PROHMR))]
    patches += [(m, "synthetic_batch", small) for m in (train_egohmr, test_egohmr, train_prohmr)]
    return patches


TRAIN_ARGS = ["--device", "cpu", "--synthetic", "--batch_size", "4", "--log_step", "1",
              "--val_step", "1", "--save_step", "1000", "--mixed_precision", "false",
              "--weight_coap_penetration", "0.01", "--start_coap_step", "1"]
PROHMR_ARGS = ["--device", "cpu", "--synthetic", "--batch_size", "4", "--log_step", "1",
               "--save_step", "1000"]
EVAL_ARGS = ["--device", "cpu", "--synthetic", "--batch_size", "4", "--num_samples", "2",
             "--num_batches", "1", "--bf16", "false", "--pointnet_impl", "xla",
             "--save_results", "true"]
# the evaluation runs: unguided DDIM-5, and guided DDPM-50 at a weight that
# moves the samples far more than the bars (checked by the test)
EVAL_RUNS = {"ddim5": ["--timestep_respacing_eval", "ddim5", "--with_coap_grad", "false"],
             "guided_ddpm": ["--timestep_respacing_eval", "ddpm", "--with_coap_grad", "true",
                             "--cond_grad_weight", "2e3"]}


def run_clis(root, tag, patch):
    """The three CLIs under `root/<tag>_*`: train_egohmr and train_prohmr 2
    steps resumed to 4, and test_egohmr's `EVAL_RUNS`. `patch(module,
    name, value)` sets an attribute. Returns the evaluation summaries."""
    from egohmr_tpu_torch.eval import test_egohmr
    from egohmr_tpu_torch.train import train_egohmr, train_prohmr

    for m, name, value in small_clis():
        patch(m, name, value)
    for steps in ("2", "4"):
        train_egohmr.main(TRAIN_ARGS + ["--save_dir", os.path.join(root, f"{tag}_s2"),
                                        "--num_steps", steps])
        train_prohmr.main(PROHMR_ARGS + ["--save_dir", os.path.join(root, f"{tag}_s1"),
                                         "--num_steps", steps])
    return {name: test_egohmr.main(EVAL_ARGS + extra + [
        "--save_root", os.path.join(root, f"{tag}_eval_{name}")])
        for name, extra in EVAL_RUNS.items()}


def cli_cases(dp, root):
    summaries = run_clis(root, "world2", setattr)
    _save(root, "clis", dp, summaries)


def np_tree(tree):
    """A nested dict of tensors as NumPy arrays."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
