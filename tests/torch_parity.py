"""Shared set-up for the parity tests of the PyTorch port.

The same seeded NumPy inputs and weights go through `egohmr_tpu` (JAX) and
`egohmr_tpu_torch`; weights reach the port through
`interop.state_dict_from_jax`. Every crossing copies.

Importing this module pins torch's intra-op threads under pytest-xdist
(`pin_torch_threads`). Every xdist worker imports every test module while it
collects, so each worker is pinned before its first test, in the test files
that do not import this module too.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egohmr_tpu.models import EgoHMRConfig as JaxConfig
from egohmr_tpu.models import init_egohmr
from egohmr_tpu_torch.interop import state_dict_from_jax
from egohmr_tpu_torch.models import EgoHMR, EgoHMRConfig


def pin_torch_threads() -> int:
    """Under pytest-xdist (`PYTEST_XDIST_WORKER` set), set torch's intra-op
    threads to this worker's share of the cores, max(1, cores // workers):
    each worker at torch's default of one thread per core oversubscribes
    the host several times over. Returns the thread count in force."""
    if os.environ.get("PYTEST_XDIST_WORKER"):
        workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    return torch.get_num_threads()


THREADS = pin_torch_threads()

@pytest.fixture
def tmp_path(tmp_path):
    """pytest's `tmp_path`, removed when the test ends. Imported into a test
    module, it takes the place of pytest's own there: pytest keeps the
    directories of the last three runs, and the port's CLI tests write
    checkpoints of hundreds of MB each."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


# tiny widths; ResNet-18 because the JAX "stub" backbone has no torch layout
TINY = dict(resnet_layers=18, img_feat_dim=512, scene_feat_dim=32,
            pointnet_hidden_dim=32, transl_embed_dim=16, timestep_embed_dim=32,
            input_process_dim=32, gcn_hid_dim=64, gcn_layers=2)
_BN = {"scale", "bias", "mean", "var"}
_ACTNORM = {"log_scale", "shift"}
_LU = {"lower_entries", "upper_entries", "unconstrained_upper_diag", "bias"}


def randomize(params, seed: int = 0) -> dict:
    """A NumPy copy of a JAX param tree with the values that the JAX init
    leaves degenerate drawn at random: BatchNorm statistics (init 0/1),
    GCN `adj2` (init 1e-6), the PointNet `fc_1` weights (init 0), and in a
    Glow flow the ActNorm scale and shift and the LU linear (identity at
    init) and each coupling block's last layer (U(+-1e-3) at init), so that
    no flow step is close to the identity. The LU triangles are drawn at
    0.3 / sqrt(F), which keeps their inverses well conditioned."""
    rng = np.random.RandomState(seed)

    def walk(node):
        if isinstance(node, dict):
            if set(node) == _BN:
                c = np.asarray(node["mean"]).shape[0]
                return {"scale": 1 + 0.1 * rng.randn(c), "bias": 0.1 * rng.randn(c),
                        "mean": 0.1 * rng.randn(c), "var": 1 + 0.2 * rng.rand(c)}
            if set(node) == _ACTNORM:
                f = np.asarray(node["shift"]).shape[0]
                return {"log_scale": 0.2 * rng.randn(f), "shift": 0.3 * rng.randn(f)}
            if set(node) == _LU:
                f = np.asarray(node["bias"]).shape[0]
                n = np.asarray(node["lower_entries"]).shape[0]
                return {"lower_entries": 0.3 / np.sqrt(f) * rng.randn(n),
                        "upper_entries": 0.3 / np.sqrt(f) * rng.randn(n),
                        "unconstrained_upper_diag": np.asarray(node["unconstrained_upper_diag"])
                        + 0.3 * rng.randn(f),
                        "bias": 0.1 * rng.randn(f)}
            out = {k: walk(v) for k, v in node.items()}
            if "context_layer" in out and "l1" in out:  # a coupling net's residual block
                w = out["l1"]["w"]
                out["l1"] = {"w": rng.randn(*w.shape) / np.sqrt(w.shape[0]),
                             "b": 0.1 * rng.randn(w.shape[1])}
            if "adj2" in out:
                out["adj2"] = 0.1 * rng.randn(*out["adj2"].shape)
            if "fc_1" in out and not np.any(out["fc_1"]["w"]):
                w = out["fc_1"]["w"]
                out["fc_1"]["w"] = rng.randn(*w.shape) / np.sqrt(w.shape[0])
            return out
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return np.array(node, dtype=np.float32)

    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), walk(params))


def to_jax(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)), tree)


def to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy().copy()
    return np.array(t, dtype=np.float32)


def tiny_pair(seed: int = 0, **overrides):
    """(jax_cfg, port_cfg, numpy params, port model) on the same weights."""
    kw = {**TINY, **overrides}
    jcfg, tcfg = JaxConfig(**kw), EgoHMRConfig(**kw)
    params = randomize(init_egohmr(jax.random.PRNGKey(seed), jcfg), seed)
    model = EgoHMR(tcfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return jcfg, tcfg, params, model.eval()


# stage 1 at tiny widths: a flow of 2 steps of 1 block at hidden 32
TINY_PROHMR = dict(resnet_layers=18, img_feat_dim=512, scene_feat_dim=32,
                   pointnet_hidden_dim=32, flow_hidden=32, flow_layers=2, flow_depth=1,
                   fc_head_hidden=32)


def tiny_prohmr_pair(seed: int = 0, **overrides):
    """(jax_cfg, port_cfg, numpy params, port model) of stage 1 on the same
    randomised weights, loaded with `strict=True`."""
    from egohmr_tpu.models.prohmr import ProHMRConfig as JProHMRConfig
    from egohmr_tpu.models.prohmr import init_prohmr
    from egohmr_tpu_torch.interop import prohmr_state_dict_from_jax
    from egohmr_tpu_torch.models import ProHMR, ProHMRConfig

    kw = {**TINY_PROHMR, **overrides}
    jcfg, tcfg = JProHMRConfig(**kw), ProHMRConfig(**kw)
    rng = np.random.RandomState(seed + 100)
    params = randomize(init_prohmr(jax.random.PRNGKey(seed), jcfg, jnp.asarray(
        0.3 * rng.randn(10).astype(np.float32)), jnp.asarray([0.9, 0.05, -0.03])), seed)
    model = ProHMR(tcfg)
    model.load_state_dict(prohmr_state_dict_from_jax(params), strict=True)
    return jcfg, tcfg, params, model.eval()


def jax_stage1_draws(key, cfg, batch_size: int):
    """(z [B, S, 144] with sample 0 the mode, nll_noise [B, 144]) as
    `egohmr_tpu.train.prohmr_loop.generator_loss` draws them from `key`."""
    k_sample, k_noise = jax.random.split(key)
    S = cfg.num_train_samples
    z = np.zeros((batch_size, S, cfg.flow_dim), np.float32)
    z[:, 1:] = np.asarray(jax.random.normal(k_sample, (batch_size, S - 1, cfg.flow_dim)))
    noise = jax.random.normal(jax.random.split(k_noise)[0], (batch_size, 144))
    return {"z": torch.tensor(z), "nll_noise": torch.tensor(np.array(noise))}
