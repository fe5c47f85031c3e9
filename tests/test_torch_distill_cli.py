"""Port parity of the distillation CLIs (`train/distill_occupancy.py`,
`train/distill_sdf.py`): flags, sidecars, the `.failed.npz` path, and
artifacts written by either package's CLI and read by the other's loader."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egohmr_tpu.collision import neural_occupancy as jocc
from egohmr_tpu.collision import neural_sdf as jsdf
from egohmr_tpu.smpl import lbs as j_lbs
from egohmr_tpu.smpl import make_synthetic_watertight_model as j_watertight
from egohmr_tpu.train import distill_occupancy as j_docc
from egohmr_tpu.train import distill_sdf as j_dsdf
from egohmr_tpu_torch.collision import neural_occupancy as tocc
from egohmr_tpu_torch.collision import neural_sdf as tsdf
from egohmr_tpu_torch.smpl import lbs, make_synthetic_watertight_model
from egohmr_tpu_torch.train import distill_occupancy as t_docc
from egohmr_tpu_torch.train import distill_sdf as t_dsdf

TINY_DISTILL = ["--synthetic_watertight", "--steps", "4", "--batch_bodies", "2",
                "--points_per_body", "64", "--latent_dim", "8", "--hidden_dim", "16",
                "--num_layers", "2", "--part_embed_dim", "4", "--eval_bodies", "2",
                "--eval_points_per_body", "64", "--log_every", "0"]
# (port CLI, JAX CLI, bar flag, loaders (JAX, port), query (JAX, port))
DISTILL = {
    "occupancy": (t_docc, j_docc, "--accuracy_bar", (jocc.load_occupancy, tocc.load_occupancy),
                  (jocc.occupancy_query, tocc.occupancy_query)),
    "sdf": (t_dsdf, j_dsdf, "--agreement_bar", (jsdf.load_sdfnet, tsdf.load_sdfnet),
            (jsdf.sdf_query, tsdf.sdf_query)),
}


@pytest.mark.parametrize("which", sorted(DISTILL))
def test_distill_cli_flags_match_jax(which):
    """The same flags with the same defaults, but `--device` (default
    `cuda`) for `--platform`."""
    tmod, jmod = DISTILL[which][:2]
    j, t = vars(jmod.parse_args([])), vars(tmod.parse_args([]))
    assert set(j) - set(t) == {"platform"} and set(t) - set(j) == {"device"}
    assert {k: v for k, v in j.items() if k != "platform"} == \
        {k: v for k, v in t.items() if k != "device"}
    assert t["device"] == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmod.main(TINY_DISTILL)


def _same_query(which, jparams, jcfg, net):
    """Both packages' query of one net on the same posed watertight bodies."""
    rng = np.random.RandomState(0)
    betas = (rng.randn(2, 10) * 0.5).astype(np.float32)
    aa = (rng.randn(2, 24, 3) * 0.2).astype(np.float32)
    pts = (rng.randn(2, 80, 3) * [0.3, 0.5, 0.2]).astype(np.float32)
    jm, tm = j_watertight(rings=6, segs=8), make_synthetic_watertight_model(rings=6, segs=8)
    jout = j_lbs(jm, jnp.asarray(betas), jnp.asarray(aa[:, 0]),
                 jnp.asarray(aa[:, 1:].reshape(2, 69)), pose2rot=True)
    tout = lbs(tm, torch.tensor(betas), torch.tensor(aa[:, 0]),
               torch.tensor(aa[:, 1:].reshape(2, 69)), pose2rot=True)
    jq, tq = DISTILL[which][4]
    want = np.asarray(jq(jparams, jcfg, jm, jout, jnp.asarray(betas), jnp.asarray(pts)))
    got = tq(net, tout, torch.tensor(betas), torch.tensor(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("which", sorted(DISTILL))
def test_distill_cli_artifacts_cross_load(which, tmp_path):
    """Each package's distillation CLI writes an artifact that the other
    package's loader reads to the same config and the same query; both
    sidecars hold the same keys; a run that misses its bar writes
    `.failed.npz` and leaves the passing artifact alone."""
    tmod, jmod, bar, (jload, tload), _ = DISTILL[which]
    extra = [] if which == "sdf" else ["--label_mode", "proximity"]
    tpath, jpath = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tmeta = tmod.main(TINY_DISTILL + extra + ["--device", "cpu", "--save_path", tpath, bar, "0"])
    jmeta = jmod.main(TINY_DISTILL + extra + ["--platform", "cpu", "--save_path", jpath, bar, "0"])
    assert set(tmeta) == set(jmeta) and tmeta["passed"]
    for k in ("body", "label_mode", "sign_k", "steps", "occupancy_config", "sdf_config"):
        assert tmeta.get(k) == jmeta.get(k), k
    with open(tpath + ".json") as f:
        assert json.load(f) == tmeta
    # the port's artifact in JAX, the JAX artifact in the port
    jparams, jcfg = jload(tpath)
    net = tload(tpath)
    assert jcfg.latent_dim == 8 and jcfg.hidden_dim == 16 and net.cfg.part_embed_dim == 4
    _same_query(which, jparams, jcfg, net)
    jparams, jcfg = jload(jpath)
    _same_query(which, jparams, jcfg, tload(jpath))
    before = open(tpath, "rb").read()
    failed = tmod.main(TINY_DISTILL + extra + ["--device", "cpu", "--save_path", tpath, bar, "1.1"])
    assert not failed["passed"] and os.path.exists(tpath + ".failed.npz")
    assert open(tpath, "rb").read() == before
