"""Port parity of the stage-2 evaluation CLI with the learned collision
backends: `--collision_backend occupancy` and `volsdf` and the
`test_egohmr_volsmpl` variant, against the JAX CLIs on the same weights,
batches and starting noise. The distillation CLIs are held to JAX in
`test_torch_distill_cli.py`."""
import os

import jax
import numpy as np
import pytest
import torch

import egohmr_tpu.data.synthetic as jsynthetic
from egohmr_tpu.eval import test_egohmr as jcli
from egohmr_tpu.eval import test_egohmr_volsmpl as jvol
from egohmr_tpu.models import EgoHMRConfig as JaxConfig
from egohmr_tpu.models import init_egohmr
from egohmr_tpu_torch.eval import sample_bodies
from egohmr_tpu_torch.eval import test_egohmr as tcli
from egohmr_tpu_torch.eval import test_egohmr_volsmpl as tvol
from egohmr_tpu_torch.interop import state_dict_from_jax
from egohmr_tpu_torch.models import EgoHMR

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "artifacts")
def test_volsmpl_cli_is_test_egohmr_with_volsdf_defaults():
    """The variant parses the same flags as `test_egohmr` with the volsdf
    backend, `--cond_grad_weight 30` and the shipped artifact as defaults,
    which explicit flags still override; its defaults equal JAX's."""
    args = tvol.parse_args(["--synthetic"])
    assert args.collision_backend == "volsdf" and args.cond_grad_weight == 30.0
    assert os.path.samefile(args.sdfnet_ckpt, os.path.join(ARTIFACTS, "volsdf_synthetic.npz"))
    base = tcli.parse_args(["--synthetic"])
    assert vars(args).keys() == vars(base).keys()
    ov = tvol.parse_args(["--synthetic", "--cond_grad_weight", "7", "--collision_backend", "sdf"])
    assert ov.cond_grad_weight == 7.0 and ov.collision_backend == "sdf"
    j = vars(jvol.parse_args(["--synthetic"]))
    t = vars(args)
    assert {k: v for k, v in j.items() if k not in ("platform", "sdfnet_ckpt")} == \
        {k: v for k, v in t.items() if k not in ("device", "sdfnet_ckpt")}
    assert os.path.samefile(j["sdfnet_ckpt"], t["sdfnet_ckpt"])


SCENE_POINTS = 2048
CLI_ARGS = ["--synthetic", "--batch_size", "2", "--num_batches", "1", "--num_samples", "2",
            "--data_parallel", "false", "--bf16", "false", "--pointnet_impl", "xla",
            "--timestep_respacing_eval", "ddim5", "--with_coap_grad", "true"]
RUNS = {
    "occupancy": (tcli, jcli, ["--collision_backend", "occupancy", "--occupancy_ckpt",
                               os.path.join(ARTIFACTS, "occupancy_synthetic_signed.npz")]),
    "volsdf": (tcli, jcli, ["--collision_backend", "volsdf", "--sdfnet_ckpt",
                            os.path.join(ARTIFACTS, "volsdf_synthetic.npz")]),
    "test_egohmr_volsmpl": (tvol, jvol, []),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_eval_cli_with_a_learned_backend_matches_jax(run, monkeypatch, capsys):
    """The evaluation CLI at full width on the CPU (ResNet-50, 6890
    vertices, the 192-wide shipped nets), 2 images x 2 samples, guided
    DDIM-5 with eta = 0, scenes of 2,048 points: the port's and the JAX
    package's CLI (or `test_egohmr_volsmpl`, at its own defaults but for
    DDIM-5) on the same weights, batches and x_T. Summary keys equal, values
    within rtol 1e-3; the collision ratio finite and in [0, 1]."""
    tmod, jmod, extra = RUNS[run]
    args = CLI_ARGS + extra
    cfg = JaxConfig(pointnet_impl="xla")
    params = init_egohmr(jax.random.PRNGKey(0), cfg)
    sub = jax.random.split(jax.random.PRNGKey(0))[1]
    x_T = np.asarray(jax.random.normal(jax.random.split(sub)[1], (4, 144)))

    def same_weights(tcfg):
        model = EgoHMR(tcfg)
        model.load_state_dict(state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, params)), strict=True)
        return model

    def same_noise(*a, **kw):
        return sample_bodies(*a, **{**kw, "noise": torch.tensor(x_T)})

    j_batch, t_batch = jsynthetic.synthetic_batch, tcli.synthetic_batch
    monkeypatch.setattr(jsynthetic, "synthetic_batch",
                        lambda *a, **kw: j_batch(*a, num_scene_points=SCENE_POINTS, **kw))
    monkeypatch.setattr(tcli, "synthetic_batch",
                        lambda *a, **kw: t_batch(*a, num_scene_points=SCENE_POINTS, **kw))
    monkeypatch.setattr(tcli, "_synthetic_model", same_weights)
    monkeypatch.setattr(tcli, "sample_bodies", same_noise)
    want = jmod.main(args + ["--platform", "cpu"])
    got = tmod.main(args + ["--device", "cpu"])
    capsys.readouterr()
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6, err_msg=k)
    assert np.isfinite(got["coll_ratio"]) and 0.0 <= got["coll_ratio"] <= 1.0
