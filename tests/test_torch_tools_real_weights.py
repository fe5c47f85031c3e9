"""`egohmr_tpu_torch/tools/real_weights_eval.py` against the JAX package's
`tools/real_weights_eval.py`: both run the two-stage evaluation from the
same checkpoints in the reference layout, fabricated as
`tests/test_real_weights_rehearsal.py` fabricates them, on the on-disk
EgoBody fixture."""
import json
import os

import jax
import numpy as np
import torch

from egohmr_tpu_torch.eval import test_egohmr as s2cli
from egohmr_tpu_torch.eval import test_prohmr as s1cli
from egohmr_tpu_torch.smpl import make_synthetic_model
from egohmr_tpu_torch.tools import real_weights_eval as tool

from .test_egobody_dataset import egobody_root  # noqa: F401 (a fixture)
from .test_torch_tools import jax_tool
from .torch_parity import tmp_path  # noqa: F401 (a fixture)

B, S = 3, 2  # 6 images: two batches


def test_report_matches_the_jax_tools(egobody_root, tmp_path, monkeypatch):  # noqa: F811
    """Full width on the CPU (stage 1: ResNet-50, the 4-step Glow at hidden
    1024; stage 2: `EgoHMRConfig()`; the fixture's 800- and 500-point
    clouds): the release-layout `.pt` files that the JAX package's
    `export_prohmr`/`export_egohmr` + `save_state_dict` write from its
    inits, which the JAX tool converts on load and the port loads as they
    are, 3 images x 2 samples a batch, unguided DDIM-5, f32. Stage 1's
    metrics and translations use the z = 0 mode only, so its other samples
    need no common draw; stage 2 samples from the x_T of the JAX CLI's key
    chain, handed to the port. Both SMPL bodies are the synthetic
    6890-vertex model. The two reports hold the same keys, with values
    within rtol 1e-3 (atol 1e-6), the bars of `tests/test_torch_eval.py`
    and `tests/test_torch_prohmr_cli.py`."""
    from egohmr_tpu import smpl as j_smpl
    from egohmr_tpu.data.stats import save_stats
    from egohmr_tpu.interop.torch_export import export_egohmr, export_prohmr, save_state_dict
    from egohmr_tpu.models import EgoHMRConfig, init_egohmr
    from egohmr_tpu.models.prohmr import ProHMRConfig, init_prohmr
    from egohmr_tpu.smpl import make_synthetic_model as j_make_smpl

    jrwe = jax_tool("real_weights_eval")
    j_body = j_make_smpl(num_vertices=6890)
    monkeypatch.setattr(j_smpl, "create", lambda *a, **k: j_body)
    for cli in (s1cli, s2cli):
        monkeypatch.setattr(cli, "smpl_create", lambda *a, device=None, **k: make_synthetic_model(
            num_vertices=6890, device=device))

    # the JAX stage-2 CLI's draw for batch i: key, sub = split(key), and
    # sample_loop's x_T from split(sub)[1]
    key, x_T = jax.random.PRNGKey(0), []
    for _ in range(2):
        key, sub = jax.random.split(key)
        x_T.append(np.asarray(jax.random.normal(jax.random.split(sub)[1], (B * S, 144))))
    calls = []
    sample = s2cli.sample_bodies

    def same_noise(*a, **kw):
        calls.append(1)
        return sample(*a, **{**kw, "noise": torch.tensor(x_T[len(calls) - 1])})

    monkeypatch.setattr(s2cli, "sample_bodies", same_noise)

    pt1, pt2 = str(tmp_path / "53618.pt"), str(tmp_path / "91453.pt")
    save_state_dict(export_prohmr(jax.device_get(
        init_prohmr(jax.random.PRNGKey(0), ProHMRConfig()))), pt1)
    save_state_dict(export_egohmr(jax.device_get(
        init_egohmr(jax.random.PRNGKey(1), EgoHMRConfig()))), pt2)
    stats = str(tmp_path / "preprocess_stats.npz")
    save_stats(stats, np.zeros(144, np.float32), np.ones(144, np.float32))
    argv = ["--stage1_checkpoint", pt1, "--stage2_checkpoint", pt2,
            "--dataset_root", egobody_root,
            "--dataset_file", os.path.join(egobody_root, "annotations.npz"),
            "--body_rep_stats", stats, "--batch_size", str(B), "--num_samples", str(S),
            "--timestep_respacing_eval", "ddim5", "--with_coap_grad", "false", "--bf16", "false",
            "--data_parallel", "false",
            "--scene_crop_by_stage1_transl", "false"]  # the fixture ships the GT cubes
    want = jrwe.main(argv + ["--save_root", str(tmp_path / "j"), "--platform", "cpu"])
    got = tool.main(argv + ["--save_root", str(tmp_path / "t"), "--device", "cpu"])
    assert len(calls) == 2

    assert list(got) == list(want)
    assert (got["stage1_checkpoint"], got["stage2_checkpoint"]) == (pt1, pt2)
    for part in ("stage1_metrics_mm", "stage2_metrics"):
        assert list(got[part]) == list(want[part]), part
        for k in want[part]:
            np.testing.assert_allclose(got[part][k], want[part][k], rtol=1e-3, atol=1e-6,
                                       err_msg=f"{part} {k}")
    assert np.isfinite(got["stage2_metrics"]["g_mpjpe"])
    with open(tmp_path / "t" / "report.json") as f:
        assert json.load(f) == got
    assert os.path.exists(tmp_path / "t" / "stage1" / "results.pkl")
