"""`egohmr_tpu_torch/tools/visualize_results.py` against the JAX package's
`tools/visualize_results.py`: both render the same `results.pkl` and scene
cloud, with the same views, sizes and file names."""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from egohmr_tpu_torch.geometry import aa_to_rotmat
from egohmr_tpu_torch.tools import visualize_results as tviz

from .test_torch_tools import jax_tool
from .torch_parity import tmp_path  # noqa: F401 (a fixture)

N, S = 2, 2
VIEWS = ["camera", "orbit45", "orbit-45", "top"]


def _results(path):
    """A results.pkl in the eval CLI's schema: random poses as rotation
    matrices, betas, and stage-1 and GT translations about 2.5 m ahead."""
    import pickle

    rng = np.random.RandomState(4)
    rot = aa_to_rotmat(torch.tensor(0.3 * rng.randn(N * S * 24, 3), dtype=torch.float32))
    rot = rot.numpy().reshape(N, S, 24, 3, 3)
    transl = (np.array([0.1, 0.3, 2.5]) + 0.2 * rng.randn(N, 3)).astype(np.float32)
    res = {"pred_betas_list": (0.5 * rng.randn(N, S, 10)).astype(np.float32),
           "pred_global_orient_list": rot[:, :, :1], "pred_body_pose_list": rot[:, :, 1:],
           "pred_cam_full_list": transl, "gt_cam_full_list": transl + 0.05}
    with open(path, "wb") as f:
        pickle.dump(res, f)


def test_renders_equal_the_jax_tools(tmp_path, monkeypatch):  # noqa: F811
    """Index 0 and 1, sample 1, every view, at 320 x 200 with the scene and
    the axis frame: the same files at the same sizes; the SMPL vertices
    each tool renders within rtol 1e-5 (atol 1e-6); per image, at least
    99.5% of the pixels equal. The pixels that differ sit on triangle
    edges, where the two packages' f32 vertices, apart by rounding, move an
    edge across a pixel centre: one pixel of 64,000, in one of the 8 images
    (`vis_0000_orbit-45.png`; read on the CPU)."""
    jviz = jax_tool("visualize_results")
    pkl, scene = str(tmp_path / "results.pkl"), str(tmp_path / "scene.npy")
    _results(pkl)
    rng = np.random.RandomState(5)
    np.save(scene, rng.randn(400, 3) * [1.0, 0.5, 0.8] + [0.0, 0.5, 3.0])
    argv = ["--results", pkl, "--scene", scene, "--synthetic_smpl", "--indices", "0", "1",
            "--sample", "1", "--img_size", "320", "200", "--views", *VIEWS]
    verts = {"jax": [], "port": []}
    for side, mod in (("jax", jviz), ("port", tviz)):
        compose = mod.compose_and_render

        def spy(body_verts, *a, _side=side, _compose=compose, **kw):
            verts[_side].append(np.asarray(body_verts))
            return _compose(body_verts, *a, **kw)

        monkeypatch.setattr(mod, "compose_and_render", spy)
    want = jviz.main(argv + ["--out_dir", str(tmp_path / "j")])
    got = tviz.main(argv + ["--out_dir", str(tmp_path / "t"), "--device", "cpu"])
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 2 * len(VIEWS)
    for a, b in zip(verts["port"], verts["jax"]):
        assert a.shape == b.shape == (6890, 3)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for p, q in zip(got, want):
        a, b = np.asarray(Image.open(p)), np.asarray(Image.open(q))
        assert a.shape == b.shape == (200, 320, 3), p
        equal = (a == b).all(-1).mean()
        assert equal >= 0.995, (p, equal)
    with pytest.raises(AssertionError, match="out of range"):
        tviz.main(["--results", pkl, "--synthetic_smpl", "--indices", "2", "--device", "cpu",
                   "--out_dir", str(tmp_path / "t")])
