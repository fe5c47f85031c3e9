"""Port parity of the data side: the NumPy copies (`data/augment.py`,
`native.py`, `viz/renderer.py`, `utils/checkpoint.py`, the dataset of
`data/egobody.py`) equal to the originals, and the torch versions
(`data/stats.py`, `to_device_batch`, `finalize_batch`, `smpl/loader.py`)
against egohmr_tpu on the same inputs. Exact unless a test says otherwise."""
import os
import pickle

import numpy as np
import pytest
import torch

from egohmr_tpu import native as jnative
from egohmr_tpu.data import augment as jaug
from egohmr_tpu.data import egobody as jego
from egohmr_tpu.data import stats as jstats
from egohmr_tpu.smpl import loader as jloader
from egohmr_tpu.utils import checkpoint as jckpt
from egohmr_tpu.viz import renderer as jviz
from egohmr_tpu_torch import native as tnative
from egohmr_tpu_torch.data import augment as taug
from egohmr_tpu_torch.data import egobody as tego
from egohmr_tpu_torch.data import stats as tstats
from egohmr_tpu_torch.smpl import loader as tloader
from egohmr_tpu_torch.utils import checkpoint as tckpt
from egohmr_tpu_torch.viz import renderer as tviz

from .test_egobody_dataset import egobody_root  # noqa: F401 (pytest fixture)


def _assert_tree_equal(a, b, path=""):
    """Nested dicts/lists of arrays, tensors, strings and scalars: equal
    keys, shapes, dtypes and values."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)) and (not a or isinstance(a[0], (str, dict, list))):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, str):
        assert a == b, path
    else:
        x = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        y = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert x.shape == y.shape and x.dtype == y.dtype, (path, x.shape, y.shape, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=path)


# ---------------------------------------------------------------- augment

def _example_inputs(seed):
    rng = np.random.RandomState(seed)
    img = (rng.rand(270, 480, 3) * 255).astype(np.uint8)
    kp2d = np.concatenate([rng.rand(25, 2) * 400, (rng.rand(25, 1) > 0.2)], -1).astype(np.float32)
    kp3d = (rng.randn(24, 3) * 0.3 + [0.1, 0.2, 2.5]).astype(np.float32)
    sp = {"global_orient": rng.randn(3).astype(np.float32) * 0.3,
          "body_pose": rng.randn(69).astype(np.float32) * 0.2,
          "betas": rng.randn(10).astype(np.float32),
          "transl": np.array([0.1, 0.2, 2.5], np.float32)}
    scene = (rng.randn(300, 3) + [0, 0, 2.5]).astype(np.float32)
    return img, kp2d, kp3d, sp, scene


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_augment_copy_equals_original(seed):
    """Same RandomState -> the same drawn parameters, and `get_example`
    (every geometry helper runs inside it) gives the same item, with the
    image decoded and with the warp spec only."""
    cfg_j, cfg_t = jaug.AugmentConfig(), taug.AugmentConfig()
    pj = jaug.draw_augment_params(cfg_j, np.random.RandomState(seed))
    pt = taug.draw_augment_params(cfg_t, np.random.RandomState(seed))
    assert tuple(pj.__dict__.values()) == tuple(pt.__dict__.values())
    img, kp2d, kp3d, sp, scene = _example_inputs(seed)
    mean, std = jego.IMAGE_MEAN, jego.IMAGE_STD
    for image, shape in ((img, None), (None, img.shape[:2])):
        args = (image, 240.0, 130.0, 210.0, 210.0, kp2d, kp3d, sp, 224, mean, std)
        a = jaug.get_example(*args, pj, 750.0, 240.0, 135.0, scene, img_shape=shape)
        b = taug.get_example(*args, pt, 750.0, 240.0, 135.0, scene, img_shape=shape)
        _assert_tree_equal(a, b)
    assert a["transl_needs_recompute"] == b["transl_needs_recompute"]


def test_augment_helpers_equal_original():
    rng = np.random.RandomState(5)
    tr_j = jaug.crop_transform(200.0, 120.0, 180.0, 180.0, 224, 224, 1.1, 25.0)
    tr_t = taug.crop_transform(200.0, 120.0, 180.0, 180.0, 224, 224, 1.1, 25.0)
    np.testing.assert_array_equal(tr_j, tr_t)
    img = rng.rand(60, 80, 3).astype(np.float32)
    np.testing.assert_array_equal(jaug.warp_affine(img, tr_j * 0.3, 32, 32),
                                  taug.warp_affine(img, tr_t * 0.3, 32, 32))
    pts = rng.randn(20, 3).astype(np.float32)
    np.testing.assert_array_equal(jaug.rotate_points_3d(pts, 17.0), taug.rotate_points_3d(pts, 17.0))
    aa = rng.randn(3).astype(np.float32)
    np.testing.assert_array_equal(jaug.rot_aa(aa, -40.0), taug.rot_aa(aa, -40.0))
    sp = {"global_orient": rng.randn(3).astype(np.float32),
          "body_pose": rng.randn(69).astype(np.float32)}
    _assert_tree_equal(jaug.fliplr_smpl_params(sp), taug.fliplr_smpl_params(sp))
    joints = lambda b, go, bp: np.broadcast_to(b[:, None, :3], (len(b), 45, 3))  # noqa: E731
    batch = {"betas": rng.randn(4, 10), "global_orient": rng.randn(4, 3), "body_pose": rng.randn(4, 69)}
    kp = rng.randn(4, 24, 3)
    np.testing.assert_array_equal(jaug.recompute_transl(joints, batch, kp),
                                  taug.recompute_transl(joints, batch, kp))


def test_native_copy_equals_original():
    """Both bindings load the one shared host library; with it, the fused
    warp gives the same pixels through either; without it, both say so."""
    assert tnative._LIB_PATH == jnative._LIB_PATH
    assert tnative.available() == jnative.available()
    rng = np.random.RandomState(6)
    img = (rng.rand(90, 120, 3) * 255).astype(np.uint8)
    trans = np.array([[1.5, 0.1, -10.0], [-0.1, 1.5, 5.0]], np.float32)
    kw = dict(color_scale=(0.9, 1.0, 1.1), mean=(120.0, 115.0, 100.0), std=(58.0, 57.0, 57.0))
    a = jnative.warp_affine_norm(img, trans, 64, **kw)
    b = tnative.warp_affine_norm(img, trans, 64, **kw)
    if a is None:
        assert b is None and tnative.decode_jpeg("missing.jpg") is None
    else:
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- stats

def test_body_rep_stats_match_jax(tmp_path):
    """atol 1e-6: the statistics of 200 poses through each package's own
    `aa_to_rotmat`."""
    rng = np.random.RandomState(7)
    go, bp = rng.randn(200, 3).astype(np.float32) * 0.5, rng.randn(200, 69).astype(np.float32) * 0.3
    mean_j, std_j = jstats.compute_body_rep_stats(go, bp)
    mean_t, std_t = tstats.compute_body_rep_stats(go, bp)
    assert mean_t.shape == (144,) and mean_t.dtype == np.float32 and std_t.dtype == np.float32
    np.testing.assert_allclose(mean_t, mean_j, atol=1e-6, rtol=0)
    np.testing.assert_allclose(std_t, std_j, atol=1e-6, rtol=0)
    assert len(np.unique(std_t[:6])) == 1 and len(np.unique(std_t[6:])) == 1
    # each package reads the file the other wrote
    pj, pt = str(tmp_path / "a" / "stats_j.npz"), str(tmp_path / "b" / "stats_t.npz")
    jstats.save_stats(pj, mean_j, std_j)
    tstats.save_stats(pt, mean_t, std_t)
    for x, y in zip(tstats.load_stats(pj), (mean_j, std_j)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(jstats.load_stats(pt), (mean_t, std_t)):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------- renderer

def test_renderer_copy_equals_original():
    """One mesh through both rasterisers, pixel for pixel; the point splat
    and the in-scene view too."""
    from egohmr_tpu_torch.smpl import make_synthetic_model

    model = make_synthetic_model(num_vertices=300, num_faces=500)
    verts = model.v_template.numpy() + np.array([0.0, 0.0, 2.0], np.float32)
    faces = model.faces.numpy()
    img = np.full((120, 160, 3), 40, np.uint8)
    args = (img, verts, faces, (150.0, 150.0), (80.0, 60.0))
    a, b = jviz.render_mesh_soft(*args), tviz.render_mesh_soft(*args)
    np.testing.assert_array_equal(a, b)
    assert (a != img).any()
    np.testing.assert_array_equal(jviz.render_on_img(*args), tviz.render_on_img(*args))
    pts = (img, verts, None, (150.0, 150.0), (80.0, 60.0))
    np.testing.assert_array_equal(jviz.render_on_img(*pts), tviz.render_on_img(*pts))
    np.testing.assert_array_equal(jviz.project_vertices(verts, (150.0, 150.0), (80.0, 60.0)),
                                  tviz.project_vertices(verts, (150.0, 150.0), (80.0, 60.0)))
    scene = np.random.RandomState(8).randn(200, 3) + [0, 0, 3.0]
    kw = dict(img_size=(160, 120), focal_length=(150.0, 150.0))
    np.testing.assert_array_equal(jviz.render_in_scene(verts, faces, scene, **kw),
                                  tviz.render_in_scene(verts, faces, scene, **kw))


# ---------------------------------------------------------------- SMPL loader

def _write_smpl_pkl(path, seed, sparse=False, num_vertices=128, n_shape=300):
    """A pickle in the official files' layout from the synthetic model's
    arrays: posedirs as [V, 3, 207], `n_shape` shape directions (the
    official files have 300), uint32 faces."""
    import scipy.sparse

    V = num_vertices
    m = jloader.make_synthetic_model(seed=seed, num_vertices=V, num_faces=200)
    rng = np.random.RandomState(seed)
    shapedirs = np.concatenate([np.asarray(m.shapedirs, np.float64),
                                rng.randn(V, 3, n_shape - 10) * 0.01], axis=-1)
    j_reg = np.asarray(m.j_regressor, np.float64)
    data = {
        "v_template": np.asarray(m.v_template, np.float64),
        "shapedirs": shapedirs,
        "posedirs": np.asarray(m.posedirs, np.float64).T.reshape(V, 3, 207),
        "J_regressor": scipy.sparse.csc_matrix(j_reg) if sparse else j_reg,
        "weights": np.asarray(m.lbs_weights, np.float64),
        "f": np.asarray(m.faces).astype(np.uint32),
        "kintree_table": np.zeros((2, 24), np.int64),
    }
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=2)


@pytest.mark.parametrize("sparse", [False, True])
def test_load_smpl_pkl_and_create_match_jax(tmp_path, sparse):
    """A pickle the test writes, loaded by both packages: equal tables, and
    `create` finds the gendered file in a directory, under `smpl/`, or takes
    a file."""
    d = tmp_path / "models"
    os.makedirs(d / "smpl")
    _write_smpl_pkl(d / "SMPL_NEUTRAL.pkl", 0, sparse)
    _write_smpl_pkl(d / "smpl" / "SMPL_FEMALE.pkl", 1, sparse)
    for path, gender in ((str(d), "neutral"), (str(d), "female"),
                         (str(d / "SMPL_NEUTRAL.pkl"), "male")):
        mj, mt = jloader.create(path, gender), tloader.create(path, gender)
        for name in mt._fields:
            a, b = np.asarray(getattr(mj, name)), getattr(mt, name).numpy()
            assert a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert mt.shapedirs.shape == (128, 3, 10) and mt.posedirs.shape == (207, 128 * 3)
        assert mt.faces.dtype == torch.int64 and mt.v_template.dtype == torch.float32
    with pytest.raises(FileNotFoundError):
        tloader.create(str(d), "male")
    np.testing.assert_array_equal(
        tloader.load_smpl_pkl(str(d / "SMPL_NEUTRAL.pkl"), num_betas=4).shapedirs.numpy(),
        np.asarray(jloader.load_smpl_pkl(str(d / "SMPL_NEUTRAL.pkl"), num_betas=4).shapedirs))


# ---------------------------------------------------------------- npz trees

def test_npz_tree_copy_equals_original(tmp_path):
    """Each package's `load_npz_tree` reads what either `save_npz` wrote:
    the same nesting, lists restored, equal arrays (NumPy leaves in the
    port); the ambiguous all-digit dict is refused by both."""
    rng = np.random.RandomState(9)
    f32 = lambda *shape: rng.randn(*shape).astype(np.float32)  # noqa: E731
    tree = {"a": {"w": f32(3, 4), "b": f32(4)},
            "layers": [{"w": f32(2, 2)}, {"w": f32(2, 2)}],
            "step": np.int32(7)}
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "sub" / "t.npz")
    jckpt.save_npz(pj, tree)
    tckpt.save_npz(pt, tree)
    for path in (pj, pt):
        got, want = tckpt.load_npz_tree(path), jckpt.load_npz_tree(path)
        assert isinstance(got["layers"], list) and isinstance(got["a"]["w"], np.ndarray)
        _assert_tree_equal(got, {k: v for k, v in want.items()})
        np.testing.assert_array_equal(got["a"]["w"], tree["a"]["w"])
    for mod in (jckpt, tckpt):
        with pytest.raises(ValueError, match="digit"):
            mod.save_npz(str(tmp_path / "bad.npz"), {"x": {"0": np.zeros(1), "1": np.zeros(1)}})


# ---------------------------------------------------------------- dataset

def _datasets(root, **kw):
    common = dict(dataset_file=os.path.join(root, "annotations.npz"), data_root=root,
                  split="test", train=False, **kw)
    return jego.EgoBodyDataset(**common), tego.EgoBodyDataset(**common)


@pytest.mark.parametrize("kw", [
    dict(scene_type="cube"),
    dict(scene_type="whole_scene", spacing=2),
    dict(scene_type="cube", load_stage1_transl=True, add_scale=1.2),
    dict(scene_type="cube", do_augment=True, seed=3),
], ids=["cube", "whole_scene", "stage1", "augmented"])
def test_dataset_copy_equals_original(egobody_root, kw):  # noqa: F811
    """Items and collated batches of the synthetic on-disk fixture, key for
    key, from both packages (the per-item Python path and, where the host
    library is built, the threaded native loader)."""
    if kw.get("load_stage1_transl"):
        kw = dict(kw, stage1_result_path=os.path.join(egobody_root, "stage1.pkl"))
    dj, dt = _datasets(egobody_root, **kw)
    assert len(dj) == len(dt)
    _assert_tree_equal(dj[0], dt[0])
    dj, dt = _datasets(egobody_root, **kw)  # fresh augmentation streams
    for native_loader in (False, True):
        dj.use_native_loader = dt.use_native_loader = native_loader
        bj = list(dj.iter_batches(2, shuffle=False, drop_last=False))
        bt = list(dt.iter_batches(2, shuffle=False, drop_last=False))
        assert len(bj) == len(bt) == -(-len(dj) // 2)
        for a, b in zip(bj, bt):
            _assert_tree_equal(a, b)
    assert bt[0]["img"].shape == (2, 224, 224, 3)  # NHWC at the boundary
    items = [dt[i] for i in range(2)]
    _assert_tree_equal(jego.collate(items), tego.collate(items))


def test_mocap_dataset_copy_equals_original(tmp_path):
    rng = np.random.RandomState(10)
    path = str(tmp_path / "mocap.npz")
    np.savez(path, pose=rng.randn(30, 72).astype(np.float32), betas=rng.randn(30, 10).astype(np.float32))
    mj, mt = jego.MoCapDataset(path), tego.MoCapDataset(path)
    assert len(mj) == len(mt) == 30
    _assert_tree_equal(mj.sample(8, np.random.RandomState(1)), mt.sample(8, np.random.RandomState(1)))


def test_to_device_batch_matches_jax_and_copies(egobody_root):  # noqa: F811
    """The same keys survive in both packages, values equal; the tensors
    own their memory (writing to the NumPy batch afterwards changes
    nothing)."""
    _, dt = _datasets(egobody_root, scene_type="cube", load_stage1_transl=True,
                      stage1_result_path=os.path.join(egobody_root, "stage1.pkl"))
    batch = next(dt.iter_batches(3, shuffle=False))
    jb, tb = jego.to_device_batch(batch), tego.to_device_batch(batch, "cpu")
    assert set(jb) == set(tb) and not set(tego.HOST_ONLY_KEYS) & set(tb)
    assert "stage1_transl_full" in tb and isinstance(tb["img"], torch.Tensor)
    for k in tb:
        if isinstance(tb[k], dict):
            for kk in tb[k]:
                np.testing.assert_array_equal(tb[k][kk].numpy(), np.asarray(jb[k][kk]))
        else:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)
    before = tb["img"].clone()
    batch["img"][:] = 0.0
    assert torch.equal(tb["img"], before)


def test_finalize_batch_matches_jax(egobody_root):  # noqa: F811
    """Augmented items get transl = augmented pelvis - local pelvis of the
    gendered body (two different bodies here), the others keep theirs:
    rtol 1e-5 / atol 1e-5 against JAX's LBS."""
    from egohmr_tpu_torch.smpl import make_synthetic_model

    _, dt = _datasets(egobody_root, scene_type="cube", do_augment=True, seed=5)
    batch = next(dt.iter_batches(6, shuffle=False))
    batch["transl_needs_recompute"] = np.array([True, False, True, True, False, True])
    sj = [jloader.make_synthetic_model(seed=s, num_vertices=200) for s in (0, 1)]
    st = [make_synthetic_model(seed=s, num_vertices=200) for s in (0, 1)]
    want = jego.finalize_batch(dict(batch), *sj)["smpl_params"]["transl"]
    out = tego.finalize_batch(dict(batch), *st)
    got = out["smpl_params"]["transl"]
    assert got.dtype == np.float32 and got.shape == (6, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    keep = ~batch["transl_needs_recompute"]
    np.testing.assert_array_equal(got[keep], batch["smpl_params"]["transl"][keep])
    assert np.abs(got[~keep] - batch["smpl_params"]["transl"][~keep]).max() > 1e-3
    assert out is not batch and batch["smpl_params"]["transl"] is not got
    untouched = dict(batch, transl_needs_recompute=np.zeros(6, bool))
    assert tego.finalize_batch(untouched, *st) is untouched
