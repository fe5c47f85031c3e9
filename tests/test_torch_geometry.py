"""Port parity: geometry/ (rotations and projection) against egohmr_tpu,
atol 1e-5 (the bar of the JAX golden tests) on rotation entries, which are
O(1); pixel coordinates state their own bar."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egohmr_tpu.geometry import projection as jproj
from egohmr_tpu.geometry import rotations as jrot
from egohmr_tpu_torch.geometry import projection as tproj
from egohmr_tpu_torch.geometry import rotations as trot

ATOL = 1e-5


def _both(fn_j, fn_t, *arrays, **kw):
    want = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays), **kw))
    got = fn_t(*(torch.tensor(a) for a in arrays), **kw).numpy()
    return got, want


@pytest.mark.parametrize("mode", ["prohmr", "diffusion"])
def test_rot6d_to_rotmat(mode):
    x = np.random.RandomState(0).randn(7, 24 * 6).astype(np.float32)
    got, want = _both(jrot.rot6d_to_rotmat, trot.rot6d_to_rotmat, x, rot6d_mode=mode)
    assert got.shape == (7 * 24, 3, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_rot6d_layouts_differ():
    """The two layouts read different entries: columns vs rows."""
    x = np.random.RandomState(1).randn(5, 6).astype(np.float32)
    a = trot.rot6d_to_rotmat(torch.tensor(x), "diffusion")
    b = trot.rot6d_to_rotmat(torch.tensor(x), "prohmr")
    assert not torch.allclose(a, b)
    # 'diffusion': the first column is the normalised (x0, x2, x4)
    col = x[:, [0, 2, 4]] / np.linalg.norm(x[:, [0, 2, 4]], axis=-1, keepdims=True)
    np.testing.assert_allclose(a[:, :, 0].numpy(), col, atol=ATOL)


@pytest.mark.parametrize("mode", ["prohmr", "diffusion"])
def test_rotmat_to_rot6d_roundtrip(mode):
    aa = np.random.RandomState(2).randn(11, 3).astype(np.float32)
    R = trot.aa_to_rotmat(torch.tensor(aa))
    got, want = _both(jrot.rotmat_to_rot6d, trot.rotmat_to_rot6d, R.numpy(),
                      rot6d_mode=mode)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    back = trot.rot6d_to_rotmat(torch.tensor(got), mode)
    np.testing.assert_allclose(back.numpy(), R.numpy(), atol=ATOL)


def test_aa_to_rotmat():
    aa = np.random.RandomState(3).randn(64, 3).astype(np.float32)
    got, want = _both(jrot.aa_to_rotmat, trot.aa_to_rotmat, aa)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("with_rotation", [False, True])
def test_perspective_projection(with_rotation):
    """Pixel coordinates are O(100-1000) at focal 1500, where one f32 ulp is
    up to 6e-5: an absolute 1e-5 asks for more than f32 holds, and the
    result then hangs on the host's summation order. The bar is relative,
    rtol 2e-6 (under two dozen ulps), with atol 1e-5 for coordinates near
    0. A dropped rotation or a swapped focal/centre moves points by tens of
    pixels, a relative error of 1e-2 or more."""
    rng = np.random.RandomState(4)
    pts = rng.randn(3, 45, 3).astype(np.float32)
    transl = (rng.randn(3, 3) * 0.2 + [0, 0, 5]).astype(np.float32)
    fl = np.full((3, 2), 1500.0, np.float32)
    cc = rng.rand(3, 2).astype(np.float32) * 100
    args = [pts, transl, fl, cc]
    if with_rotation:
        args.append(trot.aa_to_rotmat(torch.tensor(rng.randn(3, 3).astype(np.float32))).numpy())
    got, want = _both(jproj.perspective_projection, tproj.perspective_projection, *args)
    assert np.abs(want).max() > 100  # the magnitudes the bar is set for
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=2e-6)


def _rotations(seed, n=64):
    """Random rotations plus the hard cases of `rotmat_to_quat`'s branches:
    the identity, rotations within 1e-3 rad of it, exact and near 180-degree
    turns about each axis (trace = -1: the three diagonal branches) and
    about random axes."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    axes = rng.randn(12, 3)
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    rotvecs = np.concatenate([
        Rotation.random(n, random_state=seed).as_rotvec(),
        np.zeros((1, 3)), 1e-3 * rng.randn(6, 3), 1e-7 * rng.randn(3, 3),
        np.pi * np.eye(3), (np.pi - 1e-3) * np.eye(3),
        np.pi * axes[:6], (np.pi - 1e-2) * axes[6:]])
    return Rotation.from_rotvec(rotvecs).as_matrix().astype(np.float32), rotvecs


def test_quat_to_rotmat():
    q = np.random.RandomState(2).randn(50, 4).astype(np.float32)  # not normalised
    got, want = _both(jrot.quat_to_rotmat, trot.quat_to_rotmat, q)
    assert got.shape == (50, 3, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_rotmat_to_quat_every_branch():
    """Quaternions agree with JAX up to overall sign (here: to the sign
    itself, since both take the same branch), and rebuild the matrix."""
    R, _ = _rotations(3)
    got, want = _both(jrot.rotmat_to_quat, trot.rotmat_to_quat, R)
    trace = np.trace(R, axis1=-2, axis2=-1)
    d = np.diagonal(R, axis1=-2, axis2=-1)
    # all four branches are taken by these inputs
    assert (trace > 0).any() and all(
        ((trace <= 0) & (d.argmax(-1) == k)).any() for k in range(3))
    sign = np.sign(np.sum(got * want, axis=-1, keepdims=True))
    np.testing.assert_allclose(got * sign, want, atol=ATOL, rtol=0)
    back = trot.quat_to_rotmat(torch.tensor(got)).numpy()
    np.testing.assert_allclose(back, R, atol=2e-5, rtol=0)


def test_quat_to_aa():
    rng = np.random.RandomState(4)
    q = rng.randn(40, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0] = [1, 0, 0, 0]                      # no rotation: the k = 2 branch
    q[1] = [1, 1e-8, 0, 0]                   # below the sin^2 threshold
    q[2] = [-0.5, 0.5, 0.5, 0.5]             # w < 0: the other atan2 branch
    got, want = _both(jrot.quat_to_aa, trot.quat_to_aa, q)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert (got[0] == 0).all()


def test_rotmat_to_aa_also_near_identity_and_at_180_degrees():
    """Against JAX everywhere (atol 1e-5), and against the true rotation
    vector up to the sign of the axis at 180 degrees, where +axis and -axis
    are the same rotation. The bar against the truth is looser near a half
    turn: the quaternion's w is the f32 sum 1 + trace there, and the angle
    2 atan2(|xyz|, w) carries its rounding."""
    R, rotvecs = _rotations(5)
    got, want = _both(jrot.rotmat_to_aa, trot.rotmat_to_aa, R)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    angle = np.linalg.norm(rotvecs, axis=-1)
    flip = np.where(np.sum(got * rotvecs, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    flip = np.where((angle > np.pi - 2e-2)[:, None], flip, 1.0)
    np.testing.assert_allclose(got * flip, rotvecs, atol=2e-3, rtol=0)
    small = angle < 0.5
    np.testing.assert_allclose(got[small], rotvecs[small], atol=1e-6, rtol=1e-5)
    # and back to the same matrix, whatever the axis's sign
    back = trot.aa_to_rotmat(torch.tensor(got)).numpy()
    np.testing.assert_allclose(back, R, atol=2e-3, rtol=0)


def test_convert_pare_to_full_img_cam():
    rng = np.random.RandomState(6)
    B = 9
    cam = np.concatenate([0.5 + rng.rand(B, 1), rng.randn(B, 2) * 0.1], -1).astype(np.float32)
    h = (150 + 200 * rng.rand(B)).astype(np.float32)
    center = (rng.rand(B, 2) * [1920, 1080]).astype(np.float32)
    w_img, h_img = np.full(B, 1920.0, np.float32), np.full(B, 1080.0, np.float32)
    f = np.full(B, 1500.0, np.float32)
    got, want = _both(jproj.convert_pare_to_full_img_cam, tproj.convert_pare_to_full_img_cam,
                      cam, h, center, w_img, h_img, f)
    assert got.shape == (B, 3)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=ATOL)
    got2, want2 = _both(jproj.convert_pare_to_full_img_cam, tproj.convert_pare_to_full_img_cam,
                        cam, h, center, w_img, h_img, f, crop_res=256)
    np.testing.assert_allclose(got2, want2, rtol=2e-6, atol=ATOL)


@pytest.mark.parametrize("batched", [False, True])
def test_points_coord_trans(batched):
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(7)
    lead = (4,) if batched else ()
    pts = rng.randn(*lead, 100, 3).astype(np.float32)
    T = np.zeros(lead + (4, 4), np.float32)
    T[..., :3, :3] = Rotation.random(4 if batched else 1, random_state=8).as_matrix().reshape(
        lead + (3, 3))
    T[..., :3, 3] = rng.randn(*lead, 3)
    T[..., 3, 3] = 1.0
    got, want = _both(jproj.points_coord_trans, tproj.points_coord_trans, pts, T)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
