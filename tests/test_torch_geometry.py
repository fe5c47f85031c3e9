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
