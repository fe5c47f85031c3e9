"""Port parity of eval/metrics.py: every function against egohmr_tpu on the
same seeded NumPy inputs, f32, rtol 1e-4 / atol 1e-6 unless a test says
otherwise. SVD signs may differ between the libraries, so only aligned
points and errors are compared, never U, s, V."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egohmr_tpu.eval import metrics as jm
from egohmr_tpu_torch.eval import metrics as tm

TOL = dict(rtol=1e-4, atol=1e-6)


def _t(a):
    return torch.tensor(np.array(a))


def _pair(seed, shape=(3, 4, 24, 3)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32) * 0.3,
            rng.randn(*shape).astype(np.float32) * 0.3)


def _mask(seed, shape):
    return (np.random.RandomState(seed).rand(*shape) > 0.4).astype(np.float32)


def _check(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("shape", [(24, 3), (5, 24, 3), (3, 4, 24, 3)])
def test_similarity_transform(shape):
    a, b = _pair(0, shape)
    got = tm.similarity_transform(_t(a), _t(b))
    _check(got, jm.similarity_transform(jnp.asarray(a), jnp.asarray(b)), rtol=1e-4, atol=1e-5)


def test_similarity_transform_recovers_a_similarity():
    """S2 = s R S1 + t is recovered exactly (a proper rotation)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(1)
    a = rng.randn(6, 24, 3).astype(np.float32)
    R = Rotation.random(6, random_state=2).as_matrix().astype(np.float32)
    b = 1.7 * np.einsum("bij,bnj->bni", R, a) + rng.randn(6, 1, 3).astype(np.float32)
    got = tm.similarity_transform(_t(a), _t(b))
    np.testing.assert_allclose(got.numpy(), b, rtol=1e-4, atol=1e-4)


def test_similarity_transform_reflected_pair_takes_the_det_branch():
    """A mirrored target: det(V U^T) < 0, so the last singular direction is
    flipped and the fit stays a rotation. Same aligned points as JAX."""
    a, _ = _pair(3, (4, 24, 3))
    b = a * np.array([-1.0, 1.0, 1.0], np.float32) + 0.01 * _pair(4, (4, 24, 3))[0]
    X1 = a - a.mean(-2, keepdims=True)
    X2 = b - b.mean(-2, keepdims=True)
    U, _, Vh = np.linalg.svd(np.einsum("bni,bnj->bij", X1, X2))
    assert (np.linalg.det(np.einsum("bji,bkj->bik", Vh, U)) < 0).all()
    got = tm.similarity_transform(_t(a), _t(b))
    _check(got, jm.similarity_transform(jnp.asarray(a), jnp.asarray(b)), rtol=1e-4, atol=1e-5)
    # a rotation cannot undo the mirror: the residual stays large
    assert np.linalg.norm(got.numpy() - b, axis=-1).mean() > 0.05


def test_similarity_transform_vis_mask():
    a, b = _pair(5)
    vis = _mask(6, (3, 4, 24))
    got = tm.similarity_transform_vis_mask(_t(vis), _t(a), _t(b))
    want = jm.similarity_transform_vis_mask(jnp.asarray(vis), jnp.asarray(a), jnp.asarray(b))
    _check(got, want, rtol=1e-4, atol=1e-5)


def test_vis_masked_fit_with_no_visible_joint_is_nan_as_in_jax():
    """One image with no visible joint: the masked fit divides 0 by 0. The
    port returns NaN where JAX does (the whole aligned image), finite values
    elsewhere; the CLI gives such an image zero weight but still multiplies,
    so the two must agree on where the NaNs are."""
    a, b = _pair(7, (3, 24, 3))
    vis = _mask(8, (3, 24))
    vis[1] = 0.0
    got = tm.similarity_transform_vis_mask(_t(vis), _t(a), _t(b)).numpy()
    want = np.asarray(jm.similarity_transform_vis_mask(
        jnp.asarray(vis), jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]).all() and np.isfinite(got[[0, 2]]).all()
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], rtol=1e-4, atol=1e-5)
    e_got = tm.pa_mpjpe(_t(a), _t(b), vis_mask=_t(vis), mask=_t(vis)).numpy()
    e_want = np.asarray(jm.pa_mpjpe(jnp.asarray(a), jnp.asarray(b),
                                    vis_mask=jnp.asarray(vis), mask=jnp.asarray(vis)))
    assert np.array_equal(np.isnan(e_got), np.isnan(e_want)) and np.isnan(e_got[1])


@pytest.mark.parametrize("pelvis_align", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_mpjpe(pelvis_align, masked):
    a, b = _pair(9)
    m = _mask(10, (3, 4, 24)) if masked else None
    got = tm.mpjpe(_t(a), _t(b), pelvis_align=pelvis_align, mask=None if m is None else _t(m))
    want = jm.mpjpe(jnp.asarray(a), jnp.asarray(b), pelvis_align=pelvis_align,
                    mask=None if m is None else jnp.asarray(m))
    assert got.shape == (3, 4)
    _check(got, want)


@pytest.mark.parametrize("fit_masked", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_pa_mpjpe(fit_masked, masked):
    a, b = _pair(11)
    vis = _mask(12, (3, 4, 24))
    kw_t = dict(vis_mask=_t(vis) if fit_masked else None, mask=_t(vis) if masked else None)
    kw_j = dict(vis_mask=jnp.asarray(vis) if fit_masked else None,
                mask=jnp.asarray(vis) if masked else None)
    _check(tm.pa_mpjpe(_t(a), _t(b), **kw_t), jm.pa_mpjpe(jnp.asarray(a), jnp.asarray(b), **kw_j),
           rtol=1e-4, atol=1e-5)


def test_an_empty_error_mask_gives_zero():
    a, b = _pair(13, (2, 24, 3))
    zero = np.zeros((2, 24), np.float32)
    assert (tm.mpjpe(_t(a), _t(b), mask=_t(zero)) == 0).all()
    assert np.asarray(jm.mpjpe(jnp.asarray(a), jnp.asarray(b), mask=jnp.asarray(zero))).max() == 0


@pytest.mark.parametrize("masked", [False, True])
def test_v2v(masked):
    rng = np.random.RandomState(14)
    pv, gv = (rng.randn(2, 3, 200, 3).astype(np.float32) for _ in range(2))
    pp, gp = (rng.randn(2, 3, 3).astype(np.float32) for _ in range(2))
    m = _mask(15, (2, 3, 200)) if masked else None
    got = tm.v2v(_t(pv), _t(gv), _t(pp), _t(gp), mask=None if m is None else _t(m))
    want = jm.v2v(*(jnp.asarray(x) for x in (pv, gv, pp, gp)),
                  mask=None if m is None else jnp.asarray(m))
    _check(got, want)


def test_joint_visibility_mask_is_exact():
    rng = np.random.RandomState(16)
    j = rng.randn(4, 300, 3).astype(np.float32) * np.array([2.0, 1.2, 0.3], np.float32)
    j[..., 2] += 2.5
    j[0, 0] = [0.0, 0.0, 2.0]            # projects onto the camera centre
    j[0, 1] = [-960.0 / 750, 0.0, 2.0]   # u == 0: inside
    j[0, 2] = [960.0 / 750, 0.0, 2.0]    # u == img_w: outside
    f = np.full((4, 2), 1500.0, np.float32)
    c = np.tile(np.array([[960.0, 540.0]], np.float32), (4, 1))
    got = tm.joint_visibility_mask(_t(j), _t(f), _t(c))
    want = np.asarray(jm.joint_visibility_mask(jnp.asarray(j), jnp.asarray(f), jnp.asarray(c)))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert got[0, :3].tolist() == [True, True, False] and 0.1 < want.mean() < 0.9
    small = tm.joint_visibility_mask(_t(j), _t(f), _t(c), img_w=1000.0, img_h=600.0)
    assert np.array_equal(small.numpy(), np.asarray(jm.joint_visibility_mask(
        jnp.asarray(j), jnp.asarray(f), jnp.asarray(c), 1000.0, 600.0)))


@pytest.mark.parametrize("S", [1, 2, 5])
@pytest.mark.parametrize("masked", [False, True])
def test_diversity_std_and_apd(S, masked):
    """S = 1: the unbiased std is NaN in both packages and the APD is 0."""
    rng = np.random.RandomState(17)
    x = rng.randn(3, S, 24, 3).astype(np.float32)
    m = _mask(18, (3, 24)) if masked else None
    tmask, jmask = (None, None) if m is None else (_t(m), jnp.asarray(m))
    std = tm.diversity_std(_t(x), tmask).numpy()
    std_j = np.asarray(jm.diversity_std(jnp.asarray(x), jmask))
    if S == 1:
        assert np.isnan(std).all() and np.isnan(std_j).all()
    else:
        np.testing.assert_allclose(std, std_j, **TOL)
    apd = tm.apd(_t(x), tmask).numpy()
    np.testing.assert_allclose(apd, np.asarray(jm.apd(jnp.asarray(x), jmask)), **TOL)
    assert apd.shape == (3,) and (S > 1 or (apd == 0).all())
