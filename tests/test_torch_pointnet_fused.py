"""Port parity: the plain PointNet and kernel K1's plain version.

K1's plain version (`pointnet_fused_reference`, what a CPU tensor runs and
what the CUDA kernel is held to on the card) is compared with
egohmr_tpu's `pointnet_forward_fused` in Pallas interpret mode, the way
tests/test_pointnet_fused.py runs it, with random non-zero `fc_1`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from egohmr_tpu.nn.pointnet import init_pointnet
from egohmr_tpu.nn.pointnet import pointnet_forward as j_pointnet_forward
from egohmr_tpu.nn.pointnet_fused import pointnet_forward_fused as j_fused
from egohmr_tpu_torch import interop
from egohmr_tpu_torch.nn import cast_params_bf16
from egohmr_tpu_torch.nn import pointnet_fused as k1
from egohmr_tpu_torch.nn.pointnet import ResnetPointnet, pointnet_forward

from .test_pointnet_fused import _bf16_reference
from .torch_parity import randomize, to_jax, to_np


def _encoder(p) -> ResnetPointnet:
    arrays = {}
    interop._pointnet(arrays, "", p)
    enc = ResnetPointnet(512, 256)
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in arrays.items()}, strict=True)
    return enc.eval()


@pytest.fixture(scope="module")
def setup():
    """H=256 (the kernel's width), P=1800 points, random fc_1."""
    p = randomize({"scene_enc": init_pointnet(jax.random.PRNGKey(0), 512, 256)}, 0)
    p = p["scene_enc"]
    assert np.any(p["block_1"]["fc_1"]["w"])
    pts = np.random.RandomState(1).randn(2, 1800, 3).astype(np.float32)
    return p, _encoder(p), pts


def test_plain_version_matches_jax_emulation(setup):
    """Against tests/test_pointnet_fused.py's XLA emulation of the kernel's
    arithmetic, with random fc_1. Two bars, both must hold:

    - rtol 5e-3, atol 5e-5 on at least 97% of the elements. Not on all:
      XLA's and PyTorch's f32 matmuls sum in an order that depends on the
      host, a few bf16 activations then round the other way, and the flips
      carry through three pooled stages (ROADMAP.md, queue 3: the JAX
      kernel and its own emulation differ the same way).
    - two bf16 ulps of the largest feature, 2^-7 x max|ref|, on every
      element: the bar chip_smoke.py holds the CUDA kernel to.

    A wrong port misses both: a stage fed the wrong pool, a dropped ReLU or
    a shortcut left out changes most features by far more than 2^-7 of the
    largest."""
    p, enc, pts = setup
    want = np.asarray(_bf16_reference(to_jax(p), jnp.asarray(pts)))
    got = k1.pointnet_forward_fused(enc, torch.tensor(pts))
    assert got.dtype == torch.float32 and got.shape == (2, 512)
    err = np.abs(to_np(got) - want)
    assert np.mean(err <= 5e-5 + 5e-3 * np.abs(want)) >= 0.97
    assert err.max() <= 2.0 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("fc_1", ["zero", "random"])
def test_plain_version_matches_jax_interpret_mode(setup, fc_1):
    """Against the Pallas kernel in interpret mode.

    With zero fc_1 (the JAX init) the bar is rtol 5e-3, atol 5e-5, as in
    tests/test_pointnet_fused.py. With random fc_1 that bar does not hold
    even for the JAX package's own emulation (39 of 1024 elements past it,
    max abs 4.3e-4): the chunked kernel sums in another order, a few bf16
    activations round the other way, and the flips carry through three
    pooled stages. There the bar is two bf16 ulps of the largest feature,
    the one chip_smoke.py holds the CUDA kernel to, and the port must be no
    farther from the kernel than the JAX emulation is."""
    p, enc, pts = setup
    if fc_1 == "zero":
        p = {k: dict(v) for k, v in p.items()}
        for i in range(4):
            p[f"block_{i}"] = {**p[f"block_{i}"], "fc_1": {
                "w": np.zeros_like(p[f"block_{i}"]["fc_1"]["w"]),
                "b": p[f"block_{i}"]["fc_1"]["b"]}}
        enc = _encoder(p)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_fused(to_jax(p), jnp.asarray(pts), chunk=512))
    got = to_np(k1.pointnet_forward_fused(enc, torch.tensor(pts)))
    if fc_1 == "zero":
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-5)
    else:
        emul = np.asarray(_bf16_reference(to_jax(p), jnp.asarray(pts)))
        err = np.abs(got - want).max()
        assert err <= 2.0 ** -7 * np.abs(want).max()
        assert err <= 1.1 * np.abs(emul - want).max()


def test_plain_version_close_to_f32_pointnet(setup):
    """bf16 rounding against the f32 path: cosine > 0.999 and mean relative
    error < 0.05 (the fused path's documented envelope)."""
    _, enc, pts = setup
    ref = to_np(pointnet_forward(enc, torch.tensor(pts)))
    got = to_np(k1.pointnet_forward_fused(enc, torch.tensor(pts)))
    assert np.mean(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-2)) < 0.05
    cos = np.sum(got * ref, -1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert np.all(cos > 0.999)


def test_padded_tail_is_exact(setup):
    """Repeating the last point (the kernel's padding of a ragged tile) does
    not change the pooled feature."""
    _, enc, _ = setup
    pts = torch.tensor(np.random.RandomState(2).randn(1, 1000, 3).astype(np.float32))
    padded = torch.cat([pts, pts[:, -1:].expand(1, 24, 3)], dim=1)
    a = k1.pointnet_fused_feature(enc, pts)
    b = k1.pointnet_fused_feature(enc, padded)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cpu_wrapper_uses_plain_version_and_counts_nothing(setup):
    """A CPU tensor takes the plain version; the launch count is for the
    kernel only. Other devices are refused."""
    _, enc, pts = setup
    before = k1.launches
    x = torch.tensor(pts)
    torch.testing.assert_close(k1.pointnet_fused_feature(enc, x),
                               k1.pointnet_fused_reference(enc, x), rtol=0, atol=0)
    assert k1.launches == before
    with pytest.raises(ValueError):
        k1.pointnet_fused_feature(enc, x.to("meta"))


def test_weight_slices_are_swizzled_as_the_kernel_reads_them():
    """`_swizzle` cuts [H, K] into K-slices of 64 and puts the 16-byte chunk c
    (8 bf16) of row n at chunk c ^ (n % 8) of the row's 128 bytes; applying
    the same permutation again gives the matrix back."""
    w = torch.arange(256 * 128, dtype=torch.float32).reshape(256, 128).to(torch.bfloat16)
    s = k1._swizzle(w)
    assert s.shape == (2, 256, 64) and s.dtype == torch.bfloat16
    for slc, n, c in [(0, 0, 3), (0, 5, 0), (1, 13, 7), (1, 255, 2)]:
        want = w[n, slc * 64 + 8 * c: slc * 64 + 8 * c + 8]
        phys = c ^ (n % 8)
        assert torch.equal(s[slc, n, 8 * phys: 8 * phys + 8], want)
    assert torch.equal(k1._unswizzle(s), w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prepared_weights_round_trip(setup, dtype):
    """What the kernel reads (slices in the order a tile consumes them, the
    pooled halves transposed, fc_pos as float4 rows, f32 biases), unpacked
    into a model again, gives the plain version's feature bit for bit: from
    the f32 model and from its bf16 cast, which prepare the same weight
    bytes (the cast also rounds the biases, so its feature is its own)."""
    _, enc, pts = setup
    model = enc if dtype == torch.float32 else cast_params_bf16(enc)
    prep = k1.prepare_weights(model)
    assert [tuple(s.shape) for s in prep.slices] == [(20, 256, 64)] + [(12, 256, 64)] * 3
    assert all(s.dtype == torch.bfloat16 and s.is_contiguous() for s in prep.slices)
    assert prep.wpos.shape == (512, 4) and prep.wpos.dtype == torch.float32
    assert prep.wctx.shape == (3, 2, 256, 256) and prep.wctx.dtype == torch.bfloat16
    assert prep.b_hidden.shape == prep.b_out.shape == (4, 256)
    x = torch.tensor(pts)
    want = k1.pointnet_fused_reference(model, x)
    got = k1.pointnet_fused_reference(k1.unpack_weights(prep), x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, b in zip(prep.slices, k1.prepare_weights(enc).slices):
        assert torch.equal(a, b)


def test_weights_are_prepared_once_per_model_and_again_after_a_change(setup):
    """The cache holds while every parameter is the same storage and
    version; an in-place update, a load_state_dict and a cast prepare anew,
    and the new preparation carries the change."""
    p, _, pts = setup
    enc = _encoder(p)
    before = k1.preparations
    first = k1.prepared_weights(enc)
    assert k1.prepared_weights(enc) is first and k1.preparations == before + 1
    with torch.no_grad():
        enc.block_2.fc_1.weight.mul_(2.0)
    second = k1.prepared_weights(enc)
    assert second is not first and k1.preparations == before + 2
    assert not torch.equal(second.slices[2], first.slices[2])
    assert torch.equal(second.slices[1], first.slices[1])
    x = torch.tensor(pts)
    torch.testing.assert_close(k1.pointnet_fused_reference(k1.unpack_weights(second), x),
                               k1.pointnet_fused_reference(enc, x), rtol=0, atol=0)
    enc.load_state_dict(_encoder(p).state_dict())
    third = k1.prepared_weights(enc)
    assert k1.preparations == before + 3 and torch.equal(third.slices[2], first.slices[2])
    assert k1.prepared_weights(enc) is third and k1.preparations == before + 3
    k1.prepared_weights(cast_params_bf16(enc))  # another model: its own entry
    assert k1.preparations == before + 4 and k1.prepared_weights(enc) is third


@pytest.mark.parametrize("masked", [False, True])
def test_f32_pointnet_matches_jax(setup, masked):
    """The plain f32 ResnetPointnet, with and without a padding mask:
    rtol/atol 1e-4; a masked padded tail equals the unpadded cloud."""
    p, enc, pts = setup
    mask = None
    if masked:
        pts = np.concatenate([pts, np.full((2, 100, 3), 50.0, np.float32)], axis=1)
        mask = np.ones(pts.shape[:2], bool)
        mask[:, -100:] = False
    want = np.asarray(j_pointnet_forward(to_jax(p), jnp.asarray(pts),
                                         None if mask is None else jnp.asarray(mask)))
    got = to_np(pointnet_forward(enc, torch.tensor(pts),
                                 None if mask is None else torch.tensor(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if masked:
        plain = to_np(pointnet_forward(enc, torch.tensor(pts[:, :-100])))
        np.testing.assert_allclose(got, plain, rtol=1e-6, atol=1e-6)
