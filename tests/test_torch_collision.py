"""Port parity: collision/ (the SDF stack and kernel K2's plain version)
and the SMPL functions guidance needs, against egohmr_tpu on the CPU.

The JAX side runs its plain XLA path (`use_pallas=False`), or the Pallas
nearest-vertex kernel in interpret mode where a test says so. Inputs come
from a numpy seed and cross as copies. Each test states its tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental.pallas import tpu as pltpu

from egohmr_tpu import collision as jcol
from egohmr_tpu.collision import sdf as jsdf
from egohmr_tpu.collision.knn_pallas import nearest_vertex_idx_pallas
from egohmr_tpu.smpl import lbs as j_lbs
from egohmr_tpu.smpl import make_synthetic_model as j_make_smpl
from egohmr_tpu.smpl import vertex_normals as j_vertex_normals
from egohmr_tpu.smpl.model import lbs_apply_select as j_lbs_apply_select
from egohmr_tpu.smpl.model import lbs_transforms as j_lbs_transforms
from egohmr_tpu_torch import collision as tcol
from egohmr_tpu_torch.collision import knn as k2
from egohmr_tpu_torch.collision import sdf as tsdf
from egohmr_tpu_torch.geometry import aa_to_rotmat
from egohmr_tpu_torch.smpl import (
    lbs,
    lbs_apply_select,
    lbs_transforms,
    make_synthetic_model,
    vertex_normals,
)

from .test_collision import _uv_sphere

T = lambda a: torch.tensor(np.array(a))  # noqa: E731  (always a copy)
J = lambda a: jnp.asarray(np.array(a))   # noqa: E731
N = lambda a: np.array(a.detach() if isinstance(a, torch.Tensor) else a)  # noqa: E731


def _clouds(seed, B=2, P=700, V=431):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, P, 3).astype(np.float32),
            rng.randn(B, V, 3).astype(np.float32))


def _body(seed, B=2, V=256, shift=(0.0, 0.0, 0.0), pose_scale=0.1):
    """A posed synthetic body from both packages' own SMPL code, as numpy:
    (verts, normals, faces)."""
    rng = np.random.RandomState(seed)
    betas = (rng.randn(B, 10) * 0.3).astype(np.float32)
    aa = (rng.randn(B, 24, 3) * pose_scale).astype(np.float32)
    smpl = j_make_smpl(num_vertices=V)
    out = j_lbs(smpl, J(betas), J(aa[:, 0]), J(aa[:, 1:].reshape(B, 69)))
    verts = np.asarray(out.vertices) + np.asarray(shift, np.float32)
    normals = np.asarray(j_vertex_normals(J(verts), smpl.faces))
    return verts, normals, np.asarray(smpl.faces)


def test_public_names_match_jax():
    """The JAX package's `__all__` plus the two top-K pre-filters."""
    assert set(tcol.__all__) == set(jcol.__all__) | {
        "topk_scene_points", "topk_scene_points_near_body"}
    assert all(hasattr(tcol, n) for n in tcol.__all__)


def test_plain_version_matches_pallas_interpret_mode():
    """K2's plain version against the Pallas kernel itself, run in
    interpret mode (this JAX build can): indices equal on generic inputs.
    P and V are ragged against the kernel's 512-point blocks and 128-vertex
    padding."""
    pts, verts = _clouds(0)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(nearest_vertex_idx_pallas(J(pts), J(verts), block_p=512))
    got = k2.nearest_vertex_idx_reference(T(pts), T(verts), block_size=256)
    assert got.dtype == torch.int64 and got.shape == (2, 700)
    np.testing.assert_array_equal(N(got), want)
    # and against brute force
    d = np.linalg.norm(pts[:, :, None] - verts[:, None], axis=-1)
    np.testing.assert_array_equal(N(got), d.argmin(-1))


def test_plain_version_ties_go_to_the_lowest_index():
    """Duplicated vertices tie exactly; `argmin` takes the first."""
    pts, half = _clouds(1, P=200, V=50)
    verts = np.concatenate([half, half], axis=1)
    got = N(k2.nearest_vertex_idx_reference(T(pts), T(verts)))
    want = np.asarray(jsdf.nearest_vertex(J(pts), J(verts), use_pallas=False).idx)
    assert got.max() < 50
    np.testing.assert_array_equal(got, want)


def test_cpu_wrapper_uses_plain_version_and_counts_nothing():
    """A CPU tensor takes the plain version and the launch count stays; a
    device that is neither CPU nor CUDA, and malformed shapes, are refused."""
    pts, verts = (T(a) for a in _clouds(2, P=64, V=33))
    before = k2.launches
    torch.testing.assert_close(k2.nearest_vertex_idx(pts, verts),
                               k2.nearest_vertex_idx_reference(pts, verts),
                               rtol=0, atol=0)
    assert k2.launches == before
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k2.nearest_vertex_idx(pts.to("meta"), verts.to("meta"))
    with pytest.raises(ValueError, match="expected"):
        k2.nearest_vertex_idx(pts, verts[:1])
    with pytest.raises(ValueError, match="expected"):
        k2.nearest_vertex_idx(pts[..., :2], verts)


# the shapes the main paths give K2 (guided DDIM-5 and DDPM-50, the metric and
# cloud searches at 16 clouds and at 8 images x 5 samples) and a ragged one
K2_SHAPES = [(64, 1024, 6890), (16, 1024, 6890), (16, 20000, 6890), (16, 6890, 20000),
             (40, 20000, 6890), (40, 6890, 20000), (3, 777, 431), (1, 5, 7)]


def _assert_plan_covers(B, P, V, n_sm):
    """Every point in exactly one point block, every vertex in exactly one
    range; ranges are whole min blocks; V is split only to fill the card."""
    plan = k2.launch_plan(B, P, V, n_sm)
    blocks, split_len, splits = plan["point_blocks"], plan["split_len"], plan["splits"]
    assert (blocks - 1) * k2.BLOCK_POINTS < P <= blocks * k2.BLOCK_POINTS
    assert split_len % k2.BLOCK_VERTICES == 0 and 1 <= splits <= 65535
    ranges = [(z * split_len, min(V, (z + 1) * split_len)) for z in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == V
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    if splits > 1:
        assert split_len >= k2.MIN_SPLIT
        assert B * blocks * (splits - 1) < k2.CTAS_PER_SM * n_sm
    return plan


@pytest.mark.parametrize("B,P,V", K2_SHAPES)
def test_launch_plan_covers_the_main_path_shapes(B, P, V):
    plan = _assert_plan_covers(B, P, V, 132)
    # the guided shapes leave the card empty without a V split; the B.S=40
    # metric shape fills it almost by its points alone
    if (P, V) == (1024, 6890):
        assert plan["splits"] == 4
    if (B, P, V) == (40, 20000, 6890):
        assert plan["splits"] == 2
    if V < k2.MIN_SPLIT:
        assert plan["splits"] == 1


@settings(max_examples=300, deadline=None, database=None)
@given(B=st.integers(1, 300), P=st.integers(1, 70000), V=st.integers(1, 70000),
       n_sm=st.integers(1, 200))
def test_launch_plan_covers_every_point_and_vertex_once(B, P, V, n_sm):
    _assert_plan_covers(B, P, V, n_sm)


def test_launch_plan_refuses_empty_sizes():
    for bad in [(0, 5, 5, 132), (1, 0, 5, 132), (1, 5, 0, 132), (1, 5, 5, 0)]:
        with pytest.raises(ValueError, match="positive"):
            k2.launch_plan(*bad)


def _k2_scheme(pts, verts, plan):
    """The kernel's search, step by step in PyTorch, on the plain version's
    own distances: per V range, the min of each block of BLOCK_VERTICES
    vertices; the first block whose min beats the best so far (strict <);
    inside it the lowest vertex that attains the min; then over the ranges
    the lexicographically least (distance, range). The kernel's f32 chain and
    its near-tie pass are a matter of rounding and are held on the card."""
    v_sq = torch.sum(verts * verts, dim=-1)[:, None, :]
    dist = v_sq - 2.0 * torch.matmul(pts, verts.transpose(1, 2))  # [B, P, V]
    B, P, V = dist.shape
    blk, inf = k2.BLOCK_VERTICES, float("inf")
    best_d = torch.full((B, P), inf)
    best_i = torch.zeros((B, P), dtype=torch.int64)
    for z in range(plan["splits"]):
        lo, hi = z * plan["split_len"], min(V, (z + 1) * plan["split_len"])
        d = torch.nn.functional.pad(dist[..., lo:hi], (0, -(hi - lo) % blk), value=inf)
        block_min = d.reshape(B, P, -1, blk).amin(-1)
        run_d = torch.full((B, P), inf)
        run_blk = torch.zeros((B, P), dtype=torch.int64)
        for j in range(block_min.shape[-1]):  # blocks ascending, strict <
            better = block_min[..., j] < run_d
            run_d = torch.where(better, block_min[..., j], run_d)
            run_blk = torch.where(better, torch.full_like(run_blk, j), run_blk)
        inside = torch.gather(d.reshape(B, P, -1, blk), 2,
                              run_blk[..., None, None].expand(B, P, 1, blk))[:, :, 0]
        hit = inside == run_d[..., None]
        first = torch.where(hit, torch.arange(blk), blk).amin(-1)  # the lowest that attains it
        assert int(first.max()) < blk
        better = run_d < best_d  # ranges ascending, strict <
        best_d = torch.where(better, run_d, best_d)
        best_i = torch.where(better, lo + run_blk * blk + first, best_i)
    return best_i


@pytest.mark.parametrize("ties", ["none", "inside a block", "across blocks", "across splits"])
def test_kernel_scheme_gives_the_plain_versions_indices(ties):
    """Block min, one rescan, split V and the lexicographic combine pick
    what `argmin` picks, also where exact ties are planted: a vertex and its
    copy in one block, in two blocks of one range, in two ranges."""
    rng = np.random.RandomState(3)
    B, P, V = 2, 300, 4000
    verts = (rng.randn(B, V, 3) * [0.25, 0.5, 0.15]).astype(np.float32)
    plan = k2.launch_plan(B, P, V, 132)
    blk, split_len = k2.BLOCK_VERTICES, plan["split_len"]
    assert plan["splits"] == 2 and split_len % blk == 0
    src = np.arange(0, split_len - 8 * blk, blk)  # first vertex of a block, in the first range
    dst = {"none": None, "inside a block": src + 5, "across blocks": src + blk * 7 + 3,
           "across splits": src + split_len + 11}[ties]
    if dst is not None:
        verts[:, dst] = verts[:, src]
    pts = verts[:, rng.randint(V, size=P)] + 0.05 * rng.randn(B, P, 3).astype(np.float32)
    if dst is not None:  # points whose nearest vertex is a planted pair
        pts[:, :len(src)] = verts[:, src] + 1e-3 * rng.randn(B, len(src), 3).astype(np.float32)
    want = k2.nearest_vertex_idx_reference(T(pts), T(verts))
    got = _k2_scheme(T(pts), T(verts), plan)
    np.testing.assert_array_equal(N(got), N(want))
    if dst is not None:
        hits = N(want)[:, :len(src)]
        assert np.isin(hits, src).mean() > 0.9 and not np.isin(hits, dst).any()


@pytest.mark.parametrize("P,V,block_size", [(700, 431, 256), (700, 431, 2048),
                                            (300, 9000, 128)])
def test_nearest_vertex_matches_jax(P, V, block_size):
    """A body-sized and a cloud-sized V (over the JAX kernel's 8192-vertex
    limit, where JAX takes its plain path; the port has one route per
    device whatever V), and blocks smaller and larger than P. Indices exact. The port always recomputes the distance from the
    gathered vertex, as the JAX kernel path does: against that path
    (interpret mode) rtol 1e-5. The JAX plain path takes the distance from
    |v|^2 - 2 p.v + |p|^2, which cancels: against it rtol 1e-3, atol 1e-5
    (they differ by up to 2e-4 relative on these inputs)."""
    pts, verts = _clouds(3, P=P, V=V)
    got = tsdf.nearest_vertex(T(pts), T(verts), block_size=block_size)
    plain = jsdf.nearest_vertex(J(pts), J(verts), block_size=256, use_pallas=False)
    np.testing.assert_array_equal(N(got.idx), np.asarray(plain.idx))
    np.testing.assert_allclose(N(got.dist), np.asarray(plain.dist), rtol=1e-3, atol=1e-5)
    if V <= 8192:
        with pltpu.force_tpu_interpret_mode():
            kern = jsdf.nearest_vertex(J(pts), J(verts), use_pallas=True)
        np.testing.assert_array_equal(N(got.idx), np.asarray(kern.idx))
        np.testing.assert_allclose(N(got.dist), np.asarray(kern.dist), rtol=1e-5, atol=0)


def test_nearest_vertex_gradient_flows_through_the_gather():
    """d dist / d verts and d points against jax.grad of the JAX kernel
    path's formula (the norm of p - v_idx): rtol 1e-5, atol 1e-6."""
    pts, verts = _clouds(4, P=50, V=20)
    p, v = T(pts).requires_grad_(), T(verts).requires_grad_()
    tsdf.nearest_vertex(p, v).dist.sum().backward()
    idx = jsdf.nearest_vertex(J(pts), J(verts), use_pallas=False).idx

    def total(p_, v_):
        near = jnp.take_along_axis(v_, idx[..., None], axis=1)
        return jnp.sum(jnp.linalg.norm(p_ - near, axis=-1))

    gp, gv = jax.grad(total, argnums=(0, 1))(J(pts), J(verts))
    np.testing.assert_allclose(N(p.grad), np.asarray(gp), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(N(v.grad), np.asarray(gv), rtol=1e-5, atol=1e-6)


def test_nearest_k_vertices_matches_jax():
    """Indices exact (ascending, ties to the lowest index); squared
    distances rtol 1e-5, atol 1e-6 (the same formula on both sides)."""
    pts, verts = _clouds(5, P=100, V=57)
    d2, idx = tsdf.nearest_k_vertices(T(pts), T(verts), 5, block_size=32)
    jd2, jidx = jsdf.nearest_k_vertices(J(pts), J(verts), 5, block_size=32)
    np.testing.assert_array_equal(N(idx), np.asarray(jidx))
    np.testing.assert_allclose(N(d2), np.asarray(jd2), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sign_k", [1, 4])
def test_signed_distance_matches_jax(sign_k):
    """Signs exact, magnitudes rtol 1e-3/atol 1e-5 against the JAX plain
    path (its distance formula cancels, see test_nearest_vertex_matches_jax)
    on a posed body and points around it."""
    verts, normals, _ = _body(6)
    rng = np.random.RandomState(6)
    pts = (rng.randn(2, 600, 3) * 0.4).astype(np.float32)
    got = N(tsdf.signed_distance(T(pts), T(verts), T(normals), block_size=128,
                                 sign_k=sign_k))
    want = np.asarray(jsdf.signed_distance(J(pts), J(verts), J(normals),
                                           block_size=128, sign_k=sign_k))
    assert (got < 0).any() and (got > 0).any()
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


def test_signed_distance_zero_sign_is_positive():
    """A point whose offset is orthogonal to the nearest normal has sign 0,
    which counts as outside (+1) in both packages."""
    verts = np.array([[[0, 0, 0], [5, 5, 5]]], np.float32)
    normals = np.array([[[0, 0, 1], [0, 0, 1]]], np.float32)
    pts = np.array([[[0.5, 0, 0]]], np.float32)
    got = N(tsdf.signed_distance(T(pts), T(verts), T(normals)))
    want = np.asarray(jsdf.signed_distance(J(pts), J(verts), J(normals)))
    np.testing.assert_allclose(got, [[0.5]], rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_winding_number_and_signed_distance_winding_match_jax():
    """The thin-slab case of tests/test_collision.py: winding numbers rtol
    1e-4, atol 1e-5 (sums of ~2000 arctangents in another order), the
    inside test exact, the signed distance rtol 1e-3, atol 1e-5."""
    verts, faces = _uv_sphere()
    thin = (verts * np.array([1.0, 1.0, 0.02], np.float32))[None]
    rng = np.random.RandomState(0)
    pts = rng.uniform(-1.2, 1.2, size=(400, 3)).astype(np.float32)
    pts[:, 2] *= 0.05
    ellip = pts[:, 0] ** 2 + pts[:, 1] ** 2 + (pts[:, 2] / 0.02) ** 2
    pts = pts[np.abs(ellip - 1.0) > 0.15][None]
    w = N(tsdf.winding_number(T(pts), T(thin), T(faces), block_size=256))
    jw = np.asarray(jsdf.winding_number(J(pts), J(thin), J(faces), block_size=256))
    np.testing.assert_allclose(w, jw, rtol=1e-4, atol=1e-5)
    assert (np.abs(w) > 0.5).any() and (np.abs(w) < 0.5).any()
    s = N(tsdf.signed_distance_winding(T(pts), T(thin), T(faces)))
    js = np.asarray(jsdf.signed_distance_winding(J(pts), J(thin), J(faces)))
    np.testing.assert_array_equal(s < 0, js < 0)
    np.testing.assert_allclose(s, js, rtol=1e-3, atol=1e-5)


def test_bbox_mask_loss_and_ratio_match_jax():
    """bbox_mask exact; collision_loss (masked and not) and collision_ratio
    rtol 1e-6 on the same sdf values."""
    verts, _, _ = _body(7)
    rng = np.random.RandomState(7)
    pts = (rng.randn(2, 500, 3) * 0.5).astype(np.float32)
    sdf = (rng.randn(2, 500) * 0.1).astype(np.float32)
    for margin in (0.0, 0.05):
        m = N(tsdf.bbox_mask(T(pts), T(verts), margin))
        np.testing.assert_array_equal(m, np.asarray(jsdf.bbox_mask(J(pts), J(verts), margin)))
    assert m.any() and not m.all()
    mf = m.astype(np.float32)
    for mask in (None, mf):
        tm, jm = (None, None) if mask is None else (T(mask), J(mask))
        np.testing.assert_allclose(N(tsdf.collision_loss(T(sdf), tm)),
                                   np.asarray(jsdf.collision_loss(J(sdf), jm)), rtol=1e-6)
        np.testing.assert_allclose(N(tsdf.collision_ratio(T(sdf), tm)),
                                   np.asarray(jsdf.collision_ratio(J(sdf), jm)), rtol=1e-6)


def test_chamfer_and_min_distance_match_jax():
    """Both directions of the squared chamfer distance and the body-scene
    minimum: rtol 1e-3, atol 1e-5 against the JAX plain path, and rtol 1e-5
    against brute force."""
    x, y = _clouds(8, B=1, P=50, V=80)
    cx, cy = tsdf.chamfer_distance(T(x), T(y), block_size=16)
    jcx, jcy = jsdf.chamfer_distance(J(x), J(y), block_size=16)
    np.testing.assert_allclose(N(cx), np.asarray(jcx), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(N(cy), np.asarray(jcy), rtol=1e-3, atol=1e-5)
    d = np.linalg.norm(x[0][:, None] - y[0][None], axis=-1)
    np.testing.assert_allclose(N(cx)[0], d.min(1) ** 2, rtol=1e-5)
    np.testing.assert_allclose(N(cy)[0], d.min(0) ** 2, rtol=1e-5)
    got = N(tsdf.min_body_scene_distance(T(x), T(y) + 10, block_size=16))
    want = np.asarray(jsdf.min_body_scene_distance(J(x), J(y) + 10, block_size=16))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


# ------------------------------------------------- top-K and its tie-breaks
def _loss_both(scene, verts, normals):
    """collision loss of a (possibly capped) cloud, (port, JAX)."""
    t = tsdf.collision_loss(
        tsdf.signed_distance(T(scene[0]), T(verts), T(normals)),
        tsdf.bbox_mask(T(scene[0]), T(verts)).float())
    j = jsdf.collision_loss(
        jsdf.signed_distance(J(scene[1]), J(verts), J(normals)),
        jsdf.bbox_mask(J(scene[1]), J(verts)).astype(jnp.float32))
    return N(t), np.asarray(j)


def _scene_origin_cap():
    """500 points near the body among 5500 far ones, shuffled: the origin
    cap to 2000 keeps every point within reach."""
    verts, normals, _ = _body(10)
    rng = np.random.RandomState(10)
    scene = np.concatenate([rng.randn(2, 500, 3) * 0.4,
                            rng.randn(2, 5500, 3) * 0.3 + 5.0], axis=1).astype(np.float32)
    return scene[:, rng.permutation(6000)], verts, normals, 2000, "origin"


def _scene_dense_crop():
    """A dense cube of 5500 points around the origin and 500 around a body
    displaced by 0.9 m: only the bbox-ranked cap keeps the scoring points."""
    verts, normals, _ = _body(11, shift=(0.9, 0.0, 0.0))
    rng = np.random.RandomState(11)
    scene = np.concatenate([(rng.rand(2, 5500, 3) - 0.5) * 1.6,
                            rng.randn(2, 500, 3) * 0.25 + [0.9, 0.0, 0.0]],
                           axis=1).astype(np.float32)
    return scene[:, rng.permutation(6000)], verts, normals, 2000, "body"


def _scene_adversarial_ties():
    """64 shell points just outside the bbox at the lowest indices, 8
    penetrating points at the highest, K=64: with margin 0 the in-bbox
    points strictly outrank the shell and survive the cap."""
    verts, normals, _ = _body(12, B=1, pose_scale=0.0)
    lo, hi = verts[0].min(0), verts[0].max(0)
    u = np.random.RandomState(12).rand(1, 64, 3).astype(np.float32)
    shell = np.concatenate([lo[0] - 0.01 + u[..., :1] * 0.005,
                            lo[1:] + u[..., 1:] * (hi[1:] - lo[1:])], axis=-1)
    inside = (lo + hi) / 2 + (u[:, :8] - 0.5) * 0.02
    scene = np.concatenate([shell, inside], axis=1).astype(np.float32)
    return scene, verts, normals, 64, "body"


@pytest.mark.parametrize("case", [_scene_origin_cap, _scene_dense_crop,
                                  _scene_adversarial_ties])
def test_topk_tie_break_cases_match_jax(case):
    """The three cap cases of tests/test_collision.py through both
    packages: the kept points equal index for index (so the stable sort
    breaks ties as `jax.lax.top_k` does), and the capped loss equals the
    uncapped one (rtol 1e-6, atol 1e-7) and JAX's (rtol 1e-4, atol 1e-8: the
    two plain paths take the distance from different formulas)."""
    scene, verts, normals, k, kind = case()
    if kind == "origin":
        capped_t = tsdf.topk_scene_points(T(scene), k)
        capped_j = jsdf.topk_scene_points(J(scene), k)
    else:
        capped_t = tsdf.topk_scene_points_near_body(T(scene), T(verts), k)
        capped_j = jsdf.topk_scene_points_near_body(J(scene), J(verts), k)
    assert capped_t.shape == (scene.shape[0], k, 3)
    np.testing.assert_array_equal(N(capped_t), np.asarray(capped_j))
    full_t, full_j = _loss_both((scene, scene), verts, normals)
    cap_t, cap_j = _loss_both((N(capped_t), np.asarray(capped_j)), verts, normals)
    assert full_t.max() > 0
    np.testing.assert_allclose(cap_t, full_t, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(cap_t, cap_j, rtol=1e-4, atol=1e-8)


def test_topk_many_exact_ties_keep_the_lowest_indices():
    """More in-bbox points (all at distance exactly 0) than K: both
    packages keep the K lowest-indexed ones, in index order; a None or
    oversize K is a no-op."""
    verts, _, _ = _body(13, B=1)
    lo, hi = verts[0].min(0), verts[0].max(0)
    rng = np.random.RandomState(13)
    inside = lo + rng.rand(1, 300, 3) * (hi - lo)
    scene = np.concatenate([rng.randn(1, 100, 3) + 4, inside], axis=1).astype(np.float32)
    got = N(tsdf.topk_scene_points_near_body(T(scene), T(verts), 128))
    want = np.asarray(jsdf.topk_scene_points_near_body(J(scene), J(verts), 128))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, scene[:, 100:228])
    assert tsdf.topk_scene_points(T(scene), None).shape[1] == 400
    assert tsdf.topk_scene_points_near_body(T(scene), T(verts), 400).shape[1] == 400


# ------------------------------------------------------- SMPL for guidance
@pytest.fixture(scope="module")
def smpl_pair():
    V = 200
    rng = np.random.RandomState(20)
    betas = (rng.randn(3, 10) * 0.5).astype(np.float32)
    aa = (rng.randn(3, 24, 3) * 0.4).astype(np.float32)
    rot = N(aa_to_rotmat(T(aa).reshape(-1, 3)).reshape(3, 24, 3, 3))
    idx = rng.randint(0, V, size=(3, 37))
    return j_make_smpl(num_vertices=V), make_synthetic_model(num_vertices=V), betas, rot, idx


def test_lbs_transforms_match_jax(smpl_pair):
    """All four outputs: rtol 1e-5, atol 1e-6."""
    jsmpl, tsmpl, betas, rot, _ = smpl_pair
    got = lbs_transforms(tsmpl, T(betas), T(rot))
    want = j_lbs_transforms(jsmpl, J(betas), J(rot))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(N(g), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_lbs_apply_select_matches_jax_and_full_gather(smpl_pair):
    """Equal to JAX's and to `lbs(...).vertices[b, idx[b]]` of the port
    (rtol 1e-5, atol 1e-6), duplicates included."""
    jsmpl, tsmpl, betas, rot, idx = smpl_pair
    idx = idx.copy()
    idx[:, 1] = idx[:, 0]
    _, pf, _, rel = lbs_transforms(tsmpl, T(betas), T(rot))
    got = N(lbs_apply_select(tsmpl, T(betas), pf, rel, T(idx)))
    _, jpf, _, jrel = j_lbs_transforms(jsmpl, J(betas), J(rot))
    want = np.asarray(j_lbs_apply_select(jsmpl, J(betas), jpf, jrel, J(idx), pose_chunk=16))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    full = N(lbs(tsmpl, T(betas), T(rot[:, :1]), T(rot[:, 1:]), pose2rot=False).vertices)
    np.testing.assert_allclose(got, np.take_along_axis(full, idx[..., None], axis=1),
                               rtol=1e-5, atol=1e-6)


def test_lbs_apply_select_gradient_matches_jax(smpl_pair):
    """d/d rot_mats and d/d betas of a weighted sum of the selected
    vertices, through `lbs_transforms` and `lbs_apply_select`, against
    jax.grad of the same: rtol 1e-4, atol 1e-6. The port's forward
    kinematics used in-place writes before guidance needed its gradient."""
    jsmpl, tsmpl, betas, rot, idx = smpl_pair
    w = np.random.RandomState(21).randn(3, 37, 3).astype(np.float32)

    def j_total(rot_, betas_):
        _, pf, _, rel = j_lbs_transforms(jsmpl, betas_, rot_)
        return jnp.sum(j_lbs_apply_select(jsmpl, betas_, pf, rel, J(idx)) * J(w))

    want_rot, want_betas = jax.grad(j_total, argnums=(0, 1))(J(rot), J(betas))
    r, b = T(rot).requires_grad_(), T(betas).requires_grad_()
    _, pf, _, rel = lbs_transforms(tsmpl, b, r)
    (lbs_apply_select(tsmpl, b, pf, rel, T(idx)) * T(w)).sum().backward()
    np.testing.assert_allclose(N(r.grad), np.asarray(want_rot), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(N(b.grad), np.asarray(want_betas), rtol=1e-4, atol=1e-6)


def test_full_lbs_gradient_matches_jax(smpl_pair):
    """The full skinning is differentiable too (joints and vertices):
    rtol 1e-4, atol 1e-5 against jax.grad."""
    jsmpl, tsmpl, betas, rot, _ = smpl_pair
    rng = np.random.RandomState(22)
    wv, wj = rng.randn(3, 200, 3).astype(np.float32), rng.randn(3, 45, 3).astype(np.float32)

    def j_total(rot_):
        out = j_lbs(jsmpl, J(betas), rot_[:, :1], rot_[:, 1:], pose2rot=False)
        return jnp.sum(out.vertices * J(wv)) + jnp.sum(out.joints * J(wj))

    r = T(rot).requires_grad_()
    out = lbs(tsmpl, T(betas), r[:, :1], r[:, 1:], pose2rot=False)
    ((out.vertices * T(wv)).sum() + (out.joints * T(wj)).sum()).backward()
    np.testing.assert_allclose(N(r.grad), np.asarray(jax.grad(j_total)(J(rot))),
                               rtol=1e-4, atol=1e-5)


def test_vertex_normals_match_jax(smpl_pair):
    """Unit normals against JAX's incidence-table gather: rtol 1e-4, atol
    1e-5 (`index_add` sums the faces of a vertex in another order); a
    vertex that no face touches gets the zero normal (the 1e-12 clamp), not
    NaN."""
    jsmpl, tsmpl, betas, rot, _ = smpl_pair
    verts = N(lbs(tsmpl, T(betas), T(rot[:, :1]), T(rot[:, 1:]), pose2rot=False).vertices)
    got = N(vertex_normals(T(verts), tsmpl.faces))
    want = np.asarray(j_vertex_normals(J(verts), jsmpl.faces))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    lone = np.concatenate([verts, np.ones((3, 1, 3), np.float32)], axis=1)
    got = N(vertex_normals(T(lone), tsmpl.faces))
    want = np.asarray(j_vertex_normals(J(lone), jsmpl.faces))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[:, -1], 0.0)
    np.testing.assert_array_equal(want[:, -1], 0.0)
