"""Kernels K1 and K2 on the card, each held to its plain version. Needs a
CUDA device and `nvcc`; skips without a card. Run on a GPU machine with
`python -m pytest --noconftest tests/test_torch_gpu.py -q` (the repo's
conftest imports JAX, which a GPU machine need not have)."""
import pytest
import torch

from egohmr_tpu_torch.collision import knn as k2
from egohmr_tpu_torch.collision import nearest_vertex
from egohmr_tpu_torch.models import init_random_
from egohmr_tpu_torch.nn import pointnet_fused as k1
from egohmr_tpu_torch.nn.pointnet import ResnetPointnet


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ with no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,P", [(2, 64), (3, 4099), (4, 20000)])
def test_k1_matches_plain_version(cuda, B, P):
    """Bar: two bf16 ulps of the largest pooled value (the tensor cores sum
    in another order than cuBLAS's f32 GEMM, and bf16 rounding flips carry
    through the pooled stages); every launch is counted."""
    enc = init_random_(ResnetPointnet(512, 256), seed=1).to(cuda).eval()
    pts = torch.randn(B, P, 3, generator=torch.Generator().manual_seed(P)).to(cuda)
    before = k1.launches
    got = k1.pointnet_fused_feature(enc, pts)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    ref = k1.pointnet_fused_reference(enc, pts)
    assert got.shape == (B, 256) and torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 2.0 ** -7 * ref.abs().max().item()
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1)
    assert cos.min().item() > 0.9999


@pytest.mark.gpu
def test_k1_rejects_what_it_does_not_take(cuda):
    enc = init_random_(ResnetPointnet(512, 128), seed=1).to(cuda)
    with pytest.raises(ValueError, match="hidden width"):
        k1.pointnet_fused_feature(enc, torch.randn(1, 10, 3, device=cuda))


def _points_near_body(B, P, V, seed, device):
    """A seeded body-sized vertex cloud and points scattered around it."""
    g = torch.Generator().manual_seed(seed)
    verts = torch.randn(B, V, 3, generator=g) * torch.tensor([0.25, 0.5, 0.15])
    near = verts[:, torch.randint(V, (P,), generator=g)]
    pts = near + 0.05 * torch.randn(B, P, 3, generator=g)
    return pts.to(device), verts.to(device)


def _assert_k2_agrees(pts, verts):
    """Indices equal; where the kernel's f32 order picks another vertex at
    a near-tie, the true distances agree to rtol 1e-5, atol 1e-6."""
    before = k2.launches
    got = k2.nearest_vertex_idx(pts, verts)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    ref = k2.nearest_vertex_idx_reference(pts, verts)
    assert got.shape == ref.shape and got.dtype == torch.int64
    assert int(got.min()) >= 0 and int(got.max()) < verts.shape[1]

    def dist(idx):
        v = torch.gather(verts, 1, idx[..., None].expand(-1, -1, 3))
        return torch.linalg.norm(pts - v, dim=-1)

    differ = got != ref
    torch.testing.assert_close(dist(got), dist(ref), rtol=1e-5, atol=1e-6)
    assert differ.float().mean().item() < 1e-3
    return int(differ.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("B,P,V", [(64, 1024, 6890), (16, 1024, 6890), (16, 20000, 6890),
                                   (3, 777, 431)])
def test_k2_matches_plain_version(cuda, B, P, V):
    """The two guided shapes, the metric shape and a small ragged one."""
    _assert_k2_agrees(*_points_near_body(B, P, V, seed=P, device=cuda))


@pytest.mark.gpu
def test_k2_duplicate_vertices_go_to_the_lowest_index(cuda):
    """Every vertex appears twice (v[j + V/2] == v[j]) across a chunk
    boundary of the kernel: exact ties, so every index is below V/2 and
    equals the plain version's."""
    pts, half = _points_near_body(2, 1500, 2500, seed=5, device=cuda)
    verts = torch.cat([half, half], dim=1)
    got = k2.nearest_vertex_idx(pts, verts)
    assert int(got.max()) < 2500
    assert int(k2.nearest_vertex_idx_reference(pts, verts).max()) < 2500
    _assert_k2_agrees(pts, verts)


@pytest.mark.gpu
def test_k2_searches_a_whole_scene_cloud(cuda):
    """`nearest_vertex` on the card goes through K2 whatever V: the chamfer
    and contact shape, a body's 6890 vertices against a 20,000-point cloud
    (the kernel walks V in chunks, so nothing bounds it), one launch per
    call, held to the plain version like the body-sized shapes; and
    `chamfer_distance` launches it once per direction."""
    from egohmr_tpu_torch.collision import chamfer_distance

    pts, cloud = _points_near_body(4, 6890, 20000, seed=6, device=cuda)
    _assert_k2_agrees(pts, cloud)
    before = k2.launches
    got = nearest_vertex(pts, cloud)
    assert k2.launches == before + 1
    ref = k2.nearest_vertex_idx_reference(pts, cloud)
    near = torch.gather(cloud, 1, ref[..., None].expand(-1, -1, 3))
    torch.testing.assert_close(got.dist, torch.linalg.norm(pts - near, dim=-1),
                               rtol=1e-5, atol=1e-6)
    cx, cy = chamfer_distance(pts, cloud)
    assert k2.launches == before + 3 and cx.shape == (4, 6890) and cy.shape == (4, 20000)


@pytest.mark.gpu
def test_k2_rejects_what_it_does_not_take(cuda):
    pts, verts = _points_near_body(1, 10, 20, seed=7, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        k2.nearest_vertex_idx(pts.double(), verts.double())
    with pytest.raises(ValueError, match="expected"):
        k2.nearest_vertex_idx(pts[0], verts)
