"""Kernels K1, K2 and K3 on the card, each held to its plain version, and
the evaluation CLI on the card against the CPU. Needs a
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
@pytest.mark.parametrize("B,P", [(2, 64), (3, 4099), (4, 20000), (1, 20000), (1, 1),
                                 (2, 127), (2, 129), (5, 255), (5, 257)])
def test_k1_matches_plain_version(cuda, B, P):
    """Bar: two bf16 ulps of the largest pooled value (the tensor cores sum
    in another order than cuBLAS's f32 GEMM, and bf16 rounding flips carry
    through the pooled stages); every launch is counted. The shapes: small,
    ragged and full-size clouds, one cloud alone (fewer tiles than SMs at
    P = 1), and P just below and above a multiple of the 128-point tile."""
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
def test_k1_prepares_weights_once_and_again_after_a_change(cuda):
    """Two calls on one model prepare its weights once; after an in-place
    update the next call prepares anew and computes with the new weights."""
    enc = init_random_(ResnetPointnet(512, 256), seed=2).to(cuda).eval()
    pts = torch.randn(2, 1000, 3, generator=torch.Generator().manual_seed(0)).to(cuda)
    before = k1.preparations
    a = k1.pointnet_fused_feature(enc, pts)
    b = k1.pointnet_fused_feature(enc, pts)
    assert k1.preparations == before + 1 and torch.equal(a, b)
    with torch.no_grad():
        enc.block_3.fc_1.weight.mul_(-1.0)
    c = k1.pointnet_fused_feature(enc, pts)
    assert k1.preparations == before + 2 and not torch.equal(a, c)
    ref = k1.pointnet_fused_reference(enc, pts)
    assert (c - ref).abs().max().item() <= 2.0 ** -7 * ref.abs().max().item()


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
                                   (16, 4096, 6890), (3, 777, 431)])
def test_k2_matches_plain_version(cuda, B, P, V):
    """The two guided shapes, the metric shape, the training shape (the
    collision loss's 4096 scene points of a batch of 16) and a small ragged
    one."""
    _assert_k2_agrees(*_points_near_body(B, P, V, seed=P, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("B,P,V,split", [
    (16, 1024, 6890, True),     # few points: V is split to fill the card
    (66, 16500, 3200, False),   # the point blocks fill it: no split though V allows one
    (3, 777, 431, False),       # V too short to split
    (2, 100, 7, False),         # V smaller than one min block
    (2, 3, 5000, True),         # P smaller than one thread's points
], ids=["split", "filled", "short", "tiny-V", "tiny-P"])
def test_k2_every_branch_of_the_launch_plan(cuda, B, P, V, split):
    plan = k2.launch_plan(B, P, V, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert (plan["splits"] > 1) == split
    _assert_k2_agrees(*_points_near_body(B, P, V, seed=V, device=cuda))


@pytest.mark.gpu
def test_k2_duplicate_vertices_go_to_the_lowest_index(cuda):
    """Every vertex appears twice (v[j + V/2] == v[j]), the copies in two
    ranges of the kernel's V split: exact ties, so every index is below V/2
    and equals the plain version's."""
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


def _assert_k3_agrees(name, got, ref):
    """int8 variants element for element; bf16 within rtol 1e-4 of the plain
    f32 sum (the tensor cores add the k-steps straight into the carried sum,
    the plain version adds each product's own sum); the glue variant within
    rtol 1e-5 but for at most 0.1% of the elements, which may sit one
    quantisation step apart (a row scale off by an ulp moves a rounding)."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if got.dtype == torch.int32:
        assert torch.equal(got, ref)
    elif name.startswith("A"):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    else:
        close = torch.isclose(got, ref, rtol=1e-5, atol=1e-7)
        assert close.float().mean().item() >= 0.999
        torch.testing.assert_close(got, ref, rtol=2e-2, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["A_bf16", "A1_bf16_bare", "B_int8", "B1_int8_bare",
                                  "B2_int8_slice", "C_int8_glue"])
def test_k3_matches_plain_version(cuda, name):
    """Every variant of the matmul-rate probe at K = N = 256, M = 2048 (the
    probe's) and M = 128 (one CTA a chain), G = 1 and 3 chains, R = 0, 1, 2,
    7 and 33 (odd: the perturbed variants end on a perturbed step), with a
    127 planted in the int8 operand so that the wrapping add is exercised;
    every launch is counted."""
    from egohmr_tpu_torch.tools import probe_int8_mma as k3

    ops = list(k3.make_inputs(seed=3, device=cuda)[name])
    if name.startswith("B"):
        ops[0][5, 7] = 127
    for m in (2048, 128):
        if m != k3.M:  # the leading rows (B2: of each half)
            x = ops[0]
            ops_m = [torch.cat([x[:m], x[k3.M:k3.M + m]]) if name == "B2_int8_slice"
                     else x[:m].contiguous(), *ops[1:]]
        else:
            ops_m = ops
        for g in (1, 3):
            for r in (0, 1, 2, 7, 33):
                before = k3.launches
                got = k3.run(name, r, g, *ops_m)
                torch.cuda.synchronize()
                assert k3.launches == before + 1
                _assert_k3_agrees(name, got, k3.plain(name, r, g, *ops_m))


@pytest.mark.gpu
def test_k3_is_built_from_wgmma_alone(cuda):
    """The SASS of the built `probe_mma` library (the toolkit's `cuobjdump
    -sass`) holds warpgroup products, HGMMA (bf16) and IGMMA (int8), and no
    mma.sync product (HMMA, IMMA): the route the source claims is the one
    built."""
    import os
    import re
    import shutil
    import subprocess

    from egohmr_tpu_torch import _build

    _build.load("probe_mma")
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build._target("probe_mma"))],
                          capture_output=True, text=True, check=True).stdout
    assert re.search(r"\bHGMMA\.", sass) and re.search(r"\bIGMMA\.", sass)
    assert not re.search(r"\bHMMA\.", sass) and not re.search(r"\bIMMA\.", sass)


@pytest.mark.gpu
def test_k3_rejects_what_it_does_not_take(cuda):
    from egohmr_tpu_torch.tools import probe_int8_mma as k3

    x, w = k3.make_inputs(device=cuda)["B_int8"]
    with pytest.raises(ValueError, match="multiple of"):
        k3.run("B_int8", 1, 1, x[:100], w)
    with pytest.raises(ValueError, match="overflow"):
        k3.run("B_int8", 501, 1, x, w)


@pytest.mark.gpu
@pytest.mark.parametrize("guided", [False, True], ids=["unguided", "guided"])
def test_eval_cli_on_the_card_matches_the_cpu(cuda, monkeypatch, guided):
    """The evaluation CLI in f32 with the plain PointNet, on the card (where
    `evaluate_batch` and the guidance reach K2) against the CPU: the same
    weights, the same images (ResNet-50 width, 2,000 scene points so that the
    CPU's search ends in seconds; one body at the image's edge, one outside
    it, so that the masked keys and the empty mask are exercised) and the
    same x_T, handed in because a CUDA and a CPU generator draw other
    numbers. Summary keys equal, NaN in the same places, values within
    rtol 1e-3; the diversity keys (std, apd: a fraction of a millimetre,
    the spread of S bodies whose coordinates are of the order of a metre)
    within 0.005 mm besides, some tens of f32 ulps of such a coordinate."""
    import numpy as np

    from egohmr_tpu_torch.data import synthetic_batch, to_torch
    from egohmr_tpu_torch.eval import sample_bodies
    from egohmr_tpu_torch.eval import test_egohmr as cli

    B, S = 3, 2
    x_T = torch.randn(B * S, 144, generator=torch.Generator().manual_seed(11))

    def batch_at_the_edge(batch_size, *, seed, device):
        batch = synthetic_batch(batch_size, num_scene_points=2000, seed=seed)
        batch["smpl_params"]["transl"][1, 0] = 1.2   # u around the right edge
        batch["smpl_params"]["transl"][2, 0] = 4.0   # far outside
        return to_torch(batch, device)

    def same_noise(*a, **kw):
        device = a[5]["img"].device
        return sample_bodies(*a, **{**kw, "noise": x_T.to(device)})

    monkeypatch.setattr(cli, "synthetic_batch", batch_at_the_edge)
    monkeypatch.setattr(cli, "sample_bodies", same_noise)
    args = ["--synthetic", "--batch_size", str(B), "--num_batches", "1", "--num_samples", str(S),
            "--bf16", "false", "--pointnet_impl", "xla", "--timestep_respacing_eval", "ddim5",
            "--with_coap_grad", "true" if guided else "false"]
    before = k2.launches
    got = cli.main(args + ["--device", "cuda"])
    assert k2.launches == before + (2 + 4 if guided else 2)
    want = cli.main(args + ["--device", "cpu"])
    assert list(got) == list(want)
    for k in want:
        atol = 5e-3 if k.startswith(("std", "apd")) else 1e-6
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=atol, equal_nan=True,
                                   err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("collision", [False, True], ids=["plain", "collision"])
def test_train_step_on_the_card_matches_the_cpu(cuda, collision):
    """One f32 `stage2_loss` and its backward at a tiny width (ResNet-18,
    GCN 1 x 16, 64 scene points, a 64-vertex synthetic body), TF32 off, on
    the card and on the CPU from the same weights, batch and draws (t, noise
    and the condition-drop mask handed in): the loss and its terms at rtol
    1e-4, the BatchNorm statistics at rtol 1e-5 (atol 1e-5 x the tensor's
    largest). Gradients: outside the ResNet each at rtol 1e-3 with atol
    1e-3 x the tensor's largest (the biases whose gradient is zero up to
    rounding: 1e-5 x the largest gradient); the ResNet's, whose early
    layers sum many products behind train-mode BatchNorms and so carry the
    convolution algorithms' f32 rounding (cuDNN's against the CPU's), each
    within 1e-2 of its norm, and the whole gradient's cosine over 0.99999.
    With the collision loss, K2 runs on the card and its plain version on
    the CPU."""
    from egohmr_tpu_torch.data import synthetic_batch, to_torch
    from egohmr_tpu_torch.diffusion import make_schedule
    from egohmr_tpu_torch.models import BodyRepStats, EgoHMR, EgoHMRConfig, LossWeights
    from egohmr_tpu_torch.smpl import make_synthetic_model
    from egohmr_tpu_torch.train import stage2_loss, trainable_tensors

    torch.backends.cudnn.allow_tf32 = False
    cfg = EgoHMRConfig(resnet_layers=18, img_feat_dim=512, scene_feat_dim=32,
                       pointnet_hidden_dim=32, transl_embed_dim=16, timestep_embed_dim=32,
                       input_process_dim=32, gcn_hid_dim=16, gcn_layers=1, cond_mask_prob=0.5)
    B = 4
    init = init_random_(EgoHMR(cfg), seed=0, training=True).state_dict()
    batch = synthetic_batch(B, num_scene_points=64, img_size=64, seed=3)
    g = torch.Generator().manual_seed(5)
    draws = {"t": torch.randint(0, 50, (B,), generator=g), "noise": torch.randn(B, 144, generator=g),
             "drop": torch.tensor([True, False, True, False])}
    results = {}
    for device in (cuda, torch.device("cpu")):
        model = EgoHMR(cfg)
        model.load_state_dict(init)
        model = model.to(device)
        trained = trainable_tensors(model)
        smpl = [make_synthetic_model(seed=s, num_vertices=64, device=device) for s in range(3)]
        before = k2.launches
        loss, terms = stage2_loss(
            model, cfg, LossWeights(), make_schedule(50, "cosine", "").to(device),
            BodyRepStats(torch.zeros(144, device=device), torch.ones(144, device=device)),
            *smpl, to_torch(batch, device), use_collision=collision, max_collision_points=32,
            **{k: v.to(device) for k, v in draws.items()})
        loss.backward()
        assert k2.launches == before + (collision and device.type == "cuda")
        results[device.type] = (
            {k: v.detach().cpu() for k, v in terms.items()},
            {k: t.grad.cpu() for k, t in trained.items()},
            {k: v.cpu() for k, v in model.state_dict().items() if "running" in k})
    (tg, gg, sg), (tc, gc, sc) = results["cuda"], results["cpu"]
    if collision:
        assert tc["loss_coap_penetration"] > 0
    top = max(v.abs().max().item() for v in gc.values())
    zero_grad = (".gconv.bias", "non_local.W.0.bias", "non_local.g.bias", "non_local.phi.bias")
    bars = {**{("term", k): (1e-4, 1e-7) for k in tc},
            **{("grad", k): (1e-3, 1e-5 * top if k.endswith(zero_grad)
                             else 1e-3 * gc[k].abs().max().item())
               for k in gc if not k.startswith("backbone.")},
            **{("stat", k): (1e-5, 1e-5 * sc[k].abs().max().item()) for k in sc}}
    got = {**{("term", k): tg[k] for k in tg}, **{("grad", k): gg[k] for k in gg},
           **{("stat", k): sg[k] for k in sg}}
    want = {**{("term", k): tc[k] for k in tc}, **{("grad", k): gc[k] for k in gc},
            **{("stat", k): sc[k] for k in sc}}
    missed = []  # every miss at once: the card's run is the expensive part
    for key, (rtol, atol) in bars.items():
        excess = ((got[key] - want[key]).abs() - rtol * want[key].abs() - atol).max().item()
        if excess > 0:
            missed.append((key, excess, (got[key] - want[key]).abs().max().item()))
    for k in gc:
        if k.startswith("backbone."):
            rel = ((gg[k] - gc[k]).norm() / gc[k].norm().clamp_min(1e-30)).item()
            if rel > 1e-2:
                missed.append((("grad norm", k), rel))
    a = torch.cat([gg[k].reshape(-1).double() for k in gc])
    b = torch.cat([gc[k].reshape(-1).double() for k in gc])
    cos = (a @ b / (a.norm() * b.norm())).item()
    if not cos > 0.99999:
        missed.append((("gradient cosine",), cos))
    assert not missed, "\n".join(map(str, missed))


@pytest.mark.gpu
def test_k3_plain_glue_on_the_card_matches_the_cpu(cuda):
    """The glue variant's plain version on the card gives the CPU's result
    bit for bit (the CPU's is held to the JAX body in
    `tests/test_torch_probe.py`): its row scale max|x| / 127 is a rounded
    division on both, where a scalar divisor would have PyTorch on CUDA
    multiply by 1/127 instead and move some scales by an ulp."""
    from egohmr_tpu_torch.tools import probe_int8_mma as k3

    ops = k3.make_inputs(seed=4)["C_int8_glue"]
    for r in (1, 7):
        got = k3.plain("C_int8_glue", r, 1, *(t.to(cuda) for t in ops)).cpu()
        assert torch.equal(got, k3.plain("C_int8_glue", r, 1, *ops))
