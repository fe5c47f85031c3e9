"""Kernels K1, K2 and K3, the graph-convolution epilogue and the ResNet
epilogue on the card,
each held to its plain version (K2 also at the distillation label shapes),
the evaluation CLI, training steps
and the shipped learned collision nets on the card against the CPU, and
`Predictor`'s captured request programs and staged uploads against their
eager runs. Needs a
CUDA device and `nvcc`; skips without a card. Run on a GPU machine with
`python -m pytest --noconftest tests/test_torch_gpu.py -q` (the repo's
conftest imports JAX, which a GPU machine need not have)."""
import pytest
import torch

from egohmr_tpu_torch.collision import knn as k2
from egohmr_tpu_torch.collision import nearest_vertex
from egohmr_tpu_torch.models import init_random_
from egohmr_tpu_torch.nn import gconv_epilogue as epilogue
from egohmr_tpu_torch.nn import pointnet_fused as k1
from egohmr_tpu_torch.nn import resnet_epilogue as resnet_epi
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


@pytest.mark.gpu
def test_k1_at_the_stage1_evaluation_shape(cuda):
    """K1 as stage 1's evaluation runs it, once per batch of 10 clouds of
    20,000 points, through `models.prohmr.conditioning_feats` with
    `pointnet_impl="fused"` on the card: one launch, the pooled feature
    within two bf16 ulps of the largest pooled value of the plain version,
    and the scene features within the same bar of the f32 plain encoder's,
    carried through `fc_c`."""
    from dataclasses import replace

    from egohmr_tpu_torch.data import synthetic_batch
    from egohmr_tpu_torch.models import ProHMR, ProHMRConfig
    from egohmr_tpu_torch.models import prohmr

    cfg = ProHMRConfig(pointnet_impl="fused")
    model = prohmr.init_random_(ProHMR(cfg), seed=0).to(cuda).eval()
    batch = synthetic_batch(10, seed=200, device=cuda)
    pts = batch["scene_pcd_verts_full"]
    before = k1.launches
    with torch.no_grad():
        ctx = prohmr.conditioning_feats(model, cfg, batch)
        torch.cuda.synchronize()
        assert k1.launches == before + 1
        plain = prohmr.conditioning_feats(model, replace(cfg, pointnet_impl="xla"), batch)
        got = k1.pointnet_fused_feature(model.scene_enc, pts)
        ref = k1.pointnet_fused_reference(model.scene_enc, pts)
    assert ctx.shape == (10, 2566) and torch.isfinite(ctx).all()
    assert (got - ref).abs().max().item() <= 2.0 ** -7 * ref.abs().max().item()
    scene, scene32 = ctx[:, -512:], plain[:, -512:]
    assert (scene - scene32).abs().max().item() <= 2.0 ** -7 * scene32.abs().max().item()
    assert torch.equal(ctx[:, :-512], plain[:, :-512])


@pytest.mark.gpu
def test_stage1_forward_and_gd_step_on_the_card_match_the_cpu(cuda):
    """Stage 1 at a tiny width (ResNet-18, a Glow of 2 steps of 1 block at
    hidden 32, 64 scene points, a 64-vertex synthetic body, batch 4), f32
    with TF32 off, on the card and on the CPU from the same weights, batch
    and draws (z and the NLL noise handed in, as a CUDA and a CPU generator
    draw other numbers). The eval forward: every `ProHMROutput` field at
    rtol 1e-4, atol 1e-4 x its largest. One G+D step through
    `make_prohmr_train_step`, with the stage-2 training test's bars for the
    card against the CPU: its metrics at rtol 1e-4; the gradients outside the ResNet and the
    discriminator's at rtol 1e-3, atol 1e-3 x the tensor's largest; the
    ResNet's each within 1e-2 of its norm and the whole gradient's cosine
    over 0.99999; the BatchNorm statistics at rtol 1e-5 (atol 1e-5 x the
    largest); every weight after AdamW within 2 lr of the CPU's."""
    from egohmr_tpu_torch.data import synthetic_batch, to_torch
    from egohmr_tpu_torch.models import Discriminator, ProHMR, ProHMRConfig, ProHMRLossWeights
    from egohmr_tpu_torch.models import init_discriminator_, prohmr
    from egohmr_tpu_torch.smpl import make_synthetic_model
    from egohmr_tpu_torch.train import make_optimizers, make_prohmr_train_step

    torch.backends.cudnn.allow_tf32 = False
    cfg = ProHMRConfig(resnet_layers=18, img_feat_dim=512, scene_feat_dim=32,
                       pointnet_hidden_dim=32, flow_hidden=32, flow_layers=2, flow_depth=1,
                       fc_head_hidden=32)
    B, S, lr = 4, 3, 1e-4
    batch = synthetic_batch(B, num_scene_points=64, img_size=64, seed=3)
    # the training init, ActNorms at the identity: after `initialize` a
    # feature's scale reaches 1 / 0.008, and the NLL of another batch 1e6
    init = prohmr.init_random_(ProHMR(cfg), seed=0, training=True).state_dict()
    dinit = init_discriminator_(Discriminator(), seed=1).state_dict()
    g = torch.Generator().manual_seed(5)
    z = torch.randn(B, S, 144, generator=g)
    z[:, 0] = 0
    draws = {"z": z[:, :cfg.num_train_samples].clone(), "nll_noise": torch.randn(B, 144, generator=g)}
    mocap = {"body_pose": 0.3 * torch.randn(B, 69, generator=g),
             "betas": 0.5 * torch.randn(B, 10, generator=g)}
    results = {}
    for device in (cuda, torch.device("cpu")):
        model, disc = ProHMR(cfg), Discriminator()
        model.load_state_dict(init)
        disc.load_state_dict(dinit)
        model, disc = model.to(device), disc.to(device)
        smpl = [make_synthetic_model(seed=s, num_vertices=64, device=device) for s in range(3)]
        tb = to_torch(batch, device)
        with torch.no_grad():
            out = prohmr.forward(model.eval(), cfg, smpl[0], tb, S, z=z.to(device))
        opt, dopt = make_optimizers(model, disc, lr, 1e-4)
        step = make_prohmr_train_step(cfg, ProHMRLossWeights(), *smpl, opt, dopt)
        metrics = step(model, disc, tb, {k: v.to(device) for k, v in mocap.items()},
                       **{k: v.to(device) for k, v in draws.items()})
        grads = {**{k: p.grad.cpu() for k, p in model.named_parameters()},
                 **{"D." + k: p.grad.cpu() for k, p in disc.named_parameters()}}
        weights = {**{k: v.cpu() for k, v in model.state_dict().items()},
                   **{"D." + k: v.cpu() for k, v in disc.state_dict().items()}}
        results[device.type] = ({k: v.cpu() for k, v in out._asdict().items()},
                                {k: v.cpu() for k, v in metrics.items()}, grads, weights)
    (og, mg, gg, wg), (oc, mc, gc, wc) = results["cuda"], results["cpu"]
    missed = []  # every miss at once: the card's run is the expensive part

    def held(key, got, want, rtol, atol):
        excess = ((got - want).abs() - rtol * want.abs() - atol).max().item()
        if excess > 0:
            missed.append((key, excess, (got - want).abs().max().item()))

    for k in oc:
        held(("output", k), og[k], oc[k], 1e-4, 1e-4 * oc[k].abs().max().item())
    for k in mc:
        held(("metric", k), mg[k], mc[k], 1e-4, 1e-7)
    for k in gc:
        if not k.startswith("backbone."):
            held(("grad", k), gg[k], gc[k], 1e-3, 1e-3 * gc[k].abs().max().item())
        else:
            rel = ((gg[k] - gc[k]).norm() / gc[k].norm().clamp_min(1e-30)).item()
            if rel > 1e-2:
                missed.append((("grad norm", k), rel))
    a = torch.cat([gg[k].reshape(-1).double() for k in gc])
    b = torch.cat([gc[k].reshape(-1).double() for k in gc])
    cos = (a @ b / (a.norm() * b.norm())).item()
    if not cos > 0.99999:
        missed.append((("gradient cosine",), cos))
    for k in wc:
        if k.endswith(("running_mean", "running_var")):
            held(("stat", k), wg[k], wc[k], 1e-5, 1e-5 * wc[k].abs().max().item())
        elif wc[k].is_floating_point():
            held(("weight", k), wg[k], wc[k], 0.0, 2 * lr * (1 + 1e-3))
    assert not missed, "\n".join(map(str, missed))


ARTIFACTS = ("occupancy_synthetic.npz", "occupancy_synthetic_signed.npz", "volsdf_synthetic.npz")


def _artifact(name):
    import os

    return os.path.join(os.path.dirname(__file__), "..", "artifacts", name)


def _load_learned(name, device):
    import json

    from egohmr_tpu_torch.collision.neural_occupancy import load_occupancy
    from egohmr_tpu_torch.collision.neural_sdf import load_sdfnet

    with open(_artifact(name) + ".json") as f:
        meta = json.load(f)
    load = load_sdfnet if name.startswith("volsdf") else load_occupancy
    return load(_artifact(name), device), meta


def _field(net, out, betas, pts):
    from egohmr_tpu_torch.collision.neural_occupancy import occupancy_query
    from egohmr_tpu_torch.collision.neural_sdf import SDFNetConfig, sdf_query

    query = sdf_query if isinstance(net.cfg, SDFNetConfig) else occupancy_query
    return query(net, out, betas, pts)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ARTIFACTS)
def test_shipped_artifact_on_the_card(cuda, name):
    """Each shipped collision net on the card: held-out agreement on draws
    made on the card (labels through K2) reaches its sidecar's bar less
    0.02 at 4 bodies x 512 points, and the query on CPU-made inputs equals
    the CPU's at rtol 1e-4, atol 1e-5."""
    from egohmr_tpu_torch.collision.neural_occupancy import (occupancy_agreement,
                                                             sample_labeled_batch)
    from egohmr_tpu_torch.collision.neural_sdf import sdf_agreement
    from egohmr_tpu_torch.smpl import (SMPLOutput, make_synthetic_model,
                                       make_synthetic_watertight_model)

    net, meta = _load_learned(name, cuda)
    cpu_net, _ = _load_learned(name, "cpu")

    def body(device):
        if meta["body"] == "synthetic_watertight":
            return make_synthetic_watertight_model(device=device)
        return make_synthetic_model(num_vertices=6890, device=device)

    g = torch.Generator(cuda).manual_seed(123)
    kw = dict(n_bodies=4, points_per_body=512, label_mode=meta["label_mode"],
              sign_k=meta.get("sign_k", 4))
    before = k2.launches
    if name.startswith("volsdf"):
        acc, bar = sdf_agreement(net, body(cuda), g, **kw)["sign_agreement"], meta["agreement_bar"]
    else:
        acc, bar = occupancy_agreement(net, body(cuda), g, **kw), meta["accuracy_bar"]
    assert k2.launches > before
    assert acc >= bar - 0.02, (acc, meta)
    b = sample_labeled_batch(torch.Generator().manual_seed(5), body("cpu"), batch_bodies=2,
                             points_per_body=1024, label_mode="proximity")
    with torch.no_grad():
        want = _field(cpu_net, b.smpl_out, b.betas, b.points)
        got = _field(net, SMPLOutput(*(t.to(cuda) for t in b.smpl_out)), b.betas.to(cuda),
                     b.points.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["occupancy_synthetic_signed.npz", "volsdf_synthetic.npz"])
def test_learned_query_in_chunks_on_the_card(cuda, name, monkeypatch):
    """The evaluation query in chunks (QUERY_ROWS cut so that 6,000 points
    take three chunks) against the unchunked query on the card, and the
    card's chunked query against the CPU's on the same inputs."""
    from functools import partial

    from egohmr_tpu_torch.collision import neural_occupancy as occ
    from egohmr_tpu_torch.collision.neural_sdf import SDFNetConfig, sdf_from_raw
    from egohmr_tpu_torch.smpl import SMPLOutput, lbs, make_synthetic_model

    net, _ = _load_learned(name, cuda)
    cpu_net, _ = _load_learned(name, "cpu")
    n, P = 8, 6000
    g = torch.Generator().manual_seed(9)
    betas = torch.randn(n, 10, generator=g) * 0.5
    aa = torch.randn(n, 24, 3, generator=g) * 0.2
    out = lbs(make_synthetic_model(num_vertices=6890), betas, aa[:, 0], aa[:, 1:].reshape(n, 69))
    scene = out.vertices[:, :1] + torch.rand(n, P, 3, generator=g) * 1.2 - 0.6
    head = (partial(sdf_from_raw, net.cfg) if isinstance(net.cfg, SDFNetConfig)
            else occ.occupancy_from_raw)
    monkeypatch.setattr(occ, "QUERY_ROWS", n * 24 * 2000)
    dev_out = SMPLOutput(*(t.to(cuda) for t in out))
    got = occ.field_in_chunks(net, dev_out, betas.to(cuda), scene.to(cuda), head)
    with torch.no_grad():
        whole = _field(net, dev_out, betas.to(cuda), scene.to(cuda))
    want = occ.field_in_chunks(cpu_net, out, betas, scene, head)
    torch.testing.assert_close(got, whole, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("B,V", [(8, 3504), (16, 3504), (8, 6890), (16, 6890)])
def test_k2_at_the_distillation_label_shapes(cuda, B, V):
    """K2 at the shapes of the distillation labels, [B, 1024] points against
    the watertight body's 3,504 vertices or the synthetic body's 6,890, on
    the label draw itself (half the points in the body's bbox, half near
    its surface)."""
    from egohmr_tpu_torch.collision.neural_occupancy import sample_labeled_batch
    from egohmr_tpu_torch.smpl import make_synthetic_model, make_synthetic_watertight_model

    body = (make_synthetic_watertight_model(device=cuda) if V == 3504
            else make_synthetic_model(num_vertices=V, device=cuda))
    b = sample_labeled_batch(torch.Generator(cuda).manual_seed(B), body, batch_bodies=B,
                             points_per_body=1024, label_mode="proximity")
    _assert_k2_agrees(b.points.contiguous(), b.smpl_out.vertices.contiguous())


def _tiny_stage2(device, **overrides):
    from egohmr_tpu_torch.models import EgoHMR, EgoHMRConfig

    widths = dict(resnet_layers=18, img_feat_dim=512, scene_feat_dim=32, pointnet_hidden_dim=32,
                  transl_embed_dim=16, timestep_embed_dim=32, input_process_dim=32,
                  gcn_hid_dim=16, gcn_layers=1)
    cfg = EgoHMRConfig(**{**widths, **overrides})
    return cfg, init_random_(EgoHMR(cfg), seed=0, training=True).state_dict()


@pytest.mark.gpu
@pytest.mark.parametrize("mixed_precision", [False, True], ids=["f32", "bf16-mixed"])
def test_dp_step_with_nccl_at_world_1_is_the_plain_step(cuda, tmp_path, mixed_precision):
    """Phase 10 (a) at a tiny width: the stage-2 step through the
    data-parallel code on an NCCL group of one rank (62 BatchNorm
    all-reduces at full width, here 23, and the gradient all-reduce, each
    the identity) against the plain step on the same draws, cuDNN
    deterministic: the loss, every gradient and the BatchNorm statistics
    bit for bit."""
    import torch.distributed as dist

    from egohmr_tpu_torch.data import synthetic_batch
    from egohmr_tpu_torch.diffusion import make_schedule
    from egohmr_tpu_torch.models import BodyRepStats, EgoHMR, LossWeights
    from egohmr_tpu_torch.parallel import init_data_parallel
    from egohmr_tpu_torch.smpl import make_synthetic_model
    from egohmr_tpu_torch.train import (TrainConfig, make_optimizer, make_train_step,
                                        trainable_tensors)

    torch.backends.cudnn.allow_tf32 = False
    cfg, init = _tiny_stage2(cuda, cond_mask_prob=0.5)
    batch = synthetic_batch(4, num_scene_points=64, img_size=64, seed=3, device=cuda)
    g = torch.Generator().manual_seed(5)
    draws = {"t": torch.randint(0, 50, (4,), generator=g).to(cuda),
             "noise": torch.randn(4, 144, generator=g).to(cuda),
             "drop": torch.tensor([True, False, True, False], device=cuda)}
    smpl = make_synthetic_model(num_vertices=64, device=cuda)
    stats = BodyRepStats(torch.zeros(144, device=cuda), torch.ones(144, device=cuda))
    schedule = make_schedule(50, "cosine", "").to(cuda)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        dp = init_data_parallel("cuda")
        assert dp is not None and dp.size == 1 and dist.get_backend() == "nccl"
        runs = []
        for rec in (None, dp):
            model = EgoHMR(cfg)
            model.load_state_dict(init)
            model = model.to(cuda)
            tcfg = TrainConfig(mixed_precision=mixed_precision)
            step = make_train_step(cfg, tcfg, LossWeights(), schedule, stats, smpl, smpl, smpl,
                                   make_optimizer(model, tcfg), dp=rec)
            terms = step(model, batch, **draws)
            runs.append((float(terms["loss"]),
                         {k: t.grad.clone() for k, t in trainable_tensors(model).items()},
                         {k: v.clone() for k, v in model.state_dict().items() if "running" in k}))
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()
    (loss_a, grads_a, bn_a), (loss_b, grads_b, bn_b) = runs
    assert loss_a == loss_b
    assert all(torch.equal(grads_a[k], v) for k, v in grads_b.items())
    assert all(torch.equal(bn_a[k], v) for k, v in bn_b.items())


@pytest.mark.gpu
def test_predictor_over_two_replicas_on_one_card(cuda):
    """Phase 10 (d) at a tiny width: `Predictor(device=[cuda, cuda])`, two
    replicas on the one card each serving half of every request, against
    the one-device `Predictor` on the same seed, unguided DDIM-5: f32 plain
    within rtol 2e-4, atol 2e-4 (the JAX package's serving bars); bf16 with
    K1 within a mean abs of 0.05 of pred_keypoints_3d, K1 once per replica.
    The scene encoder is K1's width, H = 256."""
    import copy

    from egohmr_tpu_torch.data import synthetic_batch
    from egohmr_tpu_torch.diffusion import make_schedule
    from egohmr_tpu_torch.models import BodyRepStats, EgoHMR
    from egohmr_tpu_torch.serving import Predictor
    from egohmr_tpu_torch.smpl import make_synthetic_model

    torch.backends.cudnn.allow_tf32 = False
    cfg, _ = _tiny_stage2(cuda, pointnet_hidden_dim=256)
    model = init_random_(EgoHMR(cfg), seed=0).eval()
    smpl = make_synthetic_model(num_vertices=64)
    stats = BodyRepStats(torch.zeros(144), torch.ones(144))
    schedule = make_schedule(50, "cosine", "ddim5")
    batch = synthetic_batch(8, num_scene_points=2048, img_size=64, seed=2)
    for kw in (dict(bf16=False, pointnet_impl="xla"), dict(bf16=True, pointnet_impl="fused")):
        outs = {}
        for n in (1, 2):
            pred = Predictor(copy.deepcopy(model), cfg, smpl, stats, schedule,
                             device=cuda if n == 1 else [cuda, cuda], batch_size=8, **kw)
            pred.warmup(batch)  # captures each replica's program; its runs count
            before = k1.launches
            outs[n] = pred(batch, seed=3)
            assert k1.launches - before == (n if kw["bf16"] else 0)
        for k in outs[1]:
            if kw["bf16"]:
                continue
            torch.testing.assert_close(torch.tensor(outs[2][k]), torch.tensor(outs[1][k]),
                                       rtol=2e-4, atol=2e-4, msg=k)
        gap = abs(outs[2]["pred_keypoints_3d"] - outs[1]["pred_keypoints_3d"]).mean()
        assert gap < 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("sampler,respacing,guided,bf16", [
    ("ddim", "ddim5", False, True), ("ddim", "ddim5", False, False),
    ("ddim", "ddim5", True, True), ("ddpm", "", True, True)],
    ids=["unguided-ddim5-bf16", "unguided-ddim5-f32", "guided-ddim5-bf16", "guided-ddpm50-bf16"])
def test_replayed_request_equals_eager(cuda, sampler, respacing, guided, bf16):
    """Phase 14 (a) and (b) at a tiny width (the scene encoder at K1's
    H = 256): a `Predictor` request replayed from its captured CUDA graph
    equals `Predictor.eager` on the same seed bit for bit, on two seeds and
    after another shape's capture; K1 once and K2 once per guided step
    (4, 11) per replayed request by the replay accounting and by the
    device's kernels under the profiler (K1's four stage kernels, K2's
    search kernel)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from egohmr_tpu_torch.data import synthetic_batch
    from egohmr_tpu_torch.diffusion import GuidanceConfig, make_schedule
    from egohmr_tpu_torch.models import BodyRepStats, EgoHMR
    from egohmr_tpu_torch.serving import MESH_OUTPUT_KEYS, Predictor
    from egohmr_tpu_torch.smpl import make_synthetic_model

    torch.backends.cudnn.allow_tf32 = False
    cfg, _ = _tiny_stage2(cuda, pointnet_hidden_dim=256)
    model = init_random_(EgoHMR(cfg), seed=0).eval()
    schedule = make_schedule(50, "cosine", respacing)
    pred = Predictor(model, cfg, make_synthetic_model(num_vertices=512),
                     BodyRepStats(torch.zeros(144), torch.ones(144)), schedule, device=cuda,
                     batch_size=4, num_samples=2, bf16=bf16, sampler=sampler,
                     with_guidance=guided, guidance=GuidanceConfig(cond_grad_weight=60.0,
                                                                   ddim_scale=30.0),
                     output_keys=MESH_OUTPUT_KEYS)
    assert pred.captured
    batch = synthetic_batch(4, num_scene_points=2048, img_size=64, seed=2)
    pred.warmup(batch)
    want_k2 = (4 if sampler == "ddim" else 11) if guided else 0
    for seed in (3, 4):
        b1, b2 = k1.launches, k2.launches
        torch.cuda.synchronize(cuda)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = pred(batch, seed=seed)
            torch.cuda.synchronize(cuda)
        kernels = {name: sum(e.count for e in prof.key_averages()
                             if e.device_type == torch.autograd.DeviceType.CUDA
                             and re.search(rf"\b{name}\b", e.key))
                   for name in ("stage_kernel", "nearest_vertex_kernel")}
        assert (k1.launches - b1, k2.launches - b2) == (1, want_k2)
        assert kernels == {"stage_kernel": 4, "nearest_vertex_kernel": want_k2}
        want = pred.eager(batch, seed=seed)
        for k in want:
            assert (got[k] == want[k]).all(), k
    pred.warmup(synthetic_batch(4, num_scene_points=1024, img_size=64, seed=5))
    assert len(pred._programs[0].programs) == 2
    got, want = pred(batch, seed=6), pred.eager(batch, seed=6)
    for k in want:
        assert (got[k] == want[k]).all(), k


def _staging_predictor(cuda, batch_size):
    from egohmr_tpu_torch.diffusion import make_schedule
    from egohmr_tpu_torch.models import BodyRepStats, EgoHMR
    from egohmr_tpu_torch.serving import Predictor
    from egohmr_tpu_torch.smpl import make_synthetic_model

    torch.backends.cudnn.allow_tf32 = False
    cfg, _ = _tiny_stage2(cuda, pointnet_hidden_dim=256)
    model = init_random_(EgoHMR(cfg), seed=0).eval()
    pred = Predictor(model, cfg, make_synthetic_model(num_vertices=512),
                     BodyRepStats(torch.zeros(144), torch.ones(144)),
                     make_schedule(50, "cosine", "ddim5"), device=cuda,
                     batch_size=batch_size, bf16=True, max_inflight=4)
    assert pred.captured
    return pred


def _map_leaves(fn, tree):
    return {k: _map_leaves(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


@pytest.mark.gpu
def test_staged_stream_equals_eager_at_the_bulk_shape(cuda):
    """The bulk request's shape (64 images of 224 x 224, 20,000 scene
    points) at a tiny width: a `map_batches` stream of six distinct NumPy
    batches, 4 in flight, through a staging ring of fewer slots, equals
    `Predictor.eager` (`to_torch`) on each request bit for bit; `staged`
    counts every request of the stream and `unstaged` none."""
    from egohmr_tpu_torch.data import synthetic_batch

    pred = _staging_predictor(cuda, 64)
    batches = [synthetic_batch(64, num_scene_points=20000, img_size=224, seed=10 + i)
               for i in range(6)]
    pred.warmup(batches[0])
    staged, unstaged = pred.staged, pred.unstaged
    outs = list(pred.map_batches(iter(batches), seed=7))
    assert (pred.staged - staged, pred.unstaged - unstaged) == (6, 0)
    (staging,) = pred._staging
    (ring,) = staging.rings.values()
    assert len(ring.host) < len(batches) and len(ring.dev) == 2
    for i, (b, got) in enumerate(zip(batches, outs)):
        want = pred.eager(b, seed=7 + i)
        for k in want:
            assert (got[k] == want[k]).all(), (i, k)


@pytest.mark.gpu
def test_staged_short_batch_equals_the_padded_batch(cuda):
    """A short NumPy batch (5 of 8 rows) through the staging ring equals the
    same batch padded by its last row (`pad_batch`), trimmed, and its eager
    request, bit for bit; both requests are staged, in one ring."""
    from egohmr_tpu_torch.data import pad_batch, synthetic_batch

    pred = _staging_predictor(cuda, 8)
    full = synthetic_batch(8, num_scene_points=2048, img_size=64, seed=2)
    short = _map_leaves(lambda x: x[:5].copy(), full)
    pred.warmup(full)
    staged = pred.staged
    got, padded = pred(short, seed=3), pred(pad_batch(short, 8), seed=3)
    assert pred.staged - staged == 2 and len(pred._staging[0].rings) == 1
    want = pred.eager(short, seed=3)
    for k in want:
        assert got[k].shape[0] == 5, k
        assert (got[k] == padded[k][:5]).all(), k
        assert (got[k] == want[k]).all(), k


@pytest.mark.gpu
def test_overwriting_the_callers_arrays_after_submit_changes_nothing(cuda):
    """Three requests submitted back to back, the caller's arrays
    overwritten right after each `submit`: each request's outputs equal the
    eager request on the arrays as they were submitted, bit for bit."""
    from egohmr_tpu_torch.data import synthetic_batch

    pred = _staging_predictor(cuda, 8)
    batches = [synthetic_batch(8, num_scene_points=2048, img_size=64, seed=20 + i)
               for i in range(3)]
    kept = [_map_leaves(lambda x: x.copy(), b) for b in batches]
    pred.warmup(kept[0])
    pending = []
    for i, b in enumerate(batches):
        pending.append(pred.submit(b, seed=5 + i))
        _map_leaves(lambda x: x.fill(0), b)
    for i, p in enumerate(pending):
        got, want = pred.result(p), pred.eager(kept[i], seed=5 + i)
        for k in want:
            assert (got[k] == want[k]).all(), (i, k)


@pytest.mark.gpu
def test_request_phases_on_the_card(cuda, tmp_path):
    """The phase markers at a tiny width (the scene encoder at K1's H = 256):
    under the profiler, three replayed `Predictor` requests show the five
    marker kernels in order, once a request, each after its request's host
    `serve.launch` span began (the host's spans and the device's kernels
    share the trace's clock), and the four phases tile the device's time
    from `image` to `end`; the replay, markers captured, equals the eager
    request bit for bit; an eager request under the profiler marks its
    phases too."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from egohmr_tpu_torch.data import synthetic_batch
    from egohmr_tpu_torch.diffusion import make_schedule
    from egohmr_tpu_torch.models import BodyRepStats, EgoHMR
    from egohmr_tpu_torch.serving import Predictor
    from egohmr_tpu_torch.smpl import make_synthetic_model
    from egohmr_tpu_torch.utils.profiling import MARKER_PREFIX, PHASES, clear, recorded

    torch.backends.cudnn.allow_tf32 = False
    cfg, _ = _tiny_stage2(cuda, pointnet_hidden_dim=256)
    model = init_random_(EgoHMR(cfg), seed=0).eval()
    pred = Predictor(model, cfg, make_synthetic_model(num_vertices=512),
                     BodyRepStats(torch.zeros(144), torch.ones(144)),
                     make_schedule(50, "cosine", "ddim5"), device=cuda, batch_size=4,
                     num_samples=2, bf16=True, max_inflight=2)
    batch = synthetic_batch(4, num_scene_points=2048, img_size=64, seed=2)
    pred.warmup(batch)

    def traced(run):
        clear()
        torch.cuda.synchronize(cuda)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = run()
            torch.cuda.synchronize(cuda)
        path = tmp_path / "trace.json"
        prof.export_chrome_trace(str(path))
        events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
        marks = sorted((float(e["ts"]), e["name"][len(MARKER_PREFIX):]) for e in events
                       if e.get("cat") == "kernel" and e["name"].startswith(MARKER_PREFIX))
        launches = sorted(float(e["ts"]) for e in events if e.get("cat") == "user_annotation"
                          and e["name"] == "egohmr.serve.launch")
        return out, marks, launches

    outs, marks, launches = traced(lambda: list(pred.map_batches(iter([batch] * 3), seed=3)))
    assert [p for _, p in marks] == list(PHASES) * 3
    assert len(launches) == 3
    assert sorted({s.request for s in recorded() if s.name == "serve.launch"}) \
        == sorted({s.request for s in recorded()})
    for i in range(3):
        starts = [t for t, _ in marks[5 * i:5 * i + 5]]
        assert all(t > launches[i] for t in starts)
        phases = [b - a for a, b in zip(starts, starts[1:])]
        assert all(p > 0 for p in phases)
        assert sum(phases) == pytest.approx(starts[-1] - starts[0], rel=1e-9)
    for i, got in enumerate(outs):
        want = pred.eager(batch, seed=3 + i)
        for k in want:
            assert (got[k] == want[k]).all(), k
    _, marks, _ = traced(lambda: pred.eager(batch, seed=3))
    assert [p for _, p in marks] == list(PHASES)


@pytest.mark.gpu
def test_captured_volsdf_request_equals_eager(cuda):
    """EgoHMR-VolSMPL on the served path at the evaluation CLI's 5 x 5: the
    learned-SDF guided DDPM-50 request (the shipped 192-wide net, weight
    30, all 20,000 scene points) captured in `Predictor` equals its eager
    run bit for bit (within twice two eager runs' gap where those differ);
    per replayed request `guided_steps` is 11 and `field_rows` 11 x 25 x 24
    x 20,000; the record holds 11 finite steps with a non-zero gradient,
    and a request without `record_guidance` none; the unguided bulk
    request, replayed from a NumPy batch, makes 22 host calls."""
    import os

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from egohmr_tpu_torch.collision.neural_sdf import load_sdfnet
    from egohmr_tpu_torch.data import synthetic_batch
    from egohmr_tpu_torch.diffusion import GuidanceConfig, make_schedule
    from egohmr_tpu_torch.models import BodyRepStats, EgoHMR, EgoHMRConfig
    from egohmr_tpu_torch.serving import GUIDANCE_RECORD, Predictor
    from egohmr_tpu_torch.smpl import make_synthetic_watertight_model
    from egohmr_tpu_torch.utils.profiling import host_launches

    def numpy_tree(t):
        return {k: numpy_tree(v) for k, v in t.items()} if isinstance(t, dict) else \
            (t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t))

    def gap(a, b):
        return max(float(np.abs(a[k] - b[k]).max()) for k in a)

    cfg = EgoHMRConfig()
    model = init_random_(EgoHMR(cfg), seed=0).eval()
    net = load_sdfnet(os.path.join(os.path.dirname(__file__), "..", "artifacts",
                                   "volsdf_synthetic.npz"), cuda)
    body = make_synthetic_watertight_model()
    stats = BodyRepStats(torch.zeros(144), torch.ones(144))
    batch = numpy_tree(synthetic_batch(5, num_scene_points=20000, seed=30))

    def predictor(**kw):
        return Predictor(model, cfg, body, stats, make_schedule(50, "cosine", ""), device=cuda,
                         batch_size=5, num_samples=5, sampler="ddpm", with_guidance=True,
                         guidance=GuidanceConfig(cond_grad_weight=30.0),
                         collision_backend="volsdf", collision_net=net,
                         guidance_scene_points=None, **kw)

    pred = predictor(record_guidance=True)
    e1, e2 = pred.eager(batch, seed=1), pred.eager(batch, seed=1)
    pred.warmup(batch)
    before = (pred.guided_steps, pred.field_rows)
    got = pred(batch, seed=1)
    assert (pred.guided_steps - before[0], pred.field_rows - before[1]) == (11, 11 * 25 * 24
                                                                            * 20000)
    eager_gap = gap(e1, e2)
    assert gap(got, e1) <= (0.0 if eager_gap == 0 else 2 * eager_gap)
    rec = got[GUIDANCE_RECORD]
    assert rec.shape == (5, 5, 11, 4, 144) and np.isfinite(rec).all()
    assert np.abs(rec[:, :, :, 2]).max() > 0
    del pred
    plain = predictor()
    out = plain(batch, seed=1)
    assert GUIDANCE_RECORD not in out and sorted(out) == sorted(k for k in got
                                                                if k != GUIDANCE_RECORD)
    del plain
    bulk = Predictor(model, cfg, body, stats, make_schedule(50, "cosine", "ddim5"),
                     device=cuda, batch_size=64)
    big = numpy_tree(synthetic_batch(64, num_scene_points=20000, seed=31))
    bulk.warmup(big)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        bulk(big, seed=2)
        torch.cuda.synchronize()
    assert host_launches(prof)["total"] == 22


def _random_gconv(D, bn, seed, device):
    """A bf16 graph convolution [D -> D] (with BatchNorm or without, as the
    output convolution) with every parameter and statistic drawn."""
    from egohmr_tpu_torch.nn import cast_params_bf16
    from egohmr_tpu_torch.nn.gcn import GraphConv, ModulatedGraphConv

    p = GraphConv(D, D) if bn else ModulatedGraphConv(D, D)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.randn(t.shape, generator=g) * (D ** -0.5 if name.endswith("W") else 0.5))
        if bn:
            p.bn.weight.copy_(1 + 0.1 * torch.randn(D, generator=g))
            p.bn.bias.copy_(0.1 * torch.randn(D, generator=g))
            p.bn.running_mean.copy_(0.3 * torch.randn(D, generator=g))
            p.bn.running_var.copy_(1 + torch.rand(D, generator=g))
    return cast_params_bf16(p).eval().to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("stage", ["bn_relu", "residual", "output", "strided"])
@pytest.mark.parametrize("N", [128, 160])
def test_gconv_epilogue_matches_plain_version(cuda, N, stage):
    """The kernel against its plain statement at the bulk (128) and
    mesh-guided (160) rows, D = 1024: BatchNorm and ReLU, with the residual
    add, with those stages off (the output convolution's arithmetic), and
    h0, h1 read through the strides of one [N, 24, 2D] product. Bar: one
    bf16 ulp at the larger of each output's magnitude and 1/256 of the
    largest (the f32 sums round in another order; where BatchNorm's shift
    cancels the sum, that rounding is of the terms' size, not the
    output's); every launch is counted."""
    from egohmr_tpu_torch.models.egohmr import _adjacency

    D = 1024
    p = _random_gconv(D, stage != "output", seed=N, device=cuda)
    gc = p if stage == "output" else p.gconv
    g = torch.Generator().manual_seed(N + 1)
    x = torch.randn(N, 24, D, generator=g).to(cuda, torch.bfloat16)
    residual = (torch.relu(torch.randn(N, 24, D, generator=g)).to(cuda, torch.bfloat16)
                if stage in ("residual", "strided") else None)
    with torch.no_grad():
        if stage == "strided":
            h = x @ torch.cat([gc.W[0], gc.W[1]], dim=-1)
            h0, h1 = h[..., :D], h[..., D:]
        else:
            h0, h1 = x @ gc.W[0], x @ gc.W[1]
        c = epilogue.build_constants(gc, _adjacency(cuda), None if stage == "output" else p.bn)
        before = epilogue.gconv_fused
        got = epilogue.gconv_epilogue(c, h0, h1, residual)
        torch.cuda.synchronize()
        assert epilogue.gconv_fused == before + 1
        ref = epilogue.gconv_epilogue_reference(c, h0, h1, residual).float()
    assert got.shape == (N, 24, D) and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    mag = torch.maximum(ref.abs(), ref.abs().max() / 256)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert ((got.float() - ref).abs() <= ulp).all()


@pytest.mark.gpu
def test_gconv_epilogue_rejects_what_it_does_not_take(cuda):
    from egohmr_tpu_torch.models.egohmr import _adjacency

    p = _random_gconv(64, True, seed=1, device=cuda)
    c = epilogue.build_constants(p.gconv, _adjacency(cuda), p.bn)
    h = torch.randn(2, 24, 64, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="bf16"):
        epilogue.gconv_epilogue(c, h.float(), h)
    with pytest.raises(ValueError, match="unit channel stride"):
        epilogue.gconv_epilogue(c, h.transpose(0, 1), h)
    with pytest.raises(ValueError, match="residual"):
        epilogue.gconv_epilogue(c, h, h, h[:1])
    odd = c._replace(m=c.m[:, :63], vec=c.vec[:, :63])
    with pytest.raises(ValueError, match="multiples of 2"):
        epilogue.gconv_epilogue(odd, h[..., :63], h[..., :63])


@pytest.mark.gpu
@pytest.mark.parametrize("guided", [False, True], ids=["bulk-ddim5", "mesh-guided-ddpm50"])
def test_replayed_request_fuses_every_graph_convolution(cuda, guided):
    """The GCN at its full width (1024 x 4; the rest tiny): a replayed bulk
    request (unguided DDIM-5) and a replayed mesh-guided request (DDPM-50,
    guided on 11 steps) equal their eager runs bit for bit, and count 45
    and 450 fused graph convolutions (9 a denoiser call: the input one and
    two in each residual block), by the replay accounting and by the
    profiler's count of the kernel in the graph."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from egohmr_tpu_torch.data import synthetic_batch
    from egohmr_tpu_torch.diffusion import GuidanceConfig, make_schedule
    from egohmr_tpu_torch.models import BodyRepStats, EgoHMR
    from egohmr_tpu_torch.serving import MESH_OUTPUT_KEYS, Predictor
    from egohmr_tpu_torch.smpl import make_synthetic_model

    torch.backends.cudnn.allow_tf32 = False
    cfg, _ = _tiny_stage2(cuda, pointnet_hidden_dim=256, gcn_hid_dim=1024, gcn_layers=4)
    model = init_random_(EgoHMR(cfg), seed=0).eval()
    sampler, respacing, want = ("ddpm", "", 450) if guided else ("ddim", "ddim5", 45)
    pred = Predictor(model, cfg, make_synthetic_model(num_vertices=512),
                     BodyRepStats(torch.zeros(144), torch.ones(144)),
                     make_schedule(50, "cosine", respacing), device=cuda, batch_size=4,
                     num_samples=2, sampler=sampler, with_guidance=guided,
                     guidance=GuidanceConfig(cond_grad_weight=60.0),
                     output_keys=MESH_OUTPUT_KEYS)
    batch = synthetic_batch(4, num_scene_points=2048, img_size=64, seed=2)
    pred.warmup(batch)
    before, before_resnet = epilogue.gconv_fused, resnet_epi.resnet_fused
    torch.cuda.synchronize(cuda)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = pred(batch, seed=3)
        torch.cuda.synchronize(cuda)
    def kernels(name):
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and re.search(rf"\b{name}\b", e.key))

    assert epilogue.gconv_fused - before == kernels("gconv_epilogue_kernel") == want
    # the image encoder's glue: 17 passes a ResNet-18 forward, once a request
    assert resnet_epi.resnet_fused - before_resnet == kernels("resnet_epilogue_kernel") == 17
    eager = pred.eager(batch, seed=3)
    for k in eager:
        assert (got[k] == eager[k]).all(), k


def _random_bn2d(C, g):
    bn = torch.nn.BatchNorm2d(C).eval()
    with torch.no_grad():
        bn.weight.copy_(1 + 0.1 * torch.randn(C, generator=g))
        bn.bias.copy_(0.1 * torch.randn(C, generator=g))
        bn.running_mean.copy_(0.3 * torch.randn(C, generator=g))
        bn.running_var.copy_(1 + torch.rand(C, generator=g))
    return bn


@pytest.mark.gpu
@pytest.mark.parametrize("B", [64, 16, 5, "ragged"])
def test_resnet_epilogue_matches_plain_version(cuda, B):
    """The kernel against its plain statement at every pass shape of
    ResNet-50 at B = 64 (bulk), 16 (mesh-guided) and 5 (volsdf), and at
    3 x 5 x 5 rows (75: neither even nor a multiple of a block's rows),
    written in place: bit for bit (the kernel rounds each f32 product and
    sum as the statement does, and the output once); the residual is left
    as it was; every launch is counted."""
    cl = torch.channels_last
    g = torch.Generator().manual_seed(11)
    gd = torch.Generator(device=cuda).manual_seed(12)
    shapes = ([(3, C, 5, form) for C, _, form, _ in resnet_epi.RESNET50_PASSES]
              if B == "ragged"
              else [(B, C, H, form) for C, H, form, _ in resnet_epi.RESNET50_PASSES])
    for N, C, H, form in shapes:
        bn, bn_ds = _random_bn2d(C, g).to(cuda), _random_bn2d(C, g).to(cuda)
        c = resnet_epi.build_constants(bn)
        c_ds = resnet_epi.build_constants(bn_ds) if form == 2 else None
        a = torch.randn(N, C, H, H, device=cuda, generator=gd).bfloat16().contiguous(
            memory_format=cl)
        r = None
        if form:
            r = torch.randn(N, C, H, H, device=cuda, generator=gd).bfloat16().contiguous(
                memory_format=cl)
            r = torch.relu(r) if form == 1 else r
        with torch.no_grad():
            ref = resnet_epi.resnet_epilogue_reference(a, c, r, c_ds)
            r_before = None if r is None else r.clone()
            before = resnet_epi.resnet_fused
            got = resnet_epi.resnet_epilogue(a, c, r, c_ds)
            torch.cuda.synchronize()
        assert resnet_epi.resnet_fused == before + 1
        assert got.data_ptr() == a.data_ptr() and got.is_contiguous(memory_format=cl)
        assert torch.isfinite(got.float()).all()
        assert torch.equal(got, ref), (N, C, H, form)
        assert r is None or torch.equal(r, r_before)


@pytest.mark.gpu
def test_resnet_epilogue_rejects_what_it_does_not_take(cuda):
    """On the card too the wrapper raises, with no fallback, on memory the
    kernel cannot read as NHWC rows 16 bytes at a time."""
    g = torch.Generator().manual_seed(13)
    c = resnet_epi.build_constants(_random_bn2d(64, g).to(cuda))
    a = torch.randn(2, 64, 7, 7, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="channels_last"):
        resnet_epi.resnet_epilogue(a, c)
    flat = torch.zeros(2 * 7 * 7 * 64 + 1, device=cuda, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="aligned"):
        resnet_epi.resnet_epilogue(flat.view(2, 7, 7, 64).permute(0, 3, 1, 2), c)
    with pytest.raises(ValueError, match="different devices"):
        resnet_epi.resnet_epilogue(a.contiguous(memory_format=torch.channels_last), c.cpu())


@pytest.mark.gpu
def test_resnet50_forward_fuses_every_pass(cuda, monkeypatch):
    """One bf16 ResNet-50 forward at B = 64, 224 x 224, under no_grad:
    49 fused passes by the wrapper's count and by the profiler, none in f32
    or under autograd; the features against the plain bf16 path on the
    card (`_fused` turned off) within 0.05 of the largest, at a cosine of
    at least 0.999 per image, and no further from the f32 forward's on
    average than the plain bf16 path's, within 10%."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from egohmr_tpu_torch.nn import ResNet, cast_params_bf16, resnet_forward
    from egohmr_tpu_torch.nn import resnet as resnet_module

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(14)
    model = ResNet(50).eval()
    g = torch.Generator().manual_seed(15)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.load_state_dict(_random_bn2d(m.num_features, g).state_dict())
    model = model.to(cuda)
    m16 = cast_params_bf16(model)
    x = torch.randn(64, 224, 224, 3, generator=g).to(cuda)
    with torch.no_grad():
        before = resnet_epi.resnet_fused
        f32 = resnet_forward(model, x)
        assert resnet_epi.resnet_fused == before
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fused = resnet_forward(m16, x.bfloat16())
            torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and re.search(r"\bresnet_epilogue_kernel\b", e.key))
    assert resnet_epi.resnet_fused - before == kernels == 49
    with torch.enable_grad():
        resnet_forward(m16, x.bfloat16())  # weights that require grad: the plain path
    assert resnet_epi.resnet_fused - before == 49
    monkeypatch.setattr(resnet_module, "_fused", lambda *a: False)
    with torch.no_grad():
        plain = resnet_forward(m16, x.bfloat16())
    fused, plain = fused.float(), plain.float()
    assert torch.isfinite(fused).all()
    assert (fused - plain).abs().max().item() <= 0.05 * plain.abs().max().item()
    assert torch.nn.functional.cosine_similarity(fused, plain, dim=-1).min().item() >= 0.999
    assert (fused - f32).abs().mean() <= 1.1 * (plain - f32).abs().mean()
