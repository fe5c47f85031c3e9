"""The guided request on the served path (`serving.Predictor` with a
collision backend) on the CPU, at tiny widths on weights drawn from a
seed, against the benchmark's plain reference of EgoHMR-VolSMPL
(`hmrbench/reference/egohmr-volsmpl.py`, plain PyTorch): the learned SDF's
guided DDPM request and its per-step gradient, the mesh SDF's gradient
against `make_guidance_fn`; the guided steps' record and its step
identity on all three backends (the occupancy net the SDF net with its
head negated); the whole scene (`guidance_scene_points=None`) against as
many explicit points; the field in chunks against one chunk;
the counters; the refusals. The card's side (the captured request against
eager) is in `tests/test_torch_gpu.py` and `chip_smoke.py` phase 15."""
import numpy as np
import pytest
import torch

from egohmr_tpu_torch.collision import neural_occupancy as occ
from egohmr_tpu_torch.collision.neural_occupancy import OccupancyConfig, PartFieldNet
from egohmr_tpu_torch.collision.neural_sdf import SDFNetConfig, make_volsdf_guidance_fn
from egohmr_tpu_torch.diffusion import GuidanceConfig, draw_step_noise, make_schedule
from egohmr_tpu_torch.models import (BodyRepStats, Condition, EgoHMR, EgoHMRConfig,
                                     make_guidance_fn)
from egohmr_tpu_torch.serving import GUIDANCE_RECORD, Predictor
from egohmr_tpu_torch.smpl import SMPLModel
from hmrbench.lib import common, field, synth

from .torch_parity import pin_torch_threads  # noqa: F401 (pins torch's threads)

REF = common.load_file(common.BENCH / "reference" / "egohmr-volsmpl.py")
# the configuration's model at tiny widths
MODEL = dict(common.read_json(common.BENCH / "configs" / "egohmr-volsmpl.json")["model"],
             pointnet_hidden_dim=32, scene_feat_dim=32, transl_embed_dim=16,
             timestep_embed_dim=32, input_process_dim=32, gcn_hid_dim=64, gcn_layers=2,
             img_size=32)
NET = dict(latent_dim=8, hidden_dim=16, num_layers=3, part_embed_dim=4, trunc=0.15)
B, S, T, P = 2, 2, 10, 256
GCFG = dict(cond_grad_weight=30.0, ddpm_threshold=3, ddpm_fixed_below=1, ddpm_fixed_coeff=0.01)
STATS = (torch.zeros(144), torch.ones(144))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    """(model config, state dict, body tables, field net and its state
    dict, NumPy batches of 256 and of 20,000 scene points)."""
    cfg = EgoHMRConfig(**MODEL)
    model = EgoHMR(cfg)
    W = synth.weights(model, 3, CPU)
    tables = synth.body_tables({"num_vertices": 66, "closed_body": {"rings": 8, "slices": 8}},
                               CPU)
    small = synth.batches(1, B, scene_points=P, img_size=32, seed=5, device=CPU)[0]
    full = synth.batches(1, B, scene_points=20000, img_size=32, seed=6, device=CPU)[0]
    net = PartFieldNet(SDFNetConfig(**NET))
    scene = torch.from_numpy(small["scene_pcd_verts_full"] - small["smpl_params"]["transl"][:, None])
    rot = REF.pose_rotations(torch.randn(B, 144, generator=torch.Generator().manual_seed(4)), STATS)
    Wf = field.field_weights(net, NET, 4, tables, scene, rot, torch.zeros(B, 10), CPU)
    net.load_state_dict(Wf)
    return cfg, W, tables, net, Wf, small, full


def collision_net(setup, backend):
    """The learned backend's net, a copy of the setup's SDF net; for the
    occupancy backend with its head negated, so that the occupancy is over
    0.5 where the SDF is negative; None for the mesh SDF."""
    if backend not in ("volsdf", "occupancy"):
        return None
    W = setup[3].state_dict()
    if backend == "volsdf":
        net = PartFieldNet(setup[3].cfg)
    else:
        net = PartFieldNet(OccupancyConfig(**{k: v for k, v in NET.items() if k != "trunc"}))
        head = f"decoder.{NET['num_layers'] - 1}."
        W = {k: -v if k.startswith(head) else v for k, v in W.items()}
    net.load_state_dict(W)
    return net.requires_grad_(False)


def predictor(setup, backend="volsdf", **kw):
    cfg, W, tables, _, _, _, _ = setup
    model = EgoHMR(cfg)
    model.load_state_dict(W)
    kw = dict(dict(sampler="ddpm", with_guidance=True, record_guidance=True,
                   guidance=GuidanceConfig(**GCFG), collision_backend=backend,
                   collision_net=collision_net(setup, backend)), **kw)
    return Predictor(model.eval(), cfg, SMPLModel(**tables), BodyRepStats(*STATS),
                     make_schedule(T, "cosine", ""), device="cpu", batch_size=B,
                     num_samples=S, bf16=False, pointnet_impl="xla", **kw)


def guide(backend, scene_points="all"):
    g = dict(GCFG, backend=backend, scene_points=scene_points)
    return dict(g, net=NET) if backend == "volsdf" else g


def records(out):
    """[B, S, G, 4, 144] -> [G, 4, B * S, 144]."""
    rec = out[GUIDANCE_RECORD]
    return torch.from_numpy(rec.reshape((-1,) + rec.shape[2:])).permute(1, 2, 0, 3)


def test_learned_guided_request_matches_the_reference(setup):
    """The learned SDF's guided DDPM request, eager on the CPU in f32, against
    the plain reference: every guided step's gradient at the program's own
    x_t at rtol 1e-4, atol 1e-6 (the port's guidance bar), the guided
    samples at rtol 1e-3, atol 1e-4. The weight is the configuration's
    times 1000, so that the guidance moves the samples by over 1e-3, ten
    times the bar (at the configuration's it moves them by under 1e-5)."""
    cfg, W, tables, net, Wf, batch, _ = setup
    gcfg = dict(GCFG, cond_grad_weight=1000 * GCFG["cond_grad_weight"])
    out = predictor(setup, guidance=GuidanceConfig(**gcfg))(batch, seed=7)
    free = predictor(setup, with_guidance=False, record_guidance=False)(batch, seed=7)
    REF.exact()
    bt = synth.to_device(batch, CPU)
    with torch.no_grad():
        ref = REF.sample(W, MODEL, tables, STATS, REF.ddpm_schedule(T, "cosine", CPU), bt, 7, S,
                         guide("volsdf"), gcfg, Wf=Wf)
    got = out["pred_pose_6d"].reshape(B * S, 144)
    assert np.abs(got - free["pred_pose_6d"].reshape(B * S, 144)).max() > 1e-3
    np.testing.assert_allclose(got, ref["pred_pose_6d"].numpy(), rtol=1e-3, atol=1e-4)
    rec = records(out)
    assert rec.shape == (GCFG["ddpm_threshold"] + 1, 4, B * S, 144)
    g = REF.guidance(guide("volsdf"), tables, STATS, REF.canonical_scene(bt, S),
                     torch.from_numpy(out["pred_betas"].reshape(B * S, 10)), B * S, Wf)
    for x, _, grad, _ in rec:
        want = g(x)
        assert want.abs().max() > 1e-5
        np.testing.assert_allclose(grad.numpy(), want.numpy(), rtol=1e-4, atol=1e-6)


def test_mesh_guidance_matches_the_reference(setup):
    """`make_guidance_fn` (the scene's 4,096 nearest points, shuffled, then
    the 1,024 nearest the body's box each step, kernel K2's plain version)
    against the reference's brute-force mesh SDF, at rtol 1e-4, atol
    1e-6."""
    cfg, _, tables, _, _, _, _ = setup
    rng = np.random.RandomState(0)
    n = 3
    scene = torch.tensor((rng.randn(n, 1500, 3) * [0.3, 0.5, 0.2]).astype(np.float32))
    betas = torch.tensor((rng.randn(n, 10) * 0.3).astype(np.float32))
    cond = Condition(**{f: torch.zeros(n, 1) for f in Condition._fields})._replace(
        pred_betas=betas, scene_pcd=scene)
    x = torch.tensor((rng.randn(n, 144) * 0.3).astype(np.float32))
    with torch.no_grad():
        got = make_guidance_fn(None, cfg, SMPLModel(**tables), cond, BodyRepStats(*STATS))(
            x, torch.zeros(n, dtype=torch.int64))
    want = REF.guidance(guide("sdf", 4096), tables, STATS, scene, betas, n)(x)
    assert want.abs().max() > 1e-5
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("backend", ["volsdf", "sdf", "occupancy"])
def test_record_holds_each_guided_steps_identity(setup, backend):
    """Each guided step's record: its output is the unguided mean plus c_t
    g_t plus sigma_t z_t, with z_t the request's own step noise (drawn
    again from its seed); one step's output is the next one's input; the
    counters count the guided steps and the field's rows."""
    pred = predictor(setup, backend)
    out = pred(setup[5], seed=9)
    rec = records(out)
    G, rows = GCFG["ddpm_threshold"] + 1, B * S
    assert rec.shape == (G, 4, rows, 144) and rec.dtype == torch.float32
    sched = make_schedule(T, "cosine", "")
    gen = torch.Generator().manual_seed(9)
    torch.randn((rows, 144), generator=gen)
    z = draw_step_noise(sched, gen, (rows, 144), sampler="ddpm")
    for j, (x, mu, grad, o) in enumerate(rec):
        t = G - 1 - j
        c = GCFG["cond_grad_weight"] * (sched.posterior_variance[t] if t >= 1 else 0.01)
        noise = torch.exp(0.5 * sched.posterior_log_variance_clipped[t]) * z[T - 1 - t] \
            if t else 0.0
        assert (c * grad).abs().max() > 0
        np.testing.assert_allclose((o - noise - c * grad).numpy(), mu.numpy(), atol=2e-6)
        if j + 1 < G:
            assert torch.equal(rec[j + 1, 0], o)
    assert pred.guided_steps == G
    assert pred.field_rows == (0 if backend == "sdf" else G * rows * 24 * P)


def test_whole_scene_equals_as_many_explicit_points(setup):
    """`guidance_scene_points=None` (every point of a 20,000-point scene)
    against 20,000 explicit points: the same request, bit for bit; the
    field's rows count all of them."""
    full = setup[6]
    a, b = predictor(setup, guidance_scene_points=None), predictor(
        setup, guidance_scene_points=20000)
    out_a, out_b = a(full, seed=3), b(full, seed=3)
    for k in out_a:
        np.testing.assert_array_equal(out_a[k], out_b[k])
    assert a.field_rows == b.field_rows == (GCFG["ddpm_threshold"] + 1) * B * S * 24 * 20000
    capped = predictor(setup)(full, seed=3)  # the default cap, 4,096 points
    assert np.abs(capped["pred_pose_6d"] - out_a["pred_pose_6d"]).max() > 0


def test_field_in_chunks_equals_one_chunk(setup, monkeypatch):
    """The learned guidance's forward and backward over the points in
    chunks (each chunk's gradient at the part codes summed, then taken back
    to x_t) against one chunk: the gradient within f32 summation order."""
    _, _, tables, net, _, _, _ = setup
    rng = np.random.RandomState(1)
    n = 3
    cond = Condition(**{f: torch.zeros(n, 1) for f in Condition._fields})._replace(
        pred_betas=torch.tensor((rng.randn(n, 10) * 0.3).astype(np.float32)),
        scene_pcd=torch.tensor(rng.randn(n, 2000, 3).astype(np.float32)))
    x = torch.tensor((rng.randn(n, 144) * 0.3).astype(np.float32))
    t = torch.zeros(n, dtype=torch.int64)

    def grad():
        fn = make_volsdf_guidance_fn(net, SMPLModel(**tables), cond, BodyRepStats(*STATS),
                                     max_scene_points=None)
        with torch.no_grad():
            return fn(x, t)

    whole = grad()
    monkeypatch.setattr(occ, "QUERY_ROWS", n * 24 * 300)
    assert occ.chunk_points(n, 2000) == 300
    chunked = grad()
    assert whole.abs().max() > 1e-5
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-5, atol=1e-8)


def test_unguided_and_unrecorded_requests_are_as_before(setup):
    """Without guidance the request has no record, counts nothing and equals
    a Predictor built without the new options; a guided request without
    `record_guidance` returns no record."""
    plain = predictor(setup, with_guidance=False, record_guidance=False,
                      collision_backend="sdf", collision_net=None)
    out = plain(setup[5], seed=2)
    assert GUIDANCE_RECORD not in out
    assert plain.guided_steps == plain.field_rows == 0
    cfg, W, tables, _, _, batch, _ = setup
    model = EgoHMR(cfg)
    model.load_state_dict(W)
    before = Predictor(model.eval(), cfg, SMPLModel(**tables), BodyRepStats(*STATS),
                       make_schedule(T, "cosine", ""), device="cpu", batch_size=B,
                       num_samples=S, bf16=False, pointnet_impl="xla", sampler="ddpm")
    ref = before(batch, seed=2)
    assert sorted(ref) == sorted(out)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k])
    assert GUIDANCE_RECORD not in predictor(setup, record_guidance=False)(batch, seed=2)


def test_refusals(setup):
    """A learned backend without a net, a net for the mesh SDF, an unknown
    backend, and a record without guidance or of DDIM's steps are
    refused."""
    net = setup[3]
    with pytest.raises(ValueError, match="needs a learned"):
        predictor(setup, collision_net=None)
    with pytest.raises(ValueError, match="takes none"):
        predictor(setup, "sdf", collision_net=net)
    with pytest.raises(ValueError, match="unknown collision_backend"):
        predictor(setup, "mesh", collision_net=None)
    with pytest.raises(ValueError, match="needs with_guidance"):
        predictor(setup, with_guidance=False)
    with pytest.raises(ValueError, match="sampler 'ddpm'"):
        predictor(setup, sampler="ddim")


def test_pieces_of_the_checks_yardstick(setup):
    """The guided cells' check of the learned field's gradient
    (`REF.guidance_ties`, float64, and `drivers/guided.py:tie_gap`): its
    gradient is the float32 reference's to rounding; each choice near an
    edge (a near tie in the min over parts, a decoder or an encoder ReLU
    near 0) gives the float64 gradient with that choice made otherwise,
    less the gradient, as an independent forward computes it; a gradient
    that makes a choice either way, or shares it, reads no gap, and one
    that makes it twice over reads one change."""
    _, _, tables, _, Wf, batch, _ = setup
    D = common.load_file(common.BENCH / "drivers" / "guided.py")
    scene = REF.canonical_scene(synth.to_device(batch, CPU), S).double()
    n = B * S
    x = torch.randn(n, 144, generator=torch.Generator().manual_seed(4)).double()
    betas = torch.zeros(n, 10).double()
    want, alt, what = REF.field_guidance_ties(Wf, NET, tables, STATS, scene, betas, n,
                                              tie=0.02, kink=0.05)(x)
    assert want.dtype == torch.float64
    g32 = REF.guidance(guide("volsdf"), tables, STATS, scene.float(), betas.float(), n,
                       Wf)(x.float())
    assert float((g32.double() - want).norm() / want.norm()) < 1e-5

    W = {k: v.double() for k, v in Wf.items()}
    S64, st = REF._f64(tables), REF._f64(STATS)
    scale = torch.tensor(REF.GUIDE_JOINT_SCALE, dtype=torch.float64)[None, :, None]
    L = NET["num_layers"]

    def lin(name, h):
        return h @ W[name + ".weight"].T + W[name + ".bias"]

    def changed(body, point, part, kind, index):
        """The float64 gradient with one choice made otherwise, by hand."""
        xx = x.clone().requires_grad_(True)
        R, Pj = REF.skeleton(S64, betas, REF.pose_rotations(xx, st))
        dec0 = REF.field_latent(W, NET, R, Pj, betas)
        sdf = NET["trunc"] * torch.tanh(REF.field_raw(W, NET, R, Pj, dec0, scene))
        v = sdf.amin(1).clone()
        if kind == -1:
            v[body, point] = sdf[body, index, point]
        else:
            d0 = dec0[body, part]
            if kind == -2:
                feats = torch.cat([R[body, part].flatten(), Pj[body, part], betas[body],
                                   W["part_embed"][part]])
                h = lin("encoder.l0", feats)
                on = h > 0
                on[index] = ~on[index]
                latent = lin("encoder.l1", h * on)
                d0 = latent @ W["decoder.0.weight"][:, 3:].T + W["decoder.0.bias"]
            pts = scene[body] if kind == -2 else scene[body, point:point + 1]
            h = (pts - Pj[body, part]) @ R[body, part] @ W["decoder.0.weight"][:, :3].T + d0
            for i in range(1, L):
                on = h > 0
                if kind == i - 1:
                    on[:, index] = ~on[:, index]
                h = lin(f"decoder.{i}", h * on)
            row = NET["trunc"] * torch.tanh(h[:, 0])
            if kind == -2:
                moved = sdf[body].argmin(0) == part
                v[body, moved] = row[moved]
            else:
                v[body, point] = row[0]
        loss = torch.sum(torch.clamp(-v, min=0.0) ** 2) / (P * n)
        return (-torch.autograd.grad(loss, xx)[0].reshape(n, 24, 6) * scale).reshape(n, 144)

    body = what[:, 0].numpy()
    kinds = what[:, 3]
    picked = []
    for kind in (-1, -2, 0, L - 2):
        found = (kinds == kind).nonzero()[:, 0].tolist()
        assert found, f"no choice of kind {kind} at these settings"
        picked += [found[0], found[-1]]
    for k in picked:
        nb, point, part, kind, index = what[k].tolist()
        change = changed(nb, point, part, kind, index) - want
        assert float(change[torch.arange(n) != nb].abs().max()) == 0.0
        torch.testing.assert_close(change[nb], alt[k], rtol=1e-9, atol=1e-18)
        size = float(alt[k].norm())
        for share, gap in ((1.0, 0.0), (0.5, 0.0), (2.0, size)):
            r = np.zeros((n, 144))
            r[nb] = share * alt[k].numpy()
            # twice over, against this choice alone: the others may explain some
            cols = slice(k, k + 1) if share > 1 else slice(None)
            assert abs(D.tie_gap(r, alt.numpy()[cols], body[cols]) - gap) <= 1e-6 * size
    r = np.random.default_rng(0).normal(size=(n, 144))
    assert D.tie_gap(r, alt.numpy()[:0], body[:0]) == pytest.approx(np.linalg.norm(r))
