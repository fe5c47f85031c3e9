"""Plain reference of EgoHMR-VolSMPL, the yardstick of the guided cells:
stage 2 (EgoHMR, `egohmr-stage2.py`) sampled by DDPM with collision
guidance on the low-noise steps, the guidance's gradient from a learned
part-wise signed-distance field over the whole scene cloud (the
`egohmr-volsmpl` configuration) or from the mesh SDF (the `egohmr-stage2`
configuration's guided cell).

Plain PyTorch, from the published description (sanweiliti/EgoHMR
`models/egohmr/egohmr_volsmpl.py` and `test_egohmr_volsmpl.py` for the
guidance; the mesh SDF after `egohmr.py`'s collision score) and, for the
field, from the port's shipped part-wise SDF layout (the configuration's
`collision.net`). It imports nothing of the program: the
weights, body tables and inputs are the benchmark's own (`lib/synth.py`),
x_T and every step's noise are drawn here again from the request's seed,
and the schedule is worked out again from the configuration. The layers of
stage 2 come from `egohmr-stage2.py` and `plain.py`.

The guided DDPM step (t counts down from T - 1 to 0):
    x_{t-1} = mu_t(x0(x_t), x_t) + c_t g_t + sigma_t z_t   (no z at t = 0)
with g_t = -d/dx_t of the batch mean of each body's collision loss, scaled
per joint (the hips x1, the knees, ankles and feet x2, the rest 0), on the
steps t <= `ddpm_threshold`; c_t is the guidance weight times the
posterior variance at t >= `ddpm_fixed_below`, the weight times
`ddpm_fixed_coeff` below.

The learned field (`field_sdf`): the posed skeleton's 24 part frames (each
joint's global rotation and position); a latent per (body, part) from the
flattened frame, the betas and a learned part code (two linears, ReLU);
each scene point taken into each part's frame; a decoder whose first layer
takes the local point and the latent (its latent half computed once per
(body, part)), ReLU between layers, one output per (point, part), bounded
by trunc x tanh; the min over the parts. A body's loss is the mean over
all its scene points of the squared penetration max(-sdf, 0)^2, evaluated
here in blocks of points, each block's gradient taken back to x_t and
summed.

The mesh SDF (`mesh_guidance`): the scene's 4,096 points nearest the
canonical origin, shuffled by a fixed permutation; at each guided step the
posed mesh, its area-weighted vertex normals, the 1,024 kept points
nearest the body's bounding box, the box's mask, each point's nearest
vertex by brute force, the sign from that vertex's normal; the loss the
masked mean of the squared penetration, differentiated through the
selected vertices' positions (the selection held fixed).

Departures from the published description, each the program's as well:
* the field is the port's distilled part-wise SDF in the layout and at
  the widths of its shipped artifact (`artifacts/volsdf_synthetic.npz`:
  one encoder and decoder shared by the parts, a part code, ReLU, a
  tanh-bounded head), not VolumetricSMPL's network, which the published
  code calls and which is not in the repository; its weights come from
  the seed (`lib/field.py`);
* the joint scale of the gradient and the fixed coefficient below step 5
  follow the JAX rebuild (`models/egohmr.py:_GUIDE_JOINT_SCALE`,
  `diffusion/sampler.py:_ddpm_step`);
* the mesh SDF's scene caps (4,096 then 1,024 points) and the fixed
  shuffle are the JAX rebuild's, where the published code scores every
  point in the box; ties in a cap go to the lowest index after the
  shuffle.

Every matmul runs in float32 with TF32 off (`exact()`), but for the
yardstick of a program's learned-field gradient (`guidance_ties`), which
runs in float64 and lists the edges of the field's pieces (near ties in
the min over parts, ReLU inputs near 0) that float32 may cross. The control runs
each part one precision below what the configuration states: the
conditioning and the denoiser (bfloat16 in the configuration) in float8
e4m3 (`p`), SMPL and the field (float32, TF32 off) in TF32 (`q`); under
autograd the field's rounding passes the gradient straight through.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from hmrbench.lib.common import load_file
from hmrbench.reference.plain import F32, Prec, Tensor, rot6d_to_rotmat, smpl

_STAGE2 = load_file(Path(__file__).with_name("egohmr-stage2.py"))
# stage 2's layers, the drivers' API of the configuration's reference
exact, condition, denoise, adjacency = (_STAGE2.exact, _STAGE2.condition, _STAGE2.denoise,
                                        _STAGE2.adjacency)
posed, camera, outputs, Cond = _STAGE2.posed, _STAGE2.camera, _STAGE2.outputs, _STAGE2.Cond

# per-joint scale of the guidance's gradient: the hips x1, knees, ankles and
# feet x2, the pelvis and the upper body 0
GUIDE_JOINT_SCALE = [0.0] * 24
for _j in (1, 2):
    GUIDE_JOINT_SCALE[_j] = 1.0
for _j in (4, 5, 7, 8, 10, 11):
    GUIDE_JOINT_SCALE[_j] = 2.0
PARTS = 24
BLOCK_ROWS = 1 << 20  # (body, part, point) rows of one block of the field
# a near tie in the min over parts (m): a float32 field's part value lies
# within 6e-7 m of the float64 one at the cell's widths, so two parts
# closer than twice that may swap; this is eight times as wide
TIE_SDF = 1e-5
# a ReLU input this near 0 may fall on either side in float32, whose
# decoder outputs lie within about 1e-6 of float64's at the cell's widths
KINK = 1e-5
MESH_SCENE_POINTS, MESH_STEP_POINTS = 4096, 1024


# ------------------------------------------------------------- schedule
class DDPMSchedule(NamedTuple):
    posterior_variance: Tensor
    log_variance_clipped: Tensor
    coef1: Tensor
    coef2: Tensor
    timestep_map: Tensor

    @property
    def steps(self) -> int:
        return self.timestep_map.shape[0]


def ddpm_schedule(num_timesteps: int, name: str, device) -> DDPMSchedule:
    """The cosine schedule of improved DDPM, every step kept, tables in
    float64 then float32."""
    if name != "cosine":
        raise ValueError(f"schedule {name!r}: the reference has the cosine one")

    def abar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    T = num_timesteps
    betas = np.array([min(1 - abar((i + 1) / T) / abar(i / T), 0.999) for i in range(T)])
    ac = np.cumprod(1.0 - betas)
    ac_prev = np.append(1.0, ac[:-1])
    var = betas * (1.0 - ac_prev) / (1.0 - ac)

    def t32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return DDPMSchedule(
        posterior_variance=t32(var), log_variance_clipped=t32(np.log(np.append(var[1], var[1:]))),
        coef1=t32(betas * np.sqrt(ac_prev) / (1.0 - ac)),
        coef2=t32((1.0 - ac_prev) * np.sqrt(1.0 - betas) / (1.0 - ac)),
        timestep_map=torch.arange(T, device=device))


def guide_coeff(sched: DDPMSchedule, gcfg: Dict, t: int) -> Tensor:
    """c_t, the guidance's coefficient at step t."""
    if t >= gcfg["ddpm_fixed_below"]:
        return gcfg["cond_grad_weight"] * sched.posterior_variance[t]
    return torch.tensor(gcfg["cond_grad_weight"] * gcfg["ddpm_fixed_coeff"],
                        device=sched.coef1.device)


def sigma(sched: DDPMSchedule, t: int) -> Tensor:
    """The step's noise scale (0 at t = 0)."""
    if t == 0:
        return torch.zeros((), device=sched.coef1.device)
    return torch.exp(0.5 * sched.log_variance_clipped[t])


def draws(seed: int, rows: int, steps: int, device):
    """x_T [rows, 144], then the noise of each step that adds noise [steps -
    1, rows, 144] (the k-th for loop step k, t = steps - 1 - k), from one
    generator on `device` seeded with the request's seed."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    x = torch.randn((rows, 144), generator=gen, device=device)
    z = [torch.randn((rows, 144), generator=gen, device=device) for _ in range(steps - 1)]
    return x, torch.stack(z)


# ------------------------------------------------------------- posing
def pose_rotations(x: Tensor, stats) -> Tensor:
    """Normalised 6-D poses [N, 144] -> local rotations [N, 24, 3, 3]."""
    return rot6d_to_rotmat(x * stats[1] + stats[0]).reshape(-1, 24, 3, 3)


def skeleton(S, betas: Tensor, rot: Tensor, q: Prec = F32):
    """The posed skeleton without translation: each joint's global rotation
    [N, 24, 3, 3] and position [N, 24, 3]."""
    v_shaped = S["v_template"][None] + torch.einsum("nl,vcl->nvc", q(betas), q(S["shapedirs"]))
    J = torch.einsum("jv,nvc->njc", q(S["j_regressor"]), q(v_shaped))
    parents = S["parents"].tolist()
    R: List[Tensor] = [rot[:, 0]]
    P: List[Tensor] = [J[:, 0]]
    for k in range(1, 24):
        a = parents[k]
        R.append(q(R[a]) @ q(rot[:, k]))
        P.append(P[a] + (q(R[a]) @ q(J[:, k] - J[:, a])[..., None])[..., 0])
    return torch.stack(R, 1), torch.stack(P, 1)


# ---------------------------------------------------------- learned field
class Rounded(Prec):
    """A `Prec` whose rounding passes the gradient straight through: the
    control's TF32 under autograd."""

    def __call__(self, x: Tensor) -> Tensor:
        if not self.mode or not x.requires_grad:
            return super().__call__(x)
        return x + (super().__call__(x.detach()) - x.detach())


def _lin(Wf, name: str, x: Tensor, q: Prec, cols: slice = slice(None),
         bias: bool = True) -> Tensor:
    """x @ W[:, cols]^T (+ b) of the field's linear `name`."""
    y = q(x) @ q(Wf[name + ".weight"][:, cols]).T
    return y + Wf[name + ".bias"] if bias else y


def field_layout(fcfg: Dict) -> None:
    """Refuse a field layout other than the one implemented here: shared
    by the parts, ReLU, the tanh-bounded head."""
    layout = (fcfg.get("per_part_networks", False), fcfg.get("activation", "relu"),
              fcfg.get("bounded_output", True))
    if layout != (False, "relu", True):
        raise ValueError(f"field layout (per_part_networks, activation, bounded_output) = "
                         f"{layout}: the reference has the shared, ReLU, bounded one")


def _relu(x: Tensor, flip: Optional[Tensor]) -> Tensor:
    """ReLU, or with the units `flip` (bool, x's shape) on their other side."""
    return F.relu(x) if flip is None else x * ((x > 0) ^ flip)


def _encoder_in(Wf, fcfg: Dict, R: Tensor, P: Tensor, betas: Tensor, q: Prec = F32) -> Tensor:
    """The encoder's ReLU input [N, 24, hidden] of each (body, part): its
    frame, the betas and the part code through the first linear."""
    N = R.shape[0]
    feats = [R.reshape(N, PARTS, 9), P, betas[:, None].expand(N, PARTS, betas.shape[-1])]
    if fcfg["part_embed_dim"]:
        feats.append(Wf["part_embed"][None].expand(N, PARTS, fcfg["part_embed_dim"]))
    return _lin(Wf, "encoder.l0", torch.cat(feats, -1), q)


def field_latent(Wf, fcfg: Dict, R: Tensor, P: Tensor, betas: Tensor, q: Prec = F32,
                 flip: Optional[Tensor] = None) -> Tensor:
    """Each (body, part)'s share of the decoder's first layer, [N, 24,
    hidden]: the latent of the part's frame, the betas and the part code,
    times the first layer's latent columns, plus its bias. `flip`: the
    encoder's ReLUs to take on their other side."""
    field_layout(fcfg)
    h = _relu(_encoder_in(Wf, fcfg, R, P, betas, q), flip)
    latent = _lin(Wf, "encoder.l1", h, q)
    return _lin(Wf, "decoder.0", latent, q, slice(3, None))


def field_rows(Wf, fcfg: Dict, local: Tensor, d0: Tensor,
               flip: Optional[Tensor] = None):
    """The decoder on rows: points in their part's frame [M, 3] and the
    part's `field_latent` [M, hidden] -> (raw [M], each ReLU's input [L -
    1, M, hidden]); `flip` [L - 1, M, hidden]: ReLUs to take on their other
    side."""
    x = _lin(Wf, "decoder.0", local, F32, slice(0, 3), bias=False) + d0
    ins = []
    for i in range(1, fcfg["num_layers"]):
        ins.append(x)
        x = _lin(Wf, f"decoder.{i}", _relu(x, None if flip is None else flip[i - 1]), F32)
    return x[..., 0], torch.stack(ins)


def field_raw(Wf, fcfg: Dict, R: Tensor, P: Tensor, dec0: Tensor, pts: Tensor,
              q: Prec = F32) -> Tensor:
    """The decoder's raw output [N, 24, p] for points [N, p, 3]: each point
    in each part's frame, R_k^T (x - j_k), through the decoder."""
    local = q(pts[:, None] - P[:, :, None]) @ q(R)
    x = _lin(Wf, "decoder.0", local, q, slice(0, 3), bias=False) + dec0[:, :, None]
    for i in range(1, fcfg["num_layers"]):
        x = _lin(Wf, f"decoder.{i}", F.relu(x), q)
    return x[..., 0]


def field_sdf(Wf, fcfg: Dict, R: Tensor, P: Tensor, dec0: Tensor, pts: Tensor,
              q: Prec = F32) -> Tensor:
    """Signed distance [N, p] of points [N, p, 3] to the posed body: the
    min over parts of the bounded part-local field."""
    return torch.amin(fcfg["trunc"] * torch.tanh(field_raw(Wf, fcfg, R, P, dec0, pts, q)), dim=1)


def field_guidance(Wf, fcfg: Dict, S, stats, scene: Tensor, betas: Tensor, rows: int,
                   q: Prec = F32) -> Callable[[Tensor], Tensor]:
    """g(x_t) [N, 144]: minus the gradient of the batch mean (over `rows`
    bodies) of each body's mean squared penetration over all its scene
    points [N, P, 3], scaled per joint."""
    scale = torch.tensor(GUIDE_JOINT_SCALE, device=scene.device)[None, :, None]
    N, Pn = scene.shape[:2]
    block = max(1, BLOCK_ROWS // (N * PARTS))

    def g(x_t: Tensor) -> Tensor:
        grad = torch.zeros_like(x_t)
        with torch.enable_grad():
            x = x_t.detach().requires_grad_(True)
            R, P = skeleton(S, betas, pose_rotations(x, stats), q)
            dec0 = field_latent(Wf, fcfg, R, P, betas, q)
            for s in range(0, Pn, block):
                sdf = field_sdf(Wf, fcfg, R, P, dec0, scene[:, s:s + block], q)
                loss = torch.sum(torch.clamp(-sdf, min=0.0) ** 2) / (Pn * rows)
                grad -= torch.autograd.grad(loss, x, retain_graph=True)[0]
        return (grad.reshape(-1, 24, 6) * scale).reshape(x_t.shape)

    return g


def _f64(tree):
    """Every floating tensor of a dict or tuple in float64."""
    def one(t):
        return t.double() if t.is_floating_point() else t

    if isinstance(tree, dict):
        return {k: one(v) for k, v in tree.items()}
    return tuple(one(t) for t in tree)


def _penetration(sdf: Tensor) -> Tensor:
    return torch.clamp(-sdf, min=0.0) ** 2


def field_guidance_ties(Wf, fcfg: Dict, S, stats, scene: Tensor, betas: Tensor, rows: int,
                        tie: float = TIE_SDF, kink: float = KINK):
    """`field_guidance` in float64, with the pieces a float32 field may
    take otherwise: g(x_t) -> (grad [N, 144], alt [K, 144], what [K, 5]).
    `grad` is the gradient at float64's own pieces. The field's gradient is
    piecewise smooth, its pieces chosen by the min over parts and by the
    ReLUs; where float64 puts a choice within rounding of its edge, a
    float32 field may make it otherwise (or, on an exact tie, share the
    gradient). Each such choice k gives `alt[k]`, what the gradient gains
    where it is made otherwise (scaled per joint as `grad`), and `what[k]`
    = (body, point, part, kind, index), at the scene's points inside the
    body, each at the part of its min:
      * kind -1, a near tie: another part `index` lies within `tie` (m)
        of the min;
      * kind l >= 0: the input of unit `index` of the decoder's ReLU
        before layer l + 1 lies within `kink` of 0;
      * kind -2 (point -1): the input of unit `index` of the encoder's
        ReLU of (body, part) lies within `kink` of 0; it moves every
        point whose min is at that part."""
    W, S64, st = _f64(Wf), _f64(S), _f64(stats)
    scene, betas = scene.double(), betas.double()
    scale = torch.tensor(GUIDE_JOINT_SCALE, dtype=torch.float64,
                         device=scene.device)[None, :, None]
    N, Pn = scene.shape[:2]
    block = max(1, BLOCK_ROWS // (N * PARTS))
    trunc = fcfg["trunc"]

    def scaled(grad):
        return (grad.reshape(-1, 24, 6) * scale).reshape(grad.shape)

    def penalty(raw):
        return _penetration(trunc * torch.tanh(raw))

    def g(x_t: Tensor):
        grad = torch.zeros(x_t.shape, dtype=torch.float64, device=x_t.device)
        what, inside = [], []
        with torch.enable_grad():
            x = x_t.detach().double().requires_grad_(True)
            R, P = skeleton(S64, betas, pose_rotations(x, st))
            dec0 = field_latent(W, fcfg, R, P, betas)
            for s in range(0, Pn, block):
                sdf = trunc * torch.tanh(field_raw(W, fcfg, R, P, dec0, scene[:, s:s + block]))
                best, part = sdf.detach().min(dim=1)
                loss = torch.sum(_penetration(torch.amin(sdf, dim=1))) / (Pn * rows)
                grad -= torch.autograd.grad(loss, x, retain_graph=True)[0]
                near = (sdf.detach() - best[:, None] < tie) & (best[:, None] < 0)
                near.scatter_(1, part[:, None], False)
                n, k, p = near.nonzero(as_tuple=True)
                what.append(torch.stack([n, p + s, part[n, p], torch.full_like(n, -1), k], 1))
                n, p = (best < 0).nonzero(as_tuple=True)
                inside.append(torch.stack([n, p + s, part[n, p]], 1))
        with torch.no_grad():
            R, P, dec0 = R.detach(), P.detach(), dec0.detach()
            n, p, k = torch.cat(inside).unbind(1)
            local = ((scene[n, p] - P[n, k])[:, None] @ R[n, k])[:, 0]
            l, m, u = (field_rows(W, fcfg, local, dec0[n, k])[1].abs() < kink).nonzero(
                as_tuple=True)
            what.append(torch.stack([n[m], p[m], k[m], l, u], 1))
            n2, k2, u2 = (_encoder_in(W, fcfg, R, P, betas).abs() < kink).nonzero(as_tuple=True)
            what.append(torch.stack([n2, torch.full_like(n2, -1), k2, torch.full_like(n2, -2),
                                     u2], 1))
        what = torch.cat(what)
        return scaled(grad), scaled(alternatives(x_t, what, torch.cat(inside))), what

    def alternatives(x_t: Tensor, what: Tensor, inside: Tensor) -> Tensor:
        """alt [K, 144]: each choice made otherwise on its own copy of its
        body's x_t, through the rows it moves (unscaled)."""
        K, H = len(what), W["decoder.0.weight"].shape[0]
        if K == 0:
            return torch.zeros((0, x_t.shape[1]), dtype=torch.float64, device=x_t.device)
        b, pt, k, kind, idx = what.unbind(1)
        e = torch.arange(K, device=x_t.device)
        enc = kind == -2
        flip_enc = torch.zeros((K, PARTS, W["encoder.l0.weight"].shape[0]), dtype=torch.bool,
                               device=x_t.device)
        flip_enc[e[enc], k[enc], idx[enc]] = True
        # the rows: (copy, point, part taken, part left, decoder ReLU swapped)
        own = ~enc
        rows_e, rows_p = [e[own]], [pt[own]]
        rows_new = [torch.where(kind[own] == -1, idx[own], k[own])]
        rows_old, rows_l, rows_u = [k[own]], [kind[own]], [idx[own]]
        for j in e[enc].tolist():
            moved = inside[(inside[:, 0] == b[j]) & (inside[:, 2] == k[j])]
            ones = torch.ones_like(moved[:, 0])
            rows_e.append(ones * j)
            rows_p.append(moved[:, 1])
            rows_new.append(ones * k[j])
            rows_old.append(ones * k[j])
            rows_l.append(ones * -1)
            rows_u.append(ones * 0)
        re, rp, rn, ro, rl, ru = (torch.cat(v) for v in (rows_e, rows_p, rows_new, rows_old,
                                                          rows_l, rows_u))
        flip = torch.zeros((fcfg["num_layers"] - 1, len(re), H), dtype=torch.bool,
                           device=x_t.device)
        r = torch.arange(len(re), device=x_t.device)
        dec = rl >= 0
        flip[rl[dec], r[dec], ru[dec]] = True
        with torch.enable_grad():
            xr = x_t.detach().double()[b].requires_grad_(True)
            R, P = skeleton(S64, betas[b], pose_rotations(xr, st))
            d_new = field_latent(W, fcfg, R, P, betas[b], flip=flip_enc)
            d_old = field_latent(W, fcfg, R, P, betas[b])
            pts = scene[b[re], rp]

            def raw(part, d0, f):
                local = ((pts - P[re, part])[:, None] @ R[re, part])[:, 0]
                return field_rows(W, fcfg, local, d0[re, part], f)[0]

            gain = torch.sum(penalty(raw(rn, d_new, flip)) - penalty(raw(ro, d_old, None)))
            # (a choice that moves no row gains nothing)
            return -torch.autograd.grad(gain / (Pn * rows) + 0.0 * xr.sum(), xr)[0]

    return g


# --------------------------------------------------------------- mesh SDF
def k_smallest(key: Tensor, k: int) -> Tensor:
    """Indices of the k smallest entries of each row, ties to the lowest
    index."""
    return torch.sort(key, dim=-1, stable=True)[1][..., :k]


def take(x: Tensor, idx: Tensor) -> Tensor:
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def normals(verts: Tensor, faces: Tensor) -> Tensor:
    """Area-weighted vertex normals."""
    f = faces.long()
    fn = torch.cross(verts[:, f[:, 1]] - verts[:, f[:, 0]],
                     verts[:, f[:, 2]] - verts[:, f[:, 0]], dim=-1)
    n = torch.zeros_like(verts)
    for i in range(3):
        n.index_add_(1, f[:, i], fn)
    return n / n.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def nearest(pts: Tensor, verts: Tensor, block: int = 256) -> Tensor:
    """The index of each point's nearest vertex, by brute force."""
    out = []
    for s in range(0, pts.shape[1], block):
        d = ((pts[:, s:s + block, None] - verts[:, None]) ** 2).sum(-1)
        out.append(d.argmin(-1))
    return torch.cat(out, 1)


def nearest_origin(scene: Tensor, k: Optional[int]) -> Tensor:
    """The k scene points nearest the canonical origin (all for None)."""
    if k is None or scene.shape[1] <= k:
        return scene
    return take(scene, k_smallest((scene ** 2).sum(-1), k))


def mesh_guidance(S, stats, scene: Tensor, betas: Tensor, rows: int, q: Prec = F32, *,
                  scene_points: Optional[int] = MESH_SCENE_POINTS,
                  step_points: int = MESH_STEP_POINTS) -> Callable[[Tensor], Tensor]:
    """g(x_t) [N, 144] of the mesh SDF (see the module's docstring)."""
    scale = torch.tensor(GUIDE_JOINT_SCALE, device=scene.device)[None, :, None]
    scene = nearest_origin(scene, scene_points)
    capped = scene.shape[1] > step_points
    if capped:
        perm = torch.tensor(np.random.RandomState(0).permutation(scene.shape[1]),
                            device=scene.device)
        scene = scene[:, perm]

    def verts_of(x):
        return smpl(S, betas, pose_rotations(x, stats), q).vertices

    def g(x_t: Tensor) -> Tensor:
        with torch.no_grad():
            v = verts_of(x_t)
            lo, hi = v.amin(1, keepdim=True), v.amax(1, keepdim=True)
            pts = scene
            if capped:
                d = scene - torch.minimum(torch.maximum(scene, lo), hi)
                pts = take(scene, k_smallest((d ** 2).sum(-1), step_points))
            mask = ((pts >= lo) & (pts <= hi)).all(-1).float()
            idx = nearest(pts, v)
            sign = torch.sign(((pts - take(v, idx)) * take(normals(v, S["faces"]), idx)).sum(-1))
            sign = torch.where(sign == 0, torch.ones_like(sign), sign)
        with torch.enable_grad():
            x = x_t.detach().requires_grad_(True)
            sdf = sign * (pts - take(verts_of(x), idx)).norm(dim=-1)
            pen = torch.clamp(-sdf, min=0.0) ** 2
            per_body = (pen * mask).sum(-1) / mask.sum(-1).clamp(min=1.0)
            (grad,) = torch.autograd.grad(-per_body.sum() / rows, x)
        return (grad.reshape(-1, 24, 6) * scale).reshape(x_t.shape)

    return g


def guidance(guide: Dict, S, stats, scene: Tensor, betas: Tensor, rows: int,
             Wf=None, q: Prec = F32) -> Callable[[Tensor], Tensor]:
    """The guidance of `guide` (the cell's "guidance" settings): g(x_t) for
    bodies of betas [N, 10] in canonical scenes [N, P, 3], over the batch
    mean of `rows` bodies."""
    q = Rounded(q.mode)
    cap = None if guide["scene_points"] == "all" else int(guide["scene_points"])
    if guide["backend"] == "volsdf":
        return field_guidance(Wf, guide["net"], S, stats, nearest_origin(scene, cap), betas,
                              rows, q)
    if guide["backend"] != "sdf":
        raise ValueError(f"collision backend {guide['backend']!r}: the reference has the "
                         "learned SDF and the mesh SDF")
    return mesh_guidance(S, stats, scene, betas, rows, q, scene_points=cap,
                         step_points=guide.get("step_points", MESH_STEP_POINTS))


def guidance_ties(guide: Dict, S, stats, scene: Tensor, betas: Tensor, rows: int, Wf=None):
    """The yardstick of a program's guidance: g(x_t) -> (grad [N, 144], alt
    [K, 144], what [K, 5]) as `field_guidance_ties` gives them for the
    learned field (in float64, with the pieces float32 may take otherwise);
    for the mesh SDF `guidance`'s float32 gradient and no alternatives."""
    cap = None if guide["scene_points"] == "all" else int(guide["scene_points"])
    if guide["backend"] == "volsdf":
        return field_guidance_ties(Wf, guide["net"], S, stats, nearest_origin(scene, cap),
                                   betas, rows)
    g = guidance(guide, S, stats, scene, betas, rows, Wf)

    def none(x_t: Tensor):
        empty = torch.zeros((0, x_t.shape[1]), dtype=x_t.dtype, device=x_t.device)
        return g(x_t), empty, torch.zeros((0, 5), dtype=torch.int64, device=x_t.device)

    return none


def canonical_scene(batch: Dict[str, Tensor], num_samples: int) -> Tensor:
    """Each body's scene cloud in its own frame (minus the translation),
    [B * num_samples, P, 3]."""
    scene = batch["scene_pcd_verts_full"] - batch["smpl_params"]["transl"][:, None]
    return scene.repeat_interleave(num_samples, 0)


# --------------------------------------------------------------- sampling
def sample(W, m, S, stats, sched: DDPMSchedule, batch, seed: int, num_samples: int,
           guide: Optional[Dict], gcfg: Dict, *, Wf=None, p: Prec = F32,
           q: Prec = F32) -> Dict[str, Tensor]:
    """One guided request, DDPM from x_T and the steps' noise drawn from
    the request's seed: `num_samples` bodies per image -> outputs [B *
    num_samples, ...] (image-major), and "guidance_record" [G, 4, N, 144]:
    each guided step's x_t, unguided posterior mean, gradient and output.
    `guide` None: the request unguided, with no record."""
    dev = batch["img"].device
    c = condition(W, m, batch, p).tile(num_samples)
    N = c.cond.shape[0]
    x, z = draws(seed, N, sched.steps, dev)
    adj = adjacency(dev)
    g = None if guide is None else guidance(guide, S, stats, canonical_scene(batch, num_samples),
                                            c.betas, N, Wf, q)
    record = []
    for k, t in enumerate(range(sched.steps - 1, -1, -1)):
        tt = torch.full((N,), t, dtype=torch.int64, device=dev)
        x0 = denoise(W, m, adj, c, x, sched.timestep_map[tt], p)
        mean = sched.coef1[t] * x0 + sched.coef2[t] * x
        out = mean
        guided = g is not None and t <= gcfg["ddpm_threshold"]
        if guided:
            grad = g(x)
            out = mean + guide_coeff(sched, gcfg, t) * grad
        if t > 0:
            out = out + sigma(sched, t) * z[k]
        if guided:
            record.append(torch.stack([x, mean, grad, out]))
        x = out
    res = outputs(m, S, c, x, stats, q)
    if record:
        res["guidance_record"] = torch.stack(record)
    return res
