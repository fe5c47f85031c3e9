"""Stage-2 inference and metric evaluation (port of
egohmr_tpu/eval/pipeline.py).

The per-image condition is computed once and tiled S times along the batch
axis, so all S samples of all B images run in one sampling loop.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..collision import (
    bbox_mask,
    collision_ratio,
    min_body_scene_distance,
    signed_distance,
)
from ..collision.neural_occupancy import (
    NUM_PARTS,
    PartFieldNet,
    field_in_chunks,
    make_occupancy_guidance_fn,
    occupancy_from_raw,
)
from ..collision.neural_sdf import make_volsdf_guidance_fn, sdf_from_raw
from ..diffusion import DiffusionSchedule, GuidanceConfig, StatefulGuidanceFn, sample_loop
from ..models import (
    BodyRepStats,
    Condition,
    EgoHMR,
    EgoHMRConfig,
    compute_condition,
    make_denoise_fn,
    make_guidance_fn,
    model_outputs,
)
from ..nn import is_bf16_copy
from ..parallel.mesh import Shard, global_rows
from ..parallel.tp import TensorParallel
from ..smpl import SMPLModel, SMPLOutput, lbs, vertex_normals
from ..utils.graphs import count_launch
from ..utils.profiling import mark
from .metrics import (
    apd,
    diversity_std,
    joint_visibility_mask,
    mpjpe,
    pa_mpjpe,
    v2v,
)


def tile_condition(cond: Condition, s: int) -> Condition:
    """Repeat each image's condition S times along the batch axis
    (sample-major within an image, as `jnp.repeat` does)."""
    return Condition(*(x.repeat_interleave(s, dim=0) for x in cond))


def _to_f32(cond: Condition) -> Condition:
    return Condition(*(x.float() if x.dtype == torch.bfloat16 else x
                       for x in cond))


@torch.no_grad()
def sample_bodies(
    model: EgoHMR,
    cfg: EgoHMRConfig,
    smpl: SMPLModel,
    stats: BodyRepStats,
    schedule: DiffusionSchedule,
    batch: Dict,
    generator: Optional[torch.Generator],
    num_samples: int,
    *,
    sampler: str = "ddpm",
    with_guidance: bool = False,
    guidance: GuidanceConfig = GuidanceConfig(),
    use_stage1_transl: bool = True,
    collision_backend: str = "sdf",
    occ_net: Optional[PartFieldNet] = None,
    guidance_refresh_every: int = 1,
    noise: Optional[torch.Tensor] = None,
    step_noise: Optional[torch.Tensor] = None,
    shard: Shard = None,
    tp: Optional[TensorParallel] = None,
    guidance_scene_points: Optional[int] = 4096,
    record_guidance: bool = False,
    counter: Any = None,
) -> Tuple[Dict[str, torch.Tensor], Condition]:
    """Draw `num_samples` bodies per image; outputs are [B, S, ...].

    `sampler` is "ddpm" or "ddim" over `schedule`'s steps. `with_guidance`
    adds the collision-score gradient on the low-noise steps (`guidance`
    holds its thresholds and weights). `use_stage1_transl` puts the stage-1
    translation (`stage1_transl_full`, when the batch has it) in place of
    the input one. `collision_backend` names the gradient's source: the
    exact mesh SDF ("sdf"), or the learned occupancy ("occupancy") or
    signed-distance ("volsdf") net `occ_net` (`load_occupancy` /
    `load_sdfnet`, on the model's device), which runs in f32 on the bf16
    path too. `guidance_refresh_every` > 1 reuses the guided step's
    selection pass across that many adjacent guided steps (an
    approximation; 1 is exact; the mesh SDF's only).
    The whole function runs without autograd; the guidance takes its
    gradient in a scope of its own.

    `batch` holds tensors on the model's device. x_T is `noise` when given,
    else drawn from `generator`; the steps' noise is `step_noise` when
    given (`diffusion.draw_step_noise`), else drawn from `generator` as the
    loop goes. With both given the function draws nothing, reads nothing
    back to the host and allocates by shape alone, so it runs unchanged
    inside a CUDA graph's capture (`serving.Predictor`). Handed a
    `cast_params_bf16` copy of the model (`nn.is_bf16_copy`), the
    conditioning and the denoiser run in bfloat16 (BatchNorm statistics
    stay f32 and fold into the activation dtype); the sampler, the
    guidance, SMPL and the reprojection stay f32.

    `shard` (a rank's record, or (i, n)): `batch` is a block of a larger
    batch (a data-parallel rank's, or a `Predictor` device's;
    `parallel.Shard`). The B x S sample
    rows are image-major, so they are the i-th block of the whole batch's;
    x_T and the step noise are drawn for the whole batch and the block
    kept, and the guidance's batch mean runs over all n x B x S bodies:
    the n blocks together give what the whole batch gives in one run.

    `tp`: `model` placed over a data row's model axis (`parallel.tp`;
    `model` is `tp.module`, cast before it was placed for bf16): the
    scene encoder and the denoiser run split, everything else on the row's
    first device.

    `guidance_scene_points`: the guidance's cap on scene points, the top-K
    nearest the canonical origin (`collision.topk_scene_points`), for every
    backend; None: the whole cloud (the reference EgoHMR-VolSMPL's
    setting). 4096 is the JAX package's. `record_guidance` (DDPM): the
    outputs gain "guidance_record" [B, S, G, 4, 144] f32, each of the G
    guided steps' input x_t, posterior mean, gradient and output
    (`sample_loop`'s `guidance_record`). Each guided step's guidance is marked on the device
    (`utils/profiling.py:mark`, "guide" and "guide_end"), and, with
    `counter`, counted on it (`utils/graphs.py:count_launch`, so that a
    replayed request counts too): `guided_steps`, and `field_rows`, the
    (body, part, scene point) rows the learned field evaluates (0 for the
    mesh SDF)."""
    if (with_guidance and guidance_refresh_every != 1
            and collision_backend in ("occupancy", "volsdf")):
        raise ValueError(
            "guidance_refresh_every > 1 is an sdf-backend knob (it caches "
            f"the mesh-SDF selection pass); the {collision_backend} backend "
            "has no per-step selection stage to reuse")
    if collision_backend not in ("sdf", "occupancy", "volsdf"):
        raise ValueError(f"unknown collision_backend: {collision_backend}")
    if with_guidance and collision_backend != "sdf" and occ_net is None:
        raise ValueError(f"collision_backend {collision_backend!r} needs a learned "
                         "collision net (occ_net)")
    if record_guidance and not with_guidance:
        raise ValueError("record_guidance records the guided steps: it needs with_guidance")
    if use_stage1_transl and "stage1_transl_full" in batch:
        batch = dict(batch)
        batch["smpl_params"] = dict(batch["smpl_params"])
        batch["smpl_params"]["transl"] = batch["stage1_transl_full"]
    B = batch["img"].shape[0]
    mark("image", batch["img"])
    bf16 = is_bf16_copy(model)
    if bf16:
        batch = dict(batch)
        batch["img"] = batch["img"].to(torch.bfloat16)
    cond = compute_condition(model, cfg, batch, tp=tp)
    cond_s = tile_condition(cond, num_samples)
    if bf16:
        raw = make_denoise_fn(model, cfg, cond_s, tp=tp)

        def denoise(x, t):
            return raw(x.to(torch.bfloat16), t).float()

        cond_s, cond = _to_f32(cond_s), _to_f32(cond)
    else:
        denoise = make_denoise_fn(model, cfg, cond_s, tp=tp)
    guidance_fn = None
    if with_guidance:
        # cond_s is f32 here on the bf16 path too: the guidance, like SMPL
        # and the reprojection, runs in f32
        rows = global_rows(shard, B * num_samples)
        kw = dict(max_scene_points=guidance_scene_points, global_rows=rows)
        if collision_backend == "occupancy":
            guidance_fn = make_occupancy_guidance_fn(occ_net, smpl, cond_s, stats, **kw)
        elif collision_backend == "volsdf":
            guidance_fn = make_volsdf_guidance_fn(occ_net, smpl, cond_s, stats, **kw)
        else:
            guidance_fn = make_guidance_fn(
                model, cfg, smpl, cond_s, stats,
                selection_refresh_every=guidance_refresh_every, **kw)
        points = cond_s.scene_pcd.shape[1]
        if guidance_scene_points is not None:
            points = min(points, guidance_scene_points)
        field_rows = 0 if collision_backend == "sdf" else B * num_samples * NUM_PARTS * points
        guidance_fn = _marked(guidance_fn, counter, field_rows)
    record = [] if record_guidance else None
    mark("sampler", batch["img"])
    _, x0 = sample_loop(schedule, denoise, generator, (B * num_samples, 144),
                        sampler=sampler, guidance_fn=guidance_fn,
                        guidance=guidance, noise=noise, shard=shard,
                        step_noise=step_noise, guidance_record=record)
    mark("smpl", x0)
    out = model_outputs(cfg, smpl, cond_s, x0, stats)
    out = {k: v.reshape(B, num_samples, *v.shape[1:]) for k, v in out.items()}
    if record is not None:
        # [G, 4, B * S, 144] -> [B, S, G, 4, 144], rows image-major
        rec = torch.stack(record) if record else x0.new_zeros((0, 4) + x0.shape)
        out["guidance_record"] = rec.permute(2, 0, 1, 3).reshape(
            B, num_samples, rec.shape[0], 4, x0.shape[-1])
    return out, cond


def _marked(guidance_fn, counter: Any, field_rows: int):
    """`guidance_fn` with each call marked on the device ("guide" before,
    "guide_end" after) and, with `counter`, counted: `guided_steps` one,
    `field_rows` `field_rows`."""
    def wrap(fn):
        def marked(x, *args):
            mark("guide", x)
            if counter is not None:
                count_launch(counter, "guided_steps")
                count_launch(counter, "field_rows", field_rows)
            out = fn(x, *args)
            mark("guide_end", out[0] if isinstance(out, tuple) else out)
            return out
        return marked

    if isinstance(guidance_fn, StatefulGuidanceFn):
        return guidance_fn._replace(fn=wrap(guidance_fn.fn))
    return wrap(guidance_fn)


class EvalResult(NamedTuple):
    """Per-image metrics, all [B] or [B, S]; distances in metres."""

    g_mpjpe: torch.Tensor
    g_mpjpe_vis: torch.Tensor
    g_mpjpe_invis: torch.Tensor
    mpjpe_all: torch.Tensor
    mpjpe_vis: torch.Tensor
    mpjpe_invis: torch.Tensor
    pa_mpjpe_all: torch.Tensor
    pa_mpjpe_vis: torch.Tensor
    pa_mpjpe_invis: torch.Tensor
    v2v_all: torch.Tensor
    v2v_vis: torch.Tensor
    v2v_invis: torch.Tensor
    std_all: torch.Tensor
    std_vis: torch.Tensor
    std_invis: torch.Tensor
    apd_all: torch.Tensor
    apd_vis: torch.Tensor
    apd_invis: torch.Tensor
    coll_ratio: Optional[torch.Tensor]
    contact: Optional[torch.Tensor]
    # per-image visible / invisible joint and vertex counts: the weights for
    # aggregating the masked metrics across images (an image with an empty
    # mask has zero weight)
    vis_count: torch.Tensor
    invis_count: torch.Tensor
    vertex_vis_count: torch.Tensor
    vertex_invis_count: torch.Tensor


@torch.no_grad()
def evaluate_batch(
    cfg: EgoHMRConfig,
    smpl_neutral: SMPLModel,
    smpl_male: SMPLModel,
    smpl_female: SMPLModel,
    batch: Dict,
    outputs: Dict[str, torch.Tensor],
    cond: Condition,
    *,
    eval_with_vis_mask_pa: bool = True,
    eval_collision: bool = True,
    eval_contact: bool = True,
    contact_thresh: float = 0.02,
    collision_backend: str = "sdf",
    occ_net: Optional[PartFieldNet] = None,
) -> EvalResult:
    """The metrics of one batch. `outputs` are [B, S, ...] from
    `sample_bodies`, `cond` its per-image condition. The collision ratio is
    the share of the scene's points inside a body's bbox and inside the
    body: by the exact mesh SDF ("sdf", sdf < 0), the learned occupancy
    ("occupancy", occ > 0.5) or the learned signed distance ("volsdf",
    sdf < 0) of `occ_net`, queried for the neutral body in chunks of points
    (`field_in_chunks`). On CUDA tensors the mesh SDF and the contact score
    each launch kernel K2 once, over all B * S bodies (`signed_distance`
    from the whole scene cloud to the body, `min_body_scene_distance` from
    the body to the cloud); the learned ratio launches none."""
    if collision_backend not in ("sdf", "occupancy", "volsdf"):
        raise ValueError(f"unknown collision_backend: {collision_backend}")
    if eval_collision and collision_backend != "sdf" and occ_net is None:
        raise ValueError(f"collision_backend {collision_backend!r} needs a learned "
                         "collision net (occ_net)")
    B, S = outputs["pred_keypoints_3d"].shape[:2]
    gtp = batch["smpl_params"]

    # the gendered GT body: both bodies are posed, one is selected per image
    gt_m = lbs(smpl_male, gtp["betas"], gtp["global_orient"], gtp["body_pose"],
               transl=gtp["transl"], pose2rot=True)
    gt_f = lbs(smpl_female, gtp["betas"], gtp["global_orient"], gtp["body_pose"],
               transl=gtp["transl"], pose2rot=True)
    is_f = (batch["gender"] == 1)[:, None, None]
    gt_verts = torch.where(is_f, gt_f.vertices, gt_m.vertices)
    gt_kp3d = torch.where(is_f, gt_f.joints, gt_m.joints)[:, :24]

    # visibility: the GT joint projects into the full image
    vis = joint_visibility_mask(gt_kp3d, cond.focal_length, cond.camera_center,
                                cfg.full_img_w, cfg.full_img_h).float()  # [B, 24]
    invis = 1.0 - vis

    pred_kp3d = outputs["pred_keypoints_3d_full"][:, :, :24]  # [B, S, 24, 3]
    gt_full_b = gt_kp3d[:, None].expand(pred_kp3d.shape)
    vis_s = vis[:, None].expand(B, S, 24)
    invis_s = 1.0 - vis_s
    g_mpjpe = mpjpe(pred_kp3d, gt_full_b)
    g_vis = mpjpe(pred_kp3d, gt_full_b, mask=vis_s)
    g_invis = mpjpe(pred_kp3d, gt_full_b, mask=invis_s)
    mp_all = mpjpe(pred_kp3d, gt_full_b, pelvis_align=True)
    mp_vis = mpjpe(pred_kp3d, gt_full_b, pelvis_align=True, mask=vis_s)
    mp_invis = mpjpe(pred_kp3d, gt_full_b, pelvis_align=True, mask=invis_s)

    # Procrustes on pelvis-aligned coordinates: the vis-masked fit zeroes the
    # invisible joints, which is only safe near a zero mean
    pred_align = pred_kp3d - pred_kp3d[:, :, :1]
    gt_align = gt_full_b - gt_full_b[:, :, :1]
    vm = vis_s if eval_with_vis_mask_pa else None
    pa_all = pa_mpjpe(pred_align, gt_align, vis_mask=vm)
    pa_vis = pa_mpjpe(pred_align, gt_align, vis_mask=vm, mask=vis_s)
    pa_invis = pa_mpjpe(pred_align, gt_align, vis_mask=vm, mask=invis_s)

    # v2v in the local body frame: pred_vertices carry no translation, so
    # the pelvis comes from the local joints; both sides align by their own
    pred_pelvis = outputs["pred_keypoints_3d"][:, :, 0]
    pred_verts = outputs["pred_vertices"]  # [B, S, V, 3]
    gt_verts_b = gt_verts[:, None].expand(pred_verts.shape)
    vertex_vis = joint_visibility_mask(gt_verts, cond.focal_length, cond.camera_center,
                                       cfg.full_img_w, cfg.full_img_h).float()  # [B, V]
    vvis_s = vertex_vis[:, None].expand(B, S, vertex_vis.shape[-1])
    gt_pelvis = gt_full_b[:, :, 0]
    v2v_all = v2v(pred_verts, gt_verts_b, pred_pelvis, gt_pelvis)
    v2v_vis = v2v(pred_verts, gt_verts_b, pred_pelvis, gt_pelvis, mask=vvis_s)
    v2v_invis = v2v(pred_verts, gt_verts_b, pred_pelvis, gt_pelvis, mask=1.0 - vvis_s)

    # diversity over the S bodies (pelvis-aligned joints)
    samples = pred_kp3d - pred_kp3d[:, :, :1]

    coll = None
    contact = None
    if eval_collision or eval_contact:
        verts_flat = pred_verts.reshape(B * S, -1, 3)
        # the bodies are posed without translation; the scene is canonical
        # to match. Image-major, sample-minor, as the bodies are
        scene_s = cond.scene_pcd.repeat_interleave(S, dim=0)
        if eval_collision and collision_backend != "sdf":
            # the SMPLOutput rebuilt from the tensors model_outputs gave,
            # rather than LBS run again over B * S bodies
            out_bs = SMPLOutput(
                vertices=verts_flat,
                joints=outputs["pred_keypoints_3d"].reshape(B * S, -1, 3),
                full_pose=outputs["pred_pose_rotmat"].reshape(B * S, 24, 3, 3),
                joints_smpl=outputs["pred_joints_smpl"].reshape(B * S, 24, 3))
            betas_s = outputs["pred_betas"].reshape(B * S, 10)
            if collision_backend == "occupancy":
                inside = field_in_chunks(occ_net, out_bs, betas_s, scene_s,
                                         occupancy_from_raw) > 0.5
            else:
                inside = field_in_chunks(occ_net, out_bs, betas_s, scene_s,
                                         partial(sdf_from_raw, occ_net.cfg)) < 0.0
            mask = bbox_mask(scene_s, verts_flat)
            coll = (torch.sum((inside & mask).float(), dim=-1)
                    / scene_s.shape[-2]).reshape(B, S)
        elif eval_collision:
            normals = vertex_normals(verts_flat, smpl_neutral.faces)
            mask = bbox_mask(scene_s, verts_flat)
            sdf = signed_distance(scene_s, verts_flat, normals)
            coll = collision_ratio(sdf, mask.to(sdf.dtype)).reshape(B, S)
        if eval_contact:
            dmin = min_body_scene_distance(verts_flat, scene_s)
            # the reference thresholds chamfer distances, which are SQUARED:
            # 0.02 applies to dist^2, not to dist
            contact = (torch.square(dmin) < contact_thresh).float().reshape(B, S)

    return EvalResult(
        g_mpjpe=g_mpjpe, g_mpjpe_vis=g_vis, g_mpjpe_invis=g_invis,
        mpjpe_all=mp_all, mpjpe_vis=mp_vis, mpjpe_invis=mp_invis,
        pa_mpjpe_all=pa_all, pa_mpjpe_vis=pa_vis, pa_mpjpe_invis=pa_invis,
        v2v_all=v2v_all, v2v_vis=v2v_vis, v2v_invis=v2v_invis,
        std_all=diversity_std(samples), std_vis=diversity_std(samples, vis),
        std_invis=diversity_std(samples, invis),
        apd_all=apd(samples), apd_vis=apd(samples, vis), apd_invis=apd(samples, invis),
        coll_ratio=coll, contact=contact,
        vis_count=torch.sum(vis, dim=-1), invis_count=torch.sum(invis, dim=-1),
        vertex_vis_count=torch.sum(vertex_vis, dim=-1),
        vertex_invis_count=torch.sum(1.0 - vertex_vis, dim=-1),
    )
