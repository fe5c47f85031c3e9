"""Offline scene point-cloud preprocessing (stages s1 and s2).

A copy of egohmr_tpu/preprocess/scene.py (equivalents of reference
preprocess_scene_s1.py / preprocess_scene_s2_for_{train,test}.py without
open3d): numpy transforms, and the port's SMPL (`smpl.lbs`, on the CPU) in
place of the JAX one for the GT body. Same outputs/layout:
  s1: pcd_verts_dict_{split}.pkl + map_dict_{split}.pkl
      (whole scene, 20000 verts, master-kinect coords, saved every 15 frames)
  s2: per-frame .npy cube crops (2x2x2 m around the body / predicted transl)
      in scene coordinates.
"""
from __future__ import annotations

import json
import math
import os
import pickle
from os.path import basename, join
from typing import Dict, Optional

import numpy as np

from .mesh_io import read_mesh_vertices, uniform_downsample

ADD_TRANS = np.array([[1.0, 0, 0, 0], [0, -1, 0, 0],
                      [0, 0, -1, 0], [0, 0, 0, 1]])


def _apply(verts: np.ndarray, t: np.ndarray) -> np.ndarray:
    return verts @ t[:3, :3].T + t[:3, 3]


def _load_scene_to_main(data_root: str, recording: str, scene: str) -> np.ndarray:
    calib = join(data_root, "calibrations", recording,
                 "cal_trans/kinect12_to_world", scene + ".json")
    with open(calib) as f:
        return np.linalg.inv(np.array(json.load(f)["trans"]))


def _scene_names(data_root: str) -> Dict[str, str]:
    import csv

    out = {}
    with open(join(data_root, "data_info_release.csv")) as f:
        for row in csv.DictReader(f):
            out[row["recording_name"]] = row["scene_name"]
    return out


def preprocess_s1(
    data_root: str,
    save_root: str,
    split: str,
    annotation_file: Optional[str] = None,
    scene_verts_num_target: int = 20000,
    keyframe_every: int = 15,
) -> None:
    """Whole-scene preprocessing (reference preprocess_scene_s1.py:29-138):
    scene mesh -> pv camera coords -> keep z>0 -> downsample to N -> store in
    master-kinect coords, one pcd per ~15 frames + frame->pcd map."""
    from ..data.egobody import parse_img_full_path

    os.makedirs(save_root, exist_ok=True)
    scene_name_dict = _scene_names(data_root)
    ann = annotation_file or join(
        data_root, f"smpl_spin_npz/egocapture_{split}_smpl.npz")
    data = np.load(ann)
    with open(join(data_root, "transf_matrices_all_seqs.pkl"), "rb") as f:
        transf_matrices = pickle.load(f)

    imgnames = [str(x) for x in data["imgname"]]
    mesh_cache: Dict[str, np.ndarray] = {}
    map_dict, pcd_verts_dict = {}, {}
    last_scene, cnt, cur_key = "", 0, None

    for imgname in imgnames:
        _, seq, holo_time, frame = parse_img_full_path(imgname)
        recording = imgname.split("/")[-4]
        scene = scene_name_dict[recording]
        key = "/".join(imgname.split("/")[-5:])

        if cnt % keyframe_every == 0 or last_scene != scene:
            seq_t = transf_matrices[basename(seq)]
            k2h = seq_t["trans_kinect2holo"].astype(np.float64)
            h2p = seq_t["trans_world2pv"][frame.split("_")[0]].astype(np.float64)

            if scene not in mesh_cache:
                mesh_cache[scene] = read_mesh_vertices(
                    join(data_root, "scene_mesh", scene, scene + ".obj"))
            s2m = _load_scene_to_main(data_root, recording, scene)
            chain = ADD_TRANS @ h2p @ k2h @ s2m
            verts = _apply(mesh_cache[scene], chain)
            verts = verts[verts[:, 2] > 0]                 # in front of camera
            verts = uniform_downsample(verts, scene_verts_num_target)
            # back to master-kinect coords
            inv = np.linalg.inv(ADD_TRANS @ h2p @ k2h)
            verts = _apply(verts, inv)
            cur_key = key
            pcd_verts_dict[cur_key] = verts
        cnt += 1
        last_scene = scene
        map_dict[key] = cur_key

    with open(join(save_root, f"map_dict_{split}.pkl"), "wb") as f:
        pickle.dump(map_dict, f, protocol=2)
    with open(join(save_root, f"pcd_verts_dict_{split}.pkl"), "wb") as f:
        pickle.dump(pcd_verts_dict, f, protocol=2)


def preprocess_s2(
    data_root: str,
    save_root: str,
    split: str,
    smpl_models: Dict[str, "object"],   # {'male': SMPLModel, 'female': ...}
    annotation_file: Optional[str] = None,
    stage1_result_path: Optional[str] = None,
    cube_size: float = 2.0,
    scene_verts_num_target: int = 20000,
    augment: bool = True,
    seed: int = 0,
) -> None:
    """Cube-crop preprocessing (reference preprocess_scene_s2_for_train.py /
    _for_test.py): per frame, crop a `cube_size` cube around the GT body
    center (train, with random rotation/shift) or around the stage-1
    predicted translation (test, deterministic), saved as per-frame .npy in
    scene coordinates. GT bodies are posed with the port's SMPL model.
    """
    import torch

    from ..data.egobody import parse_img_full_path
    from ..smpl import lbs

    scene_name_dict = _scene_names(data_root)
    ann = annotation_file or join(
        data_root, f"smpl_spin_npz/egocapture_{split}_smpl.npz")
    data = np.load(ann)
    with open(join(data_root, "transf_matrices_all_seqs.pkl"), "rb") as f:
        transf_matrices = pickle.load(f)

    imgnames = [str(x) for x in data["imgname"]]
    gender = [str(g) for g in data["gender"]]
    stage1_transl = None
    if stage1_result_path:
        with open(stage1_result_path, "rb") as f:
            stage1_transl = np.asarray(
                pickle.load(f)["pred_cam_full_list"], np.float64)

    mesh_cache: Dict[str, np.ndarray] = {}
    rng = np.random.RandomState(seed) if augment else None

    def row(key, i):
        return torch.tensor(np.asarray(data[key][i:i + 1], np.float32))

    for i, imgname in enumerate(imgnames):
        _, seq, holo_time, frame = parse_img_full_path(imgname)
        recording = imgname.split("/")[-4]
        scene = scene_name_dict[recording]
        seq_t = transf_matrices[basename(seq)]
        k2h = seq_t["trans_kinect2holo"].astype(np.float64)
        h2p = seq_t["trans_world2pv"][frame.split("_")[0]].astype(np.float64)
        s2m = _load_scene_to_main(data_root, recording, scene)
        pv_to_scene = np.linalg.inv(ADD_TRANS @ h2p @ k2h @ s2m)

        if scene not in mesh_cache:
            mesh_cache[scene] = read_mesh_vertices(
                join(data_root, "scene_mesh", scene, scene + ".obj"))
        scene_verts = mesh_cache[scene]

        if stage1_transl is not None:
            # test path: cube centered at the predicted translation
            center = _apply(stage1_transl[i][None], pv_to_scene)[0]
            body_verts_scene = None
            item_rng = None
        else:
            model = smpl_models["male" if gender[i] == "m" else "female"]
            with torch.no_grad():
                out = lbs(model, *(row(k, i) for k in ("shape", "global_orient_pv", "pose")),
                          transl=row("transl_pv", i), pose2rot=True)
            body_pv = out.vertices[0].numpy().astype(np.float64)
            body_verts_scene = _apply(body_pv, pv_to_scene)
            center = body_verts_scene.mean(axis=0)
            item_rng = rng

        crop = crop_scene_cube(
            scene_verts, center, cube_size=cube_size,
            target=scene_verts_num_target, body_verts=body_verts_scene,
            rng=item_rng)
        out_dir = join(save_root, split, recording, holo_time)
        os.makedirs(out_dir, exist_ok=True)
        np.save(join(out_dir, frame[:-4] + ".npy"), crop)


def rotate_y(verts: np.ndarray, center: np.ndarray, angle: float) -> np.ndarray:
    """Rotate about the (vertical) y axis around `center` in x-z
    (reference preprocess_scene_s2_for_train.py:139-163)."""
    out = np.empty_like(verts)
    dx = verts[:, 0] - center[0]
    dz = verts[:, 2] - center[2]
    c, s = math.cos(angle), math.sin(angle)
    out[:, 0] = dx * c - dz * s + center[0]
    out[:, 2] = dx * s + dz * c + center[2]
    out[:, 1] = verts[:, 1]
    return out


def crop_scene_cube(
    scene_verts: np.ndarray,
    center_xz: np.ndarray,            # [3]; y ignored for the crop center
    cube_size: float = 2.0,
    target: int = 20000,
    body_verts: Optional[np.ndarray] = None,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Cube crop around a center with optional train-time random rotation and
    bounded shift (reference preprocess_scene_s2_for_train.py:139-203 /
    _for_test.py deterministic variant). Returns [target, 3] in the ORIGINAL
    scene coordinates."""
    augment = rng is not None and body_verts is not None
    if augment:
        rot = rng.uniform(0, 2 * math.pi)
        verts = rotate_y(scene_verts, center_xz, rot)
        body = rotate_y(body_verts, center_xz, rot)
        shift = np.zeros(3)
        half, quarter = cube_size / 2, cube_size / 4
        shift[0] = rng.uniform(
            max(-quarter, body[:, 0].max() - center_xz[0] - half),
            min(quarter, half - (center_xz[0] - body[:, 0].min())))
        shift[2] = rng.uniform(
            max(-quarter, body[:, 2].max() - center_xz[2] - half),
            min(quarter, half - (center_xz[2] - body[:, 2].min())))
    else:
        rot = 0.0
        verts = scene_verts
        shift = np.zeros(3)

    min_x = center_xz[0] - cube_size / 2 + shift[0]
    max_x = center_xz[0] + cube_size / 2 + shift[0]
    min_z = center_xz[2] - cube_size / 2 + shift[2]
    max_z = center_xz[2] + cube_size / 2 + shift[2]
    sel = ((verts[:, 0] >= min_x) & (verts[:, 0] <= max_x)
           & (verts[:, 2] >= min_z) & (verts[:, 2] <= max_z))
    crop = verts[sel]
    if len(crop) == 0:
        raise ValueError("empty cube crop")
    # cap height: ground + cube_size (reference :171)
    crop = crop[crop[:, 1] <= crop[:, 1].min() + cube_size]
    crop = uniform_downsample(crop, target)
    if len(crop) < target:
        # pad by repeating points (the reference errors out instead;
        # preprocess_scene_s2_for_train.py:180-183)
        reps = -(-target // len(crop))
        crop = np.tile(crop, (reps, 1))[:target]
    if rot != 0.0:
        crop = rotate_y(crop, center_xz, -rot)
    return crop
