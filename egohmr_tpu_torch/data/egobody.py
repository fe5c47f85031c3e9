"""EgoBody dataset pipeline (host-side), mirror of the reference loader (port
of egohmr_tpu/data/egobody.py: the dataset, `collate` and `MoCapDataset` are
NumPy copies; `to_device_batch` and `finalize_batch` are the torch versions).

Reimplementation of reference dataloaders/egobody_dataset.py:14-279 without
torch/cv2/pandas-hard dependencies: PIL for JPEG decode, csv for the
scene-name table, numpy everywhere. Batches come out exactly in the key
layout the models expect (images NHWC; the reference is NCHW).

Differences by design:
  * No per-worker torch SMPL forward: items needing a translation fix-up
    after augmentation are flagged and fixed in one batched device call
    (`finalize_batch`), reference augmentation.py:446-460 / SURVEY.md §3.5.
  * Body-rep normalization stats are computed vectorized
    (reference egobody_dataset.py:101-117) via `data/stats.py`.
"""
from __future__ import annotations

import json
import pickle
from dataclasses import dataclass, field
from os.path import basename, join
from typing import Dict, Iterator, List, Optional

import numpy as np

from .augment import AugmentConfig, AugmentParams, draw_augment_params, get_example
from .synthetic import to_torch

FX_NORM_COEFF = 1500.0  # reference configs/prohmr.yaml:56-59
FY_NORM_COEFF = 1500.0
IMAGE_MEAN = 255.0 * np.array([0.485, 0.456, 0.406])
IMAGE_STD = 255.0 * np.array([0.229, 0.224, 0.225])


def parse_img_full_path(img_full_path: str):
    """reference utils/other_utils.py:50-57."""
    parts = img_full_path.split("/")
    return parts[-5], parts[-4], parts[-3], parts[-1]


@dataclass
class EgoBodyDataset:
    """EgoBody annotations + scene point clouds.

    Args mirror reference DatasetEgobody (egobody_dataset.py:16-34).
    """

    dataset_file: str
    data_root: str
    split: str = "train"
    train: bool = True
    spacing: int = 1
    add_scale: float = 1.0
    do_augment: bool = False
    scene_type: str = "cube"           # 'whole_scene' | 'cube'
    scene_cano: bool = True
    scene_downsample_rate: int = 1
    load_stage1_transl: bool = False
    stage1_result_path: str = ""
    scene_crop_by_stage1_transl: bool = False
    img_size: int = 224
    augment_config: AugmentConfig = field(default_factory=AugmentConfig)
    seed: int = 0
    # batch-level threaded C++ decode+warp (native.load_batch) in
    # iter_batches — the torch-DataLoader-workers equivalent (reference
    # train_egohmr.py:95-103 uses num_workers=4); auto-falls back to the
    # per-item Python path when the native lib is unavailable
    use_native_loader: bool = True

    def __post_init__(self):
        data = np.load(self.dataset_file)
        sp = self.spacing

        imgnames = [str(x) for x in data["imgname"]][::sp]
        self.imgname = [join(self.data_root, x) for x in imgnames]
        self.seq_names = [parse_img_full_path(x)[1] for x in imgnames]

        with open(join(self.data_root, "transf_matrices_all_seqs.pkl"), "rb") as f:
            self.transf_matrices = pickle.load(f)

        self.center = data["center"][::sp].astype(np.float32)
        self.scale = data["scale"][::sp].astype(np.float32) * self.add_scale
        self.body_pose = data["pose"].astype(np.float32)[::sp]
        self.betas = data["shape"].astype(np.float32)[::sp]
        self.global_orient = data["global_orient_pv"].astype(np.float32)[::sp]
        self.transl = data["transl_pv"].astype(np.float32)[::sp]
        self.cx = data["cx"].astype(np.float32)[::sp]
        self.cy = data["cy"].astype(np.float32)[::sp]
        self.fx = data["fx"].astype(np.float32)[::sp]
        self.fy = data["fy"].astype(np.float32)[::sp]
        self.keypoints_2d = data["valid_keypoints"][::sp].astype(np.float32)
        self.keypoints_3d = data["3d_joints_pv"].astype(np.float32)[::sp]
        gender = data["gender"][::sp]
        self.gender = np.array(
            [0 if str(g) == "m" else 1 for g in gender], np.int32)

        if self.load_stage1_transl:
            with open(self.stage1_result_path, "rb") as f:
                s1 = pickle.load(f)
            self.stage1_transl = np.asarray(
                s1["pred_cam_full_list"], np.float32)[::sp]

        # scene sources (reference :126-150)
        if self.scene_type == "whole_scene":
            base = join(self.data_root, "Egohmr_scene_preprocess_s1_release")
            with open(join(base, f"pcd_verts_dict_{self.split}.pkl"), "rb") as f:
                self.pcd_verts_dict = pickle.load(f)
            with open(join(base, f"map_dict_{self.split}.pkl"), "rb") as f:
                self.pcd_map_dict = pickle.load(f)
        elif self.scene_type == "cube":
            sub = ("Egohmr_scene_preprocess_cube_s2_from_pred_release"
                   if self.scene_crop_by_stage1_transl
                   else "Egohmr_scene_preprocess_cube_s2_from_gt_release")
            self.pcd_root = join(self.data_root, sub)
        else:
            raise ValueError(f"unknown scene_type {self.scene_type}")

        self.scene_name_dict = self._load_scene_names()
        # opengl<->opencv flip (reference :148)
        self.add_trans = np.array(
            [[1.0, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]])
        self._rng = np.random.RandomState(self.seed)

    def _load_scene_names(self) -> Dict[str, str]:
        import csv

        out = {}
        with open(join(self.data_root, "data_info_release.csv")) as f:
            for row in csv.DictReader(f):
                out[row["recording_name"]] = row["scene_name"]
        return out

    def __len__(self) -> int:
        return len(self.imgname)

    def _transf_matrices_for(self, img_name: str, seq_name: str):
        """reference egobody_dataset.py:154-160."""
        seq = self.transf_matrices[seq_name]
        kinect2holo = seq["trans_kinect2holo"].astype(np.float32)
        timestamp = basename(img_name).split("_")[0]
        holo2pv = seq["trans_world2pv"][str(timestamp)].astype(np.float32)
        return kinect2holo, holo2pv

    def _load_scene(self, image_file: str, kinect2holo, holo2pv) -> np.ndarray:
        """reference egobody_dataset.py:207-225."""
        t = self.add_trans @ (holo2pv @ kinect2holo)
        if self.scene_type == "whole_scene":
            key = "/".join(image_file.split("/")[-5:])
            verts = self.pcd_verts_dict[self.pcd_map_dict[key]]
            return verts @ t[:3, :3].T + t[:3, 3]
        recording = image_file.split("/")[-4]
        img_name = basename(image_file)
        pcd_path = join(self.pcd_root, self.split, recording,
                        image_file.split("/")[-3], img_name[:-3] + "npy")
        verts = np.load(pcd_path)
        calib = join(self.data_root, "calibrations", recording,
                     "cal_trans/kinect12_to_world",
                     self.scene_name_dict[recording] + ".json")
        with open(calib) as f:
            trans_scene_to_main = np.array(json.load(f)["trans"])
        t = t @ np.linalg.inv(trans_scene_to_main)
        return verts @ t[:3, :3].T + t[:3, 3]

    def _load_image(self, path: str) -> np.ndarray:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))

    def _image_shape(self, path: str):
        """(H, W) from the JPEG header only — no pixel decode."""
        from PIL import Image

        with Image.open(path) as im:
            return im.size[1], im.size[0]

    def __getitem__(self, idx: int) -> Dict:
        return self._item(idx, decode_image=True)

    def _item(self, idx: int, *, decode_image: bool) -> Dict:
        image_file = self.imgname[idx]
        k2h, h2p = self._transf_matrices_for(image_file, self.seq_names[idx])
        scene = self._load_scene(image_file, k2h, h2p)
        scene = scene[:: self.scene_downsample_rate]

        aug = (draw_augment_params(self.augment_config, self._rng)
               if self.do_augment else AugmentParams())

        smpl_params = {
            "global_orient": self.global_orient[idx],
            "body_pose": self.body_pose[idx],
            "betas": self.betas[idx],
            "transl": self.transl[idx],
        }
        bbox_size = float(self.scale[idx]) * 200.0
        item = get_example(
            self._load_image(image_file) if decode_image else None,
            float(self.center[idx][0]), float(self.center[idx][1]),
            bbox_size, bbox_size,
            self.keypoints_2d[idx], self.keypoints_3d[idx][:24],
            smpl_params, self.img_size, IMAGE_MEAN, IMAGE_STD, aug,
            float(self.fx[idx]), float(self.cx[idx]), float(self.cy[idx]),
            scene,
            img_shape=None if decode_image else self._image_shape(image_file),
        )
        if decode_image:
            # NCHW -> NHWC (the layout at the package's boundary)
            item["img"] = item["img"].transpose(1, 2, 0)
        item["imgname"] = image_file
        item["gender"] = self.gender[idx]
        item["fx"] = np.float32(self.fx[idx] / FX_NORM_COEFF)
        item["fy"] = np.float32(self.fy[idx] / FY_NORM_COEFF)
        item["cam_cy"] = np.float32(self.cy[idx])
        item["transf_kinect2holo"] = k2h
        item["transf_holo2pv"] = h2p
        if self.load_stage1_transl:
            item["stage1_transl_full"] = self.stage1_transl[idx]
        return item

    def iter_batches(
        self, batch_size: int, *, shuffle: Optional[bool] = None,
        drop_last: bool = True, seed: int = 0, num_threads: int = 0,
        skip_batches: int = 0,
    ) -> Iterator[Dict]:
        """The epoch of order `seed`, in batches, from batch `skip_batches`
        on; the skipped batches are not loaded."""
        from .. import native

        use_native = self.use_native_loader and native.available()
        order = np.arange(len(self))
        if shuffle is None:
            shuffle = self.train
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        n = len(order) if not drop_last else len(order) - len(order) % batch_size
        for start in range(skip_batches * batch_size, n, batch_size):
            idxs = order[start:start + batch_size]
            if not use_native:
                yield collate([self[int(i)] for i in idxs])
                continue
            # annotations on this thread, pixels on ALL cores: the items
            # carry the warp spec, the C++ pool does decode+flip+warp+norm
            # in one pass straight into the [N, S, S, 3] batch buffer
            batch = collate([self._item(int(i), decode_image=False)
                             for i in idxs])
            imgs = native.load_batch(
                [self.imgname[int(i)] for i in idxs],
                batch.pop("_warp_trans"), batch.pop("_do_flip"),
                batch.pop("_color_scale"), IMAGE_MEAN, IMAGE_STD,
                self.img_size, num_threads=num_threads)
            batch["img"] = imgs
            yield batch


def collate(items: List[Dict]) -> Dict:
    """Stack a list of item dicts into a batch dict (numpy)."""
    out: Dict = {}
    keys = items[0].keys()
    for k in keys:
        v0 = items[0][k]
        if isinstance(v0, dict):
            out[k] = collate([it[k] for it in items])
        elif isinstance(v0, str):
            out[k] = [it[k] for it in items]
        elif isinstance(v0, (bool, np.bool_)):
            out[k] = np.array([it[k] for it in items])
        else:
            out[k] = np.stack([np.asarray(it[k]) for it in items])
    return out


HOST_ONLY_KEYS = ("imgname", "transl_needs_recompute", "transf_kinect2holo",
                  "transf_holo2pv", "keypoints_2d_vis_mask")


def to_device_batch(batch: Dict, device="cpu") -> Dict:
    """Copy a collated numpy batch to tensors on `device`, dropping the
    host-only keys. Arrays are copied, never aliased; lists and strings
    pass through.

    Shared by every train/eval CLI (single source for the drop list)."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, str)):
            return x
        return to_torch(x, device)

    return {k: conv(v) for k, v in batch.items() if k not in HOST_ONLY_KEYS}


def finalize_batch(batch: Dict, smpl_male, smpl_female) -> Dict:
    """Recompute SMPL transl for augmented items, in one batched device call.

    The reference runs a torch SMPL forward per augmented worker item
    (augmentation.py:446-460): transl = augmented_pelvis - local_pelvis(pose,
    betas) with the gendered body. Here all items are posed at once; items
    whose `transl_needs_recompute` flag is False keep their original transl.
    Call BEFORE to_device_batch (which strips the flag).
    """
    import torch

    from ..smpl import lbs

    flags = np.asarray(batch.get("transl_needs_recompute", False))
    if not flags.any():
        return batch
    sp = batch["smpl_params"]
    device = smpl_male.v_template.device
    betas, go, bp = (to_torch(np.asarray(sp[k], np.float32), device)
                     for k in ("betas", "global_orient", "body_pose"))
    with torch.no_grad():
        out_m = lbs(smpl_male, betas, go, bp, pose2rot=True)
        out_f = lbs(smpl_female, betas, go, bp, pose2rot=True)
    is_f = (np.asarray(batch["gender"]) == 1)[:, None]
    local_pelvis = np.where(is_f, out_f.joints_smpl[:, 0].cpu().numpy(),
                            out_m.joints_smpl[:, 0].cpu().numpy())
    new_transl = batch["keypoints_3d_full"][:, 0] - local_pelvis
    transl = np.where(flags[:, None], new_transl, sp["transl"])
    batch = dict(batch)
    batch["smpl_params"] = dict(sp)
    batch["smpl_params"]["transl"] = transl.astype(np.float32)
    return batch


class MoCapDataset:
    """CMU-mocap (pose, betas) real samples for the stage-1 discriminator
    (reference dataloaders/mocap_dataset.py:5-26)."""

    def __init__(self, dataset_file: str):
        data = np.load(dataset_file)
        self.pose = data["pose"].astype(np.float32)[:, 3:]  # [N, 69]
        self.betas = data["betas"].astype(np.float32)        # [N, 10]

    def __len__(self):
        return len(self.pose)

    def sample(self, batch_size: int, rng: np.random.RandomState) -> Dict:
        idx = rng.randint(0, len(self), size=batch_size)
        return {"body_pose": self.pose[idx], "betas": self.betas[idx]}
