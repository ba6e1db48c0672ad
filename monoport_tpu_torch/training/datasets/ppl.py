"""RenderPeople training datasets (a copy of
``monoport_tpu/training/datasets/ppl.py``: numpy only).

Reference contracts: monoport/lib/dataset/ppl_dynamic.py (posed-scan
renders: subject/action/frame x 360 yaw rotations; calib txt of stacked
4x4 extrinsic + 4x4 intrinsic; z-centering on hip/center; scale/flip
augmentation; occupancy samples drawn from 100 precomputed .npy files,
surface:uniform = 4N : N/4, rebalanced 50/50 in/out) and
monoport/lib/dataset/ppl_static.py (PIFu-format static scans: calib from a
.npy param dict of ortho_ratio/scale/center/R).

Differences by design: dataset roots are **config**, not hardcoded
(reference hardcodes /home/rui/... at ppl_dynamic.py:46-47); arrays are
numpy NHWC, moved to the device by the training loop; the fault-tolerant
random-retry of
``__getitem__`` and the startup sanity check are preserved.
"""

from __future__ import annotations

import glob
import os
import random
from typing import Sequence

import numpy as np

from .utils import load_image, projection


def load_calib_dynamic(calib_path: str) -> np.ndarray:
    """Stacked 8x4 txt: intrinsic @ extrinsic (ppl_dynamic.py:12-18)."""
    data = np.loadtxt(calib_path, dtype=float)
    return (data[4:8, :4] @ data[:4, :4]).astype(np.float64)


def load_calib_static(calib_path: str, render_size: int = 512) -> np.ndarray:
    """PIFu .npy param dict -> calib (ppl_static.py:10-39)."""
    param = np.load(calib_path, allow_pickle=True)
    ortho_ratio = param.item().get("ortho_ratio")
    scale = param.item().get("scale")
    center = param.item().get("center")
    rot = param.item().get("R")

    translate = -(rot @ center).reshape(3, 1)
    extrinsic = np.eye(4)
    extrinsic[:3, :3] = rot
    extrinsic[:3, 3:4] = translate
    scale_intrinsic = np.diag(
        [scale / ortho_ratio, -scale / ortho_ratio, scale / ortho_ratio, 1.0])
    uv = 1.0 / float(render_size // 2)
    uv_intrinsic = np.diag([uv, uv, uv, 1.0])
    return uv_intrinsic @ scale_intrinsic @ extrinsic


def balance_in_out(samples: np.ndarray, inside: np.ndarray,
                   num_sample: int) -> tuple[np.ndarray, np.ndarray]:
    """50/50 in/out rebalancing (ppl_dynamic.py:281-294)."""
    inside_samples = samples[inside > 0.5]
    outside_samples = samples[inside <= 0.5]
    nin = inside_samples.shape[0]
    if nin > num_sample // 2:
        inside_samples = inside_samples[:num_sample // 2]
        outside_samples = outside_samples[:num_sample // 2]
    else:
        outside_samples = outside_samples[:num_sample - nin]
    pts = np.concatenate([inside_samples, outside_samples], 0)
    labels = np.concatenate([np.ones(len(inside_samples)),
                             np.zeros(len(outside_samples))])
    return pts.astype(np.float32), labels.astype(np.float32)


class _PPLBase:
    def __init__(self, cfg, root_render: str, mean=(0.5, 0.5, 0.5),
                 std=(0.5, 0.5, 0.5), training: bool = True,
                 split: str = "train"):
        self.cfg = cfg
        self.root_render = root_render
        self.mean, self.std = mean, std
        self.training = training if split == "train" else False
        self.split = split
        # every 1 degree in the reference (ppl_dynamic.py:58-59); stride is
        # config here so fixture trees can ship a handful of rotations
        self.rotations = range(0, 360, int(cfg.get("rotation_step", 1)) or 1)
        self.motion_list: list = []

    def __len__(self):
        return len(self.motion_list) * len(self.rotations)

    def __getitem__(self, index):
        # fault tolerance: any failure retries a random sample
        # (ppl_dynamic.py:61-66)
        try:
            return self.get_item(index)
        except Exception as e:  # noqa: BLE001
            print(e)
            return self.get_item(random.randint(0, len(self) - 1))

    def _decode(self, index):
        rid = index % len(self.rotations)
        mid = index // len(self.rotations)
        return self.motion_list[mid], self.rotations[rid]

    def _augment(self, calib, image_path, mask_path=None, scale_base=1.0):
        if self.training:
            scale = random.uniform(0.9, 1.1) * scale_base
        else:
            scale = scale_base
        calib = calib.copy()
        calib[0:3] *= scale
        aug = dict(blur=self.cfg.blur, brightness=self.cfg.aug_bri,
                   contrast=self.cfg.aug_con, saturation=self.cfg.aug_sat,
                   hue=self.cfg.aug_hue) if self.training else {}
        image, mask = load_image(image_path, mask_path,
                                 crop_size=int(512 / scale),
                                 input_size=int(self.cfg.get("input_size",
                                                             512) or 512),
                                 mean=self.mean, std=self.std, **aug)
        if self.training and random.random() < 0.5:
            calib[0, :] *= -1
            image = image[:, ::-1].copy()
            mask = mask[:, ::-1].copy()
        return calib.astype(np.float32), image, mask


class PPLDynamicDataset(_PPLBase):
    """Posed-scan dataset (ppl_dynamic.py:38-298); roots from cfg."""

    def __init__(self, cfg, root_render: str, root: str = "",
                 val_subjects: Sequence[str] = (), **kw):
        super().__init__(cfg, root_render, **kw)
        self.val_subjects = set(val_subjects)
        self.motion_list = self._scan_motions()
        self.sanity_check()

    def _scan_motions(self):
        paths = sorted(glob.glob(
            os.path.join(self.root_render, "*/*/*/render")))
        train, val = [], []
        for path in paths:
            parts = path.split("/")
            subject, action, frame = parts[-4], parts[-3], int(parts[-2])
            (val if subject in self.val_subjects else train).append(
                [subject, action, frame])
        return train if self.split == "train" else val

    # -- path scheme (ppl_dynamic.py:214-260) -------------------------------
    def _mdir(self, motion):
        subject, action, frame = motion
        return os.path.join(self.root_render, subject, action, f"{frame:06d}")

    def get_image_path(self, motion, rotation):
        return os.path.join(self._mdir(motion), "render",
                            f"{rotation:03d}.png")

    def get_calib_path(self, motion, rotation):
        return os.path.join(self._mdir(motion), "calib",
                            f"{rotation:03d}.txt")

    def get_mesh_path(self, motion):
        return os.path.join(self._mdir(motion), "mesh_poisson.obj")

    def get_center_path(self, motion):
        return os.path.join(self._mdir(motion), "center.txt")

    def get_skeleton_path(self, motion):
        return os.path.join(self._mdir(motion), "skeleton.txt")

    def get_scale_path(self, motion):
        return os.path.join(self._mdir(motion), "scale.txt")

    def get_sample_path(self, motion):
        return os.path.join(self._mdir(motion),
                            f"samples_{self.cfg.sigma_geo:.2f}_v3")

    def sanity_check(self):
        """Drop motions with missing files / bad skeletons / out-of-frustum
        projections before training (ppl_dynamic.py:181-212)."""
        valid = []
        rotation = self.rotations[-1]
        for motion in self.motion_list:
            needed = [self.get_image_path(motion, rotation),
                      self.get_mesh_path(motion),
                      self.get_calib_path(motion, rotation),
                      self.get_sample_path(motion),
                      self.get_center_path(motion)]
            if not all(os.path.exists(p) for p in needed):
                continue
            skel_path = self.get_skeleton_path(motion)
            if os.path.exists(skel_path):
                skel = np.loadtxt(skel_path, usecols=[1, 2, 3]) / 100
                if skel[6, 1] < skel[1, 1]:  # head below hip
                    continue
                calib = load_calib_dynamic(
                    self.get_calib_path(motion, rotation))
                proj = projection(skel, calib)
                if proj.min() < -1.0 or proj.max() > 1.0:
                    continue
            valid.append(motion)
        self.motion_list = valid

    def get_item(self, index):
        motion, rotation = self._decode(index)
        calib = load_calib_dynamic(self.get_calib_path(motion, rotation))

        # z-center on precomputed center (ppl_dynamic.py:79-87)
        center = np.loadtxt(self.get_center_path(motion)).reshape(1, 3)
        calib[2, 3] -= projection(center, calib).reshape(3)[2]

        scale_base = 1.0
        if self.cfg.scale_uniform:
            scale_base = 1.8 / np.loadtxt(self.get_scale_path(motion))[1]

        calib, image, mask = self._augment(
            calib, self.get_image_path(motion, rotation),
            scale_base=scale_base)

        data = {"image": image, "mask": mask, "calib": calib}
        if self.cfg.num_sample_geo:
            pts, labels = self.get_sampling_geo(motion)
            data.update({"samples_geo": pts, "labels_geo": labels})
        if self.cfg.num_sample_color:
            pts_c, rgb = self.get_sampling_color(motion)
            data.update({"samples_color": pts_c, "labels_color": rgb})
        return data

    def get_sampling_geo(self, motion):
        """surface(4N) + uniform(N/4) from 100 pre-baked files, rebalanced
        (ppl_dynamic.py:262-298)."""
        num_sample = self.cfg.num_sample_geo
        path = self.get_sample_path(motion)
        surface = np.load(os.path.join(
            path, f"surface_{random.randint(0, 99)}.npy"))
        surface = surface[np.random.choice(
            len(surface), min(4 * num_sample, len(surface)), replace=False)]
        uniform = np.load(os.path.join(
            path, f"uniform_{random.randint(0, 99)}.npy"))
        uniform = uniform[np.random.choice(
            len(uniform), min(num_sample // 4, len(uniform)), replace=False)]
        samples = np.concatenate([surface, uniform])
        np.random.shuffle(samples)
        return balance_in_out(samples[:, :3], samples[:, 3], num_sample)

    def get_sampling_color(self, motion):
        """netC color supervision: exact-surface points + their albedo
        from the pre-baked color_{i}.npy files ([N, 6] xyz + rgb in
        [0, 1]), positions jittered by sigma_color, colors normalized to
        [-1, 1] (the tanh head's range).

        The reference RESERVES this path (cfg.num_sample_color /
        sigma_color, common/config.py:88-90) but raises
        NotImplementedError at ppl_dynamic.py:144 — implemented here to
        the PIFu contract its config names: surface samples with tight
        positional jitter, view-consistent color labels. Labels stay
        valid under the flip/scale augs because the fixture's albedo
        field is x-flip-invariant by construction
        (fixture._texture_pattern) and world-space (calib scaling moves
        the image, not the field)."""
        num = self.cfg.num_sample_color
        path = self.get_sample_path(motion)
        data = np.load(os.path.join(
            path, f"color_{random.randint(0, 99)}.npy"))
        pick = np.random.choice(len(data), num, replace=len(data) < num)
        pts = (data[pick, :3]
               + np.random.randn(num, 3) * self.cfg.sigma_color)
        rgb = data[pick, 3:6] * 2.0 - 1.0
        return pts.astype(np.float32), rgb.astype(np.float32)


class PPLStaticDataset(_PPLBase):
    """PIFu-format static-scan dataset (ppl_static.py:42-161)."""

    def __init__(self, cfg, root: str, **kw):
        super().__init__(cfg, root, **kw)
        self.motion_list = sorted(
            os.path.basename(p)
            for p in glob.glob(os.path.join(root, "RENDER", "*")))
        if not self.motion_list:  # flat layout: root/<subject>/...
            self.motion_list = sorted(
                os.path.basename(p)
                for p in glob.glob(os.path.join(root, "*"))
                if os.path.isdir(p))

    def get_image_path(self, subject, rotation):
        return os.path.join(self.root_render, "RENDER", subject,
                            f"{rotation}_0_00.jpg")

    def get_mask_path(self, subject, rotation):
        return os.path.join(self.root_render, "MASK", subject,
                            f"{rotation}_0_00.png")

    def get_calib_path(self, subject, rotation):
        return os.path.join(self.root_render, "PARAM", subject,
                            f"{rotation}_0_00.npy")

    def get_sample_path(self, subject):
        return os.path.join(self.root_render,
                            f"SAMPLE_{self.cfg.sigma_geo:.2f}", subject)

    def get_item(self, index):
        subject, rotation = self._decode(index)
        calib = load_calib_static(self.get_calib_path(subject, rotation))
        calib, image, mask = self._augment(
            calib, self.get_image_path(subject, rotation),
            self.get_mask_path(subject, rotation))
        data = {"image": image, "mask": mask, "calib": calib}
        if self.cfg.num_sample_geo:
            pts, labels = self.get_sampling_geo(subject)
            data.update({"samples_geo": pts, "labels_geo": labels})
        return data

    def get_sampling_geo(self, subject):
        """Cached sample tensors (ppl_static.py:155-160): files hold
        [N, 4] (xyz, inside) arrays."""
        num_sample = self.cfg.num_sample_geo
        files = glob.glob(os.path.join(self.get_sample_path(subject), "*.npy"))
        samples = np.load(random.choice(files))
        np.random.shuffle(samples)
        return balance_in_out(samples[:, :3], samples[:, 3], num_sample)
