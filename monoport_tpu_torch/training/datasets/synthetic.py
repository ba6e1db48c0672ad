"""Synthetic procedural dataset — exact-occupancy training data (a copy of
``monoport_tpu/training/datasets/synthetic.py``).

New capability (the reference has no runnable training data in-tree and
its datasets point at private roots): random soft-ellipsoid "blob people"
rendered orthographically with Lambert shading, plus exact inside/outside
occupancy labels. Lets the full training loop (and the matting net) run
and be tested end-to-end with zero external data.
"""

from __future__ import annotations

import numpy as np


class SyntheticBlobDataset:
    """dataset[i] -> {image [S,S,3], mask [S,S,1], calib [4,4],
    samples_geo [N,3], labels_geo [N,1]}."""

    def __init__(self, size: int = 512, num_sample_geo: int = 5000,
                 length: int = 64, n_blobs: int = 5, seed: int = 0):
        self.size = size
        self.num_sample_geo = num_sample_geo
        self.length = length
        self.n_blobs = n_blobs
        self.seed = seed

    def __len__(self) -> int:
        return self.length

    def _blobs(self, rng: np.random.RandomState):
        centers = rng.uniform(-0.4, 0.4, (self.n_blobs, 3))
        radii = rng.uniform(0.12, 0.35, (self.n_blobs, 3))
        return centers.astype(np.float32), radii.astype(np.float32)

    def occupancy(self, pts: np.ndarray, centers, radii) -> np.ndarray:
        """1 inside a blob, else 0: the min over blobs of the scaled
        distance ``np.linalg.norm((pts - c) / r, axis=-1)`` < 1, computed
        on contiguous columns a blob at a time in the norm's own order,
        (x^2 + y^2) + z^2: bit for bit the same numbers, without numpy's
        slow reduce over a length-3 axis."""
        cols = [np.ascontiguousarray(pts[:, i]) for i in range(3)]
        d_min = None
        for c, r in zip(centers, radii):
            sq = None
            for col, ci, ri in zip(cols, c, r):
                q = (col - ci) / ri
                sq = q * q if sq is None else sq + q * q
            d = np.sqrt(sq)
            d_min = d if d_min is None else np.minimum(d_min, d)
        return (d_min < 1.0).astype(np.float32)

    def __getitem__(self, index: int) -> dict:
        rng = np.random.RandomState(self.seed + index)
        centers, radii = self._blobs(rng)
        s = self.size

        # orthographic render: x -> u, y -> v (flipped), z -> depth
        u = np.linspace(-1, 1, s, dtype=np.float32)
        xx, yy = np.meshgrid(u, -u)  # image row 0 = top = +y
        # ray-march along z with coarse steps for the silhouette + depth
        zs = np.linspace(1, -1, 64, dtype=np.float32)
        d = np.ones((s, s), np.float32) * np.inf
        hit = np.zeros((s, s), bool)
        for z in zs:
            pts = np.stack([xx, yy, np.full_like(xx, z)], -1).reshape(-1, 3)
            occ = self.occupancy(pts, centers, radii).reshape(s, s) > 0.5
            newly = occ & ~hit
            d[newly] = z
            hit |= occ
        mask = hit.astype(np.float32)
        shade = np.where(hit, 0.35 + 0.65 * (d + 1) / 2, 0.0)
        base = rng.uniform(0.3, 1.0, (1, 1, 3)).astype(np.float32)
        image = (shade[..., None] * base) * 2.0 - 1.0  # normalized, bg=-1
        image *= mask[..., None]

        n = self.num_sample_geo
        sigma = 0.05
        surf_idx = rng.randint(0, self.n_blobs, 4 * n)
        dirs = rng.randn(4 * n, 3).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        surface = (centers[surf_idx] + dirs * radii[surf_idx]
                   + rng.randn(4 * n, 3).astype(np.float32) * sigma)
        uniform = rng.uniform(-1, 1, (n // 4, 3)).astype(np.float32)
        pts = np.concatenate([surface, uniform]).astype(np.float32)
        labels = self.occupancy(pts, centers, radii)

        from .ppl import balance_in_out
        pts, labels = balance_in_out(pts, labels, n)

        return {
            "image": image.astype(np.float32),
            "mask": mask[..., None],
            "calib": np.eye(4, dtype=np.float32),
            "samples_geo": pts,
            "labels_geo": labels[:, None],
        }

    def as_train_batch(self, indices) -> dict:
        """Stack items into the train-step batch dict contract."""
        items = [self[int(i)] for i in indices]
        return {
            "images": np.stack([it["image"] for it in items]),
            "points": np.stack([it["samples_geo"] for it in items]),
            "calibs": np.stack([it["calib"] for it in items]),
            "labels": np.stack([it["labels_geo"] for it in items]),
        }
