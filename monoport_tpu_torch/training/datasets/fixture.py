"""Miniature RenderPeople/PIFu fixture trees for the PPL datasets (a copy
of ``monoport_tpu/training/datasets/fixture.py``).

Generates, from an analytic ellipsoid "person", a tree in exactly the
layout `PPLDynamicDataset` (reference monoport/lib/dataset/ppl_dynamic.py:
214-260 path scheme) and `PPLStaticDataset` (ppl_static.py RENDER/MASK/
PARAM/SAMPLE layout) expect — calib txts, RGBA renders, occupancy sample
files, skeleton/center/scale sidecars, an OBJ mesh — so the dataset code
paths (sanity check, aug/flip calib math, 4N:N/4 sampling, retry) can run
end-to-end in CI and in `apps/train.py --dataset ppl_dynamic` smoke runs
without the (environment-unavailable) RenderPeople data.

Geometry is CONSISTENT: the rendered silhouette is the calib-projection of
the analytic ellipsoid, so projecting the generated occupancy samples with
the loaded (augmented/flipped) calib lands inside the rendered mask — the
invariant the tests assert.
"""

from __future__ import annotations

import os

import numpy as np

# analytic "person": ellipsoid at the origin, ~1.6 units tall like the
# reference's world-scale subjects
RADII = (0.30, 0.80, 0.25)
SIZE = 512


def _rotate_y(deg: float) -> np.ndarray:
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4)
    m[0, 0], m[0, 2] = c, s
    m[2, 0], m[2, 2] = -s, c
    return m


def inside(points: np.ndarray) -> np.ndarray:
    """[N, 3] -> bool occupancy of the analytic ellipsoid."""
    return (np.square(points / np.asarray(RADII)).sum(-1) <= 1.0)


# -- rich multi-ellipsoid subjects (round-4 convergence fixture) -----------
#
# A "person" is a union of axis-aligned ellipsoids (torso/head/arms/legs)
# with per-subject randomized proportions. Axis-aligned parts keep the
# rotated render EXACT: under a y-rotation each part's orthographic shadow
# is still an axis-aligned ellipse (the rotation mixes x/z only), centered
# at the rotated center with x-radius hypot(rx cos, rz sin) — the same
# closed form the single-ellipsoid fixture uses.

def rich_person(rng: np.random.RandomState) -> list:
    """-> [(center [3], radii [3]), ...] randomized humanoid."""
    s = rng.uniform(0.75, 1.0)                      # overall scale
    torso = ([0.0, 0.1 * s, 0.0],
             [rng.uniform(0.16, 0.24) * s, rng.uniform(0.32, 0.42) * s,
              rng.uniform(0.12, 0.18) * s])
    head = ([0.0, (0.1 + 0.55) * s, 0.0],
            [0.11 * s, rng.uniform(0.11, 0.15) * s, 0.11 * s])
    parts = [torso, head]
    arm_x = torso[1][0] + 0.07 * s
    for sx in (-1.0, 1.0):
        parts.append(([sx * arm_x, rng.uniform(0.05, 0.25) * s,
                       rng.uniform(-0.05, 0.05) * s],
                      [0.06 * s, rng.uniform(0.22, 0.3) * s, 0.06 * s]))
    for sx in (-1.0, 1.0):
        parts.append(([sx * 0.1 * s, (0.1 - 0.55) * s,
                       rng.uniform(-0.05, 0.05) * s],
                      [0.075 * s, rng.uniform(0.28, 0.36) * s, 0.075 * s]))
    return [(np.asarray(c, np.float64), np.asarray(r, np.float64))
            for c, r in parts]


def inside_multi(points: np.ndarray, parts: list) -> np.ndarray:
    """[N, 3] -> bool union occupancy of a rich_person."""
    hit = np.zeros(points.shape[:-1], bool)
    for c, r in parts:
        hit |= np.square((points - c) / r).sum(-1) <= 1.0
    return hit


def _render_rgba_multi(parts: list, rotation: float, size: int = SIZE,
                       color=(90, 140, 200), textured: bool = False,
                       tex_seed: int = 0):
    """Exact silhouette of the y-rotated person; optionally a sinusoidal
    texture over the fill (appearance variety for the convergence runs —
    occupancy labels are appearance-independent)."""
    from PIL import Image, ImageDraw

    rad = np.deg2rad(rotation)
    img = Image.new("RGBA", (size, size), (0, 0, 0, 0))
    draw = ImageDraw.Draw(img)
    for c, r in parts:
        cx_w = c[0] * np.cos(rad) + c[2] * np.sin(rad)
        rx_p = float(np.hypot(r[0] * np.cos(rad), r[2] * np.sin(rad)))
        cx = (cx_w + 1.0) * size / 2
        cy = (1.0 - c[1]) * size / 2      # intrinsic diag(1,-1,..): v = -y
        a, b = rx_p * size / 2, r[1] * size / 2
        draw.ellipse([cx - a, cy - b, cx + a, cy + b],
                     fill=(*color, 255))
    if textured:
        arr = np.asarray(img).astype(np.float32)
        yy = np.mgrid[0:size, 0:size][0] / size * 2 - 1
        pat = _texture_pattern(yy, tex_seed)
        arr[..., :3] = np.clip(arr[..., :3] * pat[..., None], 0, 255)
        img = Image.fromarray(arr.astype(np.uint8), "RGBA")
    return img


def _texture_pattern(img_y: np.ndarray, tex_seed: int) -> np.ndarray:
    """Multiplicative texture over the VERTICAL image coordinate only.

    Vertical-only is what makes the fixture's texture VIEW-CONSISTENT: a
    y-axis rotation (every fixture render) and the left-right flip aug
    both leave world y — and the intrinsic maps v = -y_world — untouched,
    so a surface point keeps one well-defined albedo across all rendered
    views. That is the property the netC color-label path needs
    (surface_albedo below must equal what the render painted)."""
    trng = np.random.RandomState(tex_seed)
    fy = trng.uniform(3, 12)
    py = trng.uniform(0, 2 * np.pi)
    return 1.0 + 0.35 * np.sin(img_y * fy + py)


def surface_albedo(points: np.ndarray, color=(90, 140, 200),
                   textured: bool = False, tex_seed: int = 0) -> np.ndarray:
    """[N, 3] world points -> [N, 3] albedo in [0, 1]: exactly the color
    _render_rgba_multi paints at those surface points, for every rotation
    of the same motion (the pattern is vertical-only, see
    _texture_pattern; v = -y_world under the fixture intrinsic)."""
    rgb = np.broadcast_to(np.asarray(color, np.float64) / 255.0,
                          points.shape[:-1] + (3,)).copy()
    if textured:
        pat = _texture_pattern(-points[..., 1], tex_seed)
        rgb = np.clip(rgb * pat[..., None], 0.0, 1.0)
    return rgb


def _surface_color_arrays(rng: np.random.RandomState, parts, n: int,
                          color, textured: bool, tex_seed: int):
    """[n, 6] EXACT-surface points + their albedo (the color_{i}.npy
    contents consumed by PPLDynamicDataset.get_sampling_color)."""
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    if parts is not None:
        pick = rng.randint(0, len(parts), n)
        centers = np.stack([parts[i][0] for i in pick])
        radii = np.stack([parts[i][1] for i in pick])
        pts = centers + d * radii
    else:
        pts = d * np.asarray(RADII)
    rgb = surface_albedo(pts, color, textured, tex_seed)
    return np.concatenate([pts, rgb], -1).astype(np.float32)


def _sample_arrays_multi(rng: np.random.RandomState, parts: list, n: int,
                         sigma: float):
    """(surface [n,4], uniform [n,4]) for a rich_person (same file format
    as _sample_arrays; 4th column = inside flag for balance_in_out)."""
    pick = rng.randint(0, len(parts), n)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    centers = np.stack([parts[i][0] for i in pick])
    radii = np.stack([parts[i][1] for i in pick])
    surf = centers + d * radii + rng.randn(n, 3) * sigma
    uni = rng.uniform(-1.0, 1.0, (n, 3))
    pack = lambda p: np.concatenate(  # noqa: E731
        [p, inside_multi(p, parts)[:, None].astype(np.float64)],
        -1).astype(np.float32)
    return pack(surf), pack(uni)


def _render_rgba(rotation: float, size: int = SIZE):
    """Silhouette of the rotated ellipsoid under the ortho calib below."""
    from PIL import Image, ImageDraw

    rx, ry, rz = RADII
    r = np.deg2rad(rotation)
    # x-extent of the y-rotated ellipsoid's projection
    rx_proj = float(np.hypot(rx * np.cos(r), rz * np.sin(r)))
    img = Image.new("RGBA", (size, size), (0, 0, 0, 0))
    draw = ImageDraw.Draw(img)
    cx = cy = size / 2
    a = rx_proj * size / 2
    b = ry * size / 2
    draw.ellipse([cx - a, cy - b, cx + a, cy + b],
                 fill=(90, 140, 200, 255))
    return img


def _sample_arrays(rng: np.random.RandomState, n: int, sigma: float):
    """-> (surface [n,4], uniform [n,4]) sample files' contents: xyz plus
    inside flag (the 4th column consumed by balance_in_out)."""
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    surf = d * np.asarray(RADII) + rng.randn(n, 3) * sigma
    uni = rng.uniform(-1.0, 1.0, (n, 3))
    pack = lambda p: np.concatenate(
        [p, inside(p)[:, None].astype(np.float64)], -1).astype(np.float32)
    return pack(surf), pack(uni)


def _write_obj(path: str):
    with open(path, "w") as f:
        f.write("v 0 0.8 0\nv 0.3 -0.8 0\nv -0.3 -0.8 0\nf 1 2 3\n")


def make_dynamic_fixture(root: str, subjects=("subj_a", "subj_b"),
                         rotations=(0, 120, 240), sigma_geo: float = 0.05,
                         n_points: int = 400, seed: int = 0,
                         broken: bool = True, rich: bool = False,
                         textured: bool = False,
                         n_sample_files: int = 100) -> dict:
    """Emit a PPLDynamicDataset tree under ``root``.

    Each subject gets one action/frame with renders+calibs for
    ``rotations``, ``n_sample_files`` surface + uniform sample files (the
    dataset draws file index randint(0, 99), ppl_dynamic.py:267-273 — keep
    100 for trees the dataset consumes), skeleton/center/scale sidecars
    and a poisson mesh. With ``broken`` three defective motions are added
    that the startup sanity check (ppl_dynamic.py:181-212 semantics) must
    prune: missing files, a head-below-hip skeleton, and an
    out-of-frustum skeleton.

    ``rich=True`` replaces the single shared ellipsoid with a per-subject
    randomized multi-ellipsoid person (rich_person) and per-subject fill
    colors; ``textured`` adds a sinusoidal pattern over the fill — the
    round-4 convergence fixture (multi-subject, multi-rotation, textured,
    geometry still exactly calib-consistent).

    Returns {"good": [motion dirs], "broken": [motion dirs]}.
    """
    rng = np.random.RandomState(seed)
    good, bad = [], []

    def motion_dir(subject, action="walk", frame=0):
        return os.path.join(root, subject, action, f"{frame:06d}")

    def write_motion(mdir, head_y=0.78, skel_x=0.0, skip=(), person=None,
                     color=(90, 140, 200)):
        os.makedirs(os.path.join(mdir, "render"), exist_ok=True)
        os.makedirs(os.path.join(mdir, "calib"), exist_ok=True)
        for rot in rotations:
            if "render" not in skip:
                # one tex_seed for ALL rotations of a motion: the pattern
                # is vertical-only (view-consistent), so every view paints
                # the same surface albedo — the color labels' invariant
                img = (_render_rgba_multi(person, rot, color=color,
                                          textured=textured,
                                          tex_seed=seed)
                       if person is not None else _render_rgba(rot))
                img.save(os.path.join(mdir, "render", f"{rot:03d}.png"))
            extrinsic = _rotate_y(rot)
            intrinsic = np.diag([1.0, -1.0, 1.0, 1.0])
            np.savetxt(os.path.join(mdir, "calib", f"{rot:03d}.txt"),
                       np.concatenate([extrinsic, intrinsic], 0))
        if "mesh" not in skip:
            _write_obj(os.path.join(mdir, "mesh_poisson.obj"))
        np.savetxt(os.path.join(mdir, "center.txt"), np.zeros(3))
        np.savetxt(os.path.join(mdir, "scale.txt"),
                   np.asarray([0.6, 1.6]))  # [width, height] world units
        # skeleton: "name x y z" rows in cm (loader divides by 100,
        # ppl_dynamic.py:190); row 1 = hip, row 6 = head
        ys = [0.0, 0.0, 0.2, 0.4, 0.5, 0.6, head_y]
        with open(os.path.join(mdir, "skeleton.txt"), "w") as f:
            for i, y in enumerate(ys):
                f.write(f"j{i} {skel_x * 100:.1f} {y * 100:.1f} 0.0\n")
        if "samples" not in skip:
            sdir = os.path.join(mdir, f"samples_{sigma_geo:.2f}_v3")
            os.makedirs(sdir, exist_ok=True)
            for i in range(n_sample_files):
                surf, uni = (_sample_arrays_multi(rng, person, n_points,
                                                  sigma_geo)
                             if person is not None
                             else _sample_arrays(rng, n_points, sigma_geo))
                np.save(os.path.join(sdir, f"surface_{i}.npy"), surf)
                np.save(os.path.join(sdir, f"uniform_{i}.npy"), uni)
                # color supervision sites (netC): exact-surface xyz + the
                # albedo the renders painted there — the color-sampling
                # path the reference reserves but never implements
                # (ppl_dynamic.py:144 raises NotImplementedError)
                np.save(os.path.join(sdir, f"color_{i}.npy"),
                        _surface_color_arrays(
                            rng, person, n_points, color,
                            textured and person is not None, seed))

    people = {}
    for subject in subjects:
        mdir = motion_dir(subject)
        person = rich_person(rng) if rich else None
        color = tuple(int(v) for v in rng.randint(60, 220, 3)) \
            if rich else (90, 140, 200)
        write_motion(mdir, person=person, color=color)
        people[subject] = person
        good.append(mdir)

    if broken:
        m = motion_dir("broken_missing")
        write_motion(m, skip=("mesh",))          # mesh_poisson.obj absent
        bad.append(m)
        m = motion_dir("broken_skel")
        write_motion(m, head_y=-0.5)             # head below hip
        bad.append(m)
        m = motion_dir("broken_frustum")
        write_motion(m, skel_x=5.0)              # projects outside [-1, 1]
        bad.append(m)
    return {"good": good, "broken": bad, "people": people}


def make_static_fixture(root: str, subjects=("stat_a", "stat_b"),
                        rotations=(0, 120, 240), sigma_geo: float = 0.05,
                        n_points: int = 400, seed: int = 1,
                        ortho_ratio: float = 0.9, scale: float = 180.0
                        ) -> dict:
    """Emit a PPLStaticDataset (PIFu-format) tree under ``root``:
    RENDER/<s>/<rot>_0_00.jpg + MASK pngs + PARAM npy dicts
    (ortho_ratio/scale/center/R, ppl_static.py:10-39) + SAMPLE files."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    ndc = scale / ortho_ratio / (SIZE // 2)   # world -> NDC coefficient
    for subject in subjects:
        for sub in ("RENDER", "MASK", "PARAM"):
            os.makedirs(os.path.join(root, sub, subject), exist_ok=True)
        sdir = os.path.join(root, f"SAMPLE_{sigma_geo:.2f}", subject)
        os.makedirs(sdir, exist_ok=True)
        for rot in rotations:
            rgba = _render_rgba(rot)
            # static projection differs from dynamic only by the ndc
            # coefficient: rescale the silhouette accordingly
            w = max(2, int(round(SIZE * ndc)))
            scaled = rgba.resize((w, w), Image.BILINEAR)
            canvas = Image.new("RGBA", (SIZE, SIZE), (0, 0, 0, 0))
            canvas.paste(scaled, ((SIZE - w) // 2, (SIZE - w) // 2))
            canvas.convert("RGB").save(
                os.path.join(root, "RENDER", subject, f"{rot}_0_00.jpg"))
            canvas.split()[-1].save(
                os.path.join(root, "MASK", subject, f"{rot}_0_00.png"))
            param = {"ortho_ratio": ortho_ratio, "scale": scale,
                     "center": np.zeros(3),
                     "R": _rotate_y(rot)[:3, :3]}
            np.save(os.path.join(root, "PARAM", subject, f"{rot}_0_00.npy"),
                    param, allow_pickle=True)
        for i in range(5):
            surf, uni = _sample_arrays(rng, n_points, sigma_geo)
            np.save(os.path.join(sdir, f"samples_{i}.npy"),
                    np.concatenate([surf, uni], 0))
    return {"ndc": ndc}
