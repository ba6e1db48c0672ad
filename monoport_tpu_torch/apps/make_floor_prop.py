"""Draw the five floor props (port of the JAX package's
``scripts/make_floor_prop.py``): an OBJ and a procedural JPEG texture a
set, the reference's OBJ + JPG floor sets (RTL/scene.py:20-43).

The drawings are the JAX script's numpy draws, seed for seed; the OBJs
come out byte-equal to the committed ``monoport_tpu/data/floor/*.obj``,
which the scene reads. The JPEGs go through the port's own encoder
(``pipeline/jpeg.encode_jpeg``, quality 85, 4:4:4), not PIL's, so their
bytes differ from the committed ones. Everything goes to ``--out``: the
app never writes under the JAX package, and it never touches
``monoport_tpu_torch/data/floor_textures.npz`` (the decoded committed
JPEGs, which the serve golden depends on).

Run:
    python -m monoport_tpu_torch.apps.make_floor_prop --out <dir>
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..pipeline.jpeg import encode_jpeg

JPEG_QUALITY = 85
# the JAX package, which this app never writes into
JAX_PACKAGE = os.path.normpath(os.path.join(os.path.dirname(__file__),
                                            os.pardir, os.pardir,
                                            "monoport_tpu"))


def wood_texture(size: int = 512, seed: int = 7) -> np.ndarray:
    """Procedural wood planks: grain stripes + knots + per-plank tint."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    planks = 6
    plank_id = np.floor(y * planks).astype(int)
    # per-plank base tint around a warm brown
    base = np.asarray([0.55, 0.38, 0.24])
    tint = 1.0 + 0.12 * rng.randn(planks, 1)[plank_id, 0][..., None]
    # grain: layered sines along x, phase-shifted per plank, plus noise
    phase = rng.uniform(0, 10, planks)[plank_id]
    grain = (0.5 * np.sin(x * 80 + phase + 3 * y)
             + 0.3 * np.sin(x * 190 + 2 * phase)
             + 0.2 * rng.randn(size, size))
    shade = 1.0 + 0.10 * grain
    # dark seams between planks
    fy = y * planks - np.floor(y * planks)
    seam = np.minimum(fy, 1 - fy)
    shade *= np.clip(seam * 30, 0.55, 1.0)
    img = np.clip(base * tint * shade[..., None], 0.0, 1.0)
    return (img * 255).astype(np.uint8)


def tile_texture(size: int = 512, seed: int = 11) -> np.ndarray:
    """Ceramic tiles: 8x8 grid, per-tile tint, glossy specular streak."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    n = 8
    ty, tx = np.floor(y * n).astype(int), np.floor(x * n).astype(int)
    base = np.asarray([0.72, 0.74, 0.78])
    tint = 1.0 + 0.08 * rng.randn(n, n)[ty, tx][..., None]
    fy, fx = y * n - np.floor(y * n), x * n - np.floor(x * n)
    seam = np.minimum(np.minimum(fy, 1 - fy), np.minimum(fx, 1 - fx))
    shade = np.clip(seam * 22, 0.45, 1.0)
    gloss = 1.0 + 0.10 * np.exp(-((fx + fy - 1.0) ** 2) * 12)
    img = np.clip(base * tint * (shade * gloss)[..., None], 0, 1)
    return (img * 255).astype(np.uint8)


def stone_texture(size: int = 512, seed: int = 23) -> np.ndarray:
    """Slate stone: multi-octave value noise + cracks."""
    rng = np.random.RandomState(seed)
    img = np.zeros((size, size), np.float32)
    for octv in (8, 16, 32, 64):
        coarse = rng.randn(octv, octv).astype(np.float32)
        reps = size // octv
        img += np.kron(coarse, np.ones((reps, reps), np.float32)) / octv * 8
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    cracks = np.abs(np.sin(x * 23 + 3 * img) * np.sin(y * 17 - 2 * img))
    shade = np.clip(0.75 + 0.15 * img - 0.25 * (cracks > 0.985), 0.2, 1.0)
    base = np.asarray([0.45, 0.47, 0.50])
    return (np.clip(base * shade[..., None], 0, 1) * 255).astype(np.uint8)


def carpet_texture(size: int = 512, seed: int = 37) -> np.ndarray:
    """Woven carpet: crosshatch fibers + a simple border motif."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    weave = (0.5 * np.sin(x * 640) * np.sin(y * 640)
             + 0.15 * rng.randn(size, size))
    base = np.asarray([0.50, 0.18, 0.16])
    border = ((np.minimum(np.minimum(x, 1 - x), np.minimum(y, 1 - y))
               < 0.08).astype(np.float32))
    color = base * (1 - border[..., None]) \
        + np.asarray([0.75, 0.62, 0.30]) * border[..., None]
    img = np.clip(color * (0.85 + 0.15 * weave)[..., None], 0, 1)
    return (img * 255).astype(np.uint8)


def parquet_texture(size: int = 512, seed: int = 51) -> np.ndarray:
    """Herringbone parquet: alternating diagonal grain blocks."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    n = 8
    by, bx = np.floor(y * n).astype(int), np.floor(x * n).astype(int)
    diag = (bx + by) % 2
    u = np.where(diag > 0, x + y, x - y)
    phase = rng.uniform(0, 9, (n, n))[by, bx]
    grain = 0.5 * np.sin(u * 160 + phase) + 0.2 * rng.randn(size, size)
    base = np.asarray([0.58, 0.42, 0.26]) * (1 + 0.1 * (diag - 0.5))[..., None]
    fy, fx = y * n - by, x * n - bx
    seam = np.minimum(np.minimum(fy, 1 - fy), np.minimum(fx, 1 - fx))
    shade = np.clip(seam * 35, 0.6, 1.0) * (1 + 0.08 * grain)
    return (np.clip(base * shade[..., None], 0, 1) * 255).astype(np.uint8)


def _write_obj(path: str, quads: list) -> None:
    """quads: [(z, corners [(x, y)] x 4, uvs [(u, v)] x 4)] -> an OBJ of two
    triangles a quad, each vertex with its uv."""
    lines = ["# monoport_tpu floor prop (generated)"]
    faces = []
    for q, (z, corners, uvs) in enumerate(quads):
        lines += [f"v {vx:.3f} {vy:.3f} {z:.3f}" for vx, vy in corners]
        lines += [f"vt {u:.4f} {v:.4f}" for u, v in uvs]
        a = 4 * q + 1
        faces.append(f"f {a}/{a} {a+1}/{a+1} {a+2}/{a+2}")
        faces.append(f"f {a}/{a} {a+2}/{a+2} {a+3}/{a+3}")
    with open(path, "w") as f:
        f.write("\n".join(lines + faces) + "\n")


def plank_obj(path: str, planks: int = 6, span_cm: float = 150.0) -> None:
    """OBJ plank grid in the x-y plane spanning ~span_cm (load_floor
    swaps y<->z and rescales by /150, RTL/scene.py semantics); a small
    per-plank height jitter gives the z-buffer real work."""
    s = span_cm / 2
    quads = []
    for p in range(planks):
        y0 = -s + p / planks * span_cm
        y1 = -s + (p + 1) / planks * span_cm
        v0, v1 = p / planks, (p + 1) / planks
        quads.append((0.3 * np.sin(p * 2.1),
                      ((-s, y0), (s, y0), (s, y1), (-s, y1)),
                      ((0, v0), (1, v0), (1, v1), (0, v1))))
    _write_obj(path, quads)


def grid_obj(path: str, n: int = 8, span_cm: float = 150.0,
             bump: float = 0.15) -> None:
    """OBJ n x n quad grid with slight per-cell height jitter."""
    s = span_cm / 2
    quads = []
    for i in range(n):
        for j in range(n):
            x0, x1 = -s + i / n * span_cm, -s + (i + 1) / n * span_cm
            y0, y1 = -s + j / n * span_cm, -s + (j + 1) / n * span_cm
            quads.append((bump * np.sin(i * 1.7 + j * 2.3),
                          ((x0, y0), (x1, y0), (x1, y1), (x0, y1)),
                          ((i / n, j / n), ((i + 1) / n, j / n),
                           ((i + 1) / n, (j + 1) / n), (i / n, (j + 1) / n))))
    _write_obj(path, quads)


# the five sets (the reference ships five OBJ+JPG sets): name -> (texture,
# OBJ writer)
SETS = {
    "floor": (wood_texture, plank_obj),
    "floor_tiles": (tile_texture, lambda p: grid_obj(p, n=8)),
    "floor_stone": (stone_texture, lambda p: grid_obj(p, n=4, bump=0.4)),
    "floor_carpet": (carpet_texture, lambda p: grid_obj(p, n=1, bump=0.0)),
    "floor_parquet": (parquet_texture, lambda p: grid_obj(p, n=8,
                                                          bump=0.05)),
}


def main(argv=None) -> list[str]:
    """-> the files written."""
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True, help="directory of the props")
    args = p.parse_args(argv)
    out = os.path.abspath(args.out)
    if os.path.commonpath([out, JAX_PACKAGE]) == JAX_PACKAGE:
        raise SystemExit(f"--out {out} lies in the JAX package: its floor "
                         f"props are committed and stay as they are")
    os.makedirs(out, exist_ok=True)
    written = []
    for name, (tex_fn, obj_fn) in SETS.items():
        obj_fn(os.path.join(out, f"{name}.obj"))
        with open(os.path.join(out, f"{name}.jpg"), "wb") as f:
            f.write(encode_jpeg(tex_fn(), quality=JPEG_QUALITY))
        written += [os.path.join(out, f"{name}.{ext}") for ext in
                    ("obj", "jpg")]
    print("wrote", out, list(SETS), flush=True)
    return written


if __name__ == "__main__":
    main()
