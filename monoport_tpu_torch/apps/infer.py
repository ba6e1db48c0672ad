"""Single image -> coloured mesh (port of ``monoport_tpu/apps/infer.py``):
segment, reconstruct the occupancy volume (the hierarchy, or the dense
grid), extract the mesh, colour its vertices with netC.

The occupancy and colour queries go through the nets' plain heads
(``MonoPortNet.query``), as the JAX app's do: no kernel of ours runs here.
``reconstruct_image`` takes the [512, 512, 3] frame itself, so that it runs
where no image decoder is installed; ``load_image`` needs PIL.

Run:
    python -m monoport_tpu_torch.apps.infer --image person.png \
        --out mesh.obj [--device cpu] [-- recon.resolutions [17,33,65] ...]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..config import get_cfg_defaults
from ..ops.constants import upload_async
from ..pipeline.segmentation import Segmentation
from ..recon.dense import dense_eval
from ..recon.hierarchy import HierarchicalRecon
from ..recon.marching import extract_mesh
from ..utils import save_obj_mesh, save_obj_mesh_with_color
from ..weights import resolve_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--image", required=True)
    parser.add_argument("--out", default="mesh.obj")
    parser.add_argument("--dense", action="store_true",
                        help="exhaustive grid eval instead of hierarchical")
    parser.add_argument("--resolution", type=int, default=0,
                        help="override final resolution (dense mode)")
    parser.add_argument("--max_cells", type=int, default=131072)
    parser.add_argument("--no_color", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (no CPU fallback)")
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        argv, opts = argv[:split], argv[split + 1:]
    else:
        opts = []
    args = parser.parse_args(argv)
    cfg = get_cfg_defaults()
    cfg.merge_from_list(opts)
    cfg.freeze()
    return args, cfg


def load_image(path: str, size: int = 512) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def reconstruct_image(frame: np.ndarray, cfg, device=None, dense: bool = False,
                      resolution: int = 0, max_cells: int = 131072,
                      color: bool = True):
    """[H, W, 3] frame in [0, 1] -> (verts [V, 3], faces [F, 3], colors
    [V, 3] or None), numpy."""
    from .rtl_main import load_networks

    device = resolve_device(device)
    netG, netC = load_networks(cfg, device)
    seg = Segmentation.load_default(device=device)
    mean = torch.tensor(cfg.netG.mean, dtype=torch.float32, device=device)
    std = torch.tensor(cfg.netG.std, dtype=torch.float32, device=device)
    with torch.inference_mode():
        image = upload_async(np.asarray(frame, np.float32)[None], device)
        segm, _, _ = seg(image)
        rgb, alpha = segm[..., :3], segm[..., 3:4]
        input_g = (((rgb * 0.5 + 0.5) - mean) / std) * alpha
        calib = torch.eye(4, device=device)[None]
        feats_g = netG.filter(input_g)

        def query_occ(pts):
            return netG.query(feats_g, pts, calib)[0]

        if dense:
            vol = dense_eval(query_occ, resolution or 65, device=device)
        else:
            recon = HierarchicalRecon(
                resolutions=tuple(cfg.recon.resolutions),
                budgets=tuple(cfg.recon.budgets),
                boundary_tau=cfg.recon.boundary_tau,
                dilate=cfg.recon.dilate,
                balance_value=cfg.recon.balance_value)
            vol = recon(query_occ, device=device)
        verts, faces = extract_mesh(vol, cfg.recon.balance_value,
                                    max_cells=max_cells)
        colors = None
        if netC is not None and color:
            feats_c = netC.filter(rgb * alpha, feats_g[-1][-1])
            pts = torch.as_tensor(verts, device=device)[None]
            preds = netC.query(feats_c, pts, calib)[0]
            colors = np.clip(preds[0].float().cpu().numpy() * 0.5 + 0.5,
                             0, 1)
    return verts, faces, colors


def reconstruct(args, cfg):
    return reconstruct_image(
        load_image(args.image), cfg, device=args.device, dense=args.dense,
        resolution=args.resolution, max_cells=args.max_cells,
        color=not args.no_color)


def main(argv=None):
    args, cfg = parse_args(argv)
    verts, faces, colors = reconstruct(args, cfg)
    print(f"extracted mesh: {len(verts)} verts, {len(faces)} faces")
    if colors is not None:
        save_obj_mesh_with_color(args.out, verts, faces, colors)
    else:
        save_obj_mesh(args.out, verts, faces)
    print(f"saved {args.out}")
    return len(verts)


if __name__ == "__main__":
    main()
