"""Convert a reference PIFu / MonoPort checkpoint to the port's npz (port
of the JAX package's ``scripts/convert_model.py``).

The reference's ``net_G`` / ``net_C`` files (a legacy PIFu state dict, or
a Trainer dict's ``net``) go through ``convert.load_legacy_pifu`` and are
written as the JAX package's npz (``utils/params_io.save_params``: the
flax parameter tree, f16 on disk), which ``weights.load_params`` /
``build_net`` and the JAX package's ``load_params`` read. The JAX script
writes orbax instead. As in that npz format, BatchNorm running statistics
are not kept (the apps read such nets from the ``.pth`` directly, through
``rtl_main.load_networks``); the line printed counts them.

Run:
    python -m monoport_tpu_torch.apps.convert_model data/PIFu/net_G \\
        out/netG.npz --backbone PIFuHGFilters
"""

from __future__ import annotations

import argparse

from ..convert import load_legacy_pifu
from ..models.backbones import BACKBONES
from ..utils.params_io import save_params


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("src", help="reference checkpoint (.pth)")
    p.add_argument("dst", help="output npz")
    p.add_argument("--backbone", default="PIFuHGFilters",
                   choices=sorted(BACKBONES))
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """-> {'weights': parameters written, 'running_stats': tensors left
    out, 'dst': the npz}."""
    args = parse_args(argv)
    state = load_legacy_pifu(args.src, args.backbone)
    stats = {k: v for k, v in state.items()
             if k.rsplit(".", 1)[-1] in ("running_mean", "running_var",
                                         "num_batches_tracked")}
    params = {k: v for k, v in state.items() if k not in stats}
    save_params(args.dst, params)
    n = sum(v.numel() for v in params.values())
    print(f"converted {n} weights -> {args.dst}"
          + (f" ({len(stats)} BatchNorm statistics not kept)" if stats
             else ""), flush=True)
    return {"weights": n, "running_stats": len(stats), "dst": args.dst}


if __name__ == "__main__":
    main()
