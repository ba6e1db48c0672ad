"""Train DetectNet on synthetic multi-person scenes made on the device, and
save its weights in the JAX package's npz format (port of
``monoport_tpu/apps/train_detection.py``).

Adam on a cosine schedule (to 5% of ``--lr`` at ``--steps``) from
flax-distributed initial weights; the chunks alternate between
``--sizes`` over one optimizer state, so the schedule's count runs across
the sizes; each size's batch is ``--batch`` scaled down by its area (at
least 2). At the end, each size's held-out matched IOU, precision, recall
and false-positive rate, and the npz (f16, ``__width__``, ``__stride__``)
that ``Detection.load_default`` of either package reads.

Run (on the card; ``--cpu`` for the CPU):
    python -m monoport_tpu_torch.apps.train_detection --steps 3000 \\
        --out detectnet.npz
"""

from __future__ import annotations

import argparse

import torch

from ..parallel.train_step import timed_convolutions
from ..pipeline.detection import DetectNet, decode
from ..training.detection import box_iou, make_train_fns, synth_det_batch
from ..utils import compile_cache
from ..utils.params_io import save_params
from ..weights import resolve_device
from .train_matting import run_chunks


@torch.no_grad()
def evaluate(net: DetectNet, images: torch.Tensor, gt_boxes: torch.Tensor,
             gt_valid: torch.Tensor, thresh: float = 0.3,
             stride: int = 16) -> dict:
    """Held-out evaluation on a batch -> {'iou' (the mean matched IOU of
    the true instances), 'precision', 'recall', 'fp_rate' (false positives
    an instance)}: each true instance takes the free confident detection
    (probability > ``thresh``) of the highest IOU, a match at IOU >= 0.5."""
    net.eval()
    boxes, probs = decode(*net(images * 2.0 - 1.0), stride=stride)
    boxes, probs = boxes.cpu(), probs.cpu()
    gt_boxes, gt_valid = gt_boxes.cpu(), gt_valid.cpu()
    ious, tp, fp, fn = [], 0, 0, 0
    for i in range(images.shape[0]):
        conf = torch.nonzero(probs[i] > thresh)[:, 0].tolist()
        matched = set()
        for j in torch.nonzero(gt_valid[i])[:, 0].tolist():
            cand = {m: float(box_iou(boxes[i, m], gt_boxes[i, j]))
                    for m in conf if m not in matched}
            best = max(cand, key=cand.get) if cand else None
            iou = cand[best] if best is not None else 0.0
            ious.append(iou)
            if iou >= 0.5:
                tp += 1
                matched.add(best)
            else:
                fn += 1
        fp += len([m for m in conf if m not in matched])
    return {"iou": sum(ious) / len(ious) if ious else 1.0,
            "precision": tp / max(tp + fp, 1),
            "recall": tp / max(tp + fn, 1),
            "fp_rate": fp / max(len(ious), 1)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--chunk", type=int, default=100,
                        help="steps between host reads of the loss")
    parser.add_argument("--sizes", default="256,512",
                        help="comma list; the chunks alternate between the "
                        "sizes, so the size and offset heads see the "
                        "demo's 512 frames too")
    parser.add_argument("--batch", type=int, default=8,
                        help="the batch at the smallest size; larger sizes "
                        "scale it down by their area")
    parser.add_argument("--width", type=int, default=16)
    parser.add_argument("--stride", type=int, default=16,
                        help="the output grid's pitch")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the card, which "
                        "must exist)")
    parser.add_argument("--out", default="detectnet.npz")
    args = parser.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    compile_cache.enable()
    timed_convolutions(device)

    net = DetectNet(width=args.width, stride=args.stride).to(device)
    sizes = [int(s) for s in args.sizes.split(",")]
    s_min = min(sizes)
    runs, init_fn = [], None
    for s in sizes:
        b = max(2, args.batch * s_min * s_min // (s * s))
        ifn, run_fn = make_train_fns(net, s, b, args.lr,
                                     total_steps=args.steps)
        init_fn = init_fn or ifn
        runs.append((s, run_fn))
    # one state for every size: its step is the schedule's count
    state = init_fn(torch.Generator().manual_seed(args.seed))
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    result = run_chunks(runs, state, gen, args.steps, args.chunk, device)
    result["chunk_sizes"] = result.pop("chunk_labels")

    heldout = {}
    for s in sizes:
        batch = synth_det_batch(torch.Generator(device=device).manual_seed(
            args.seed + 10_000), 8, s)
        m = heldout[s] = evaluate(net, *batch, stride=args.stride)
        print(f"held-out @{s}: IOU {m['iou']:.4f} precision "
              f"{m['precision']:.3f} recall {m['recall']:.3f} "
              f"fp_rate {m['fp_rate']:.3f}", flush=True)

    save_params(args.out, net, meta={"width": args.width,
                                     "stride": args.stride})
    print(f"saved {args.out}", flush=True)
    return {"iou": min(m["iou"] for m in heldout.values()),
            "heldout": heldout,
            "params": sum(p.numel() for p in net.parameters()), **result}


if __name__ == "__main__":
    main()
