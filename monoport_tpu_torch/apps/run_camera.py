"""Streamer + segmentation demo without reconstruction (port of
``monoport_tpu/apps/run_camera.py``): camera / video / images ->
Segmentation -> side-by-side display (or a frame count, headless).

Run: python -m monoport_tpu_torch.apps.run_camera --image_folder ./frames \
         [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.constants import upload_async
from ..pipeline.runtime import Pipeline
from ..pipeline.segmentation import Segmentation
from ..pipeline.streamer import open_stream
from ..weights import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--camera", action="store_true")
    parser.add_argument("--images", default=[], nargs="*")
    parser.add_argument("--image_folder", default=None)
    parser.add_argument("--videos", default=[], nargs="*")
    parser.add_argument("--loop", action="store_true")
    parser.add_argument("--show", action="store_true")
    parser.add_argument("--max_frames", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (no CPU fallback)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    seg = Segmentation.load_default(device=device)

    def stage_segment(frame):
        with torch.inference_mode():
            image = upload_async(np.asarray(frame, np.float32)[None], device)
            segm, bboxes, probs = seg(image)
            return {"input": frame, "segm": segm[0].cpu().numpy(),
                    "bboxes": bboxes.cpu().numpy(),
                    "probs": probs.cpu().numpy()}

    stage_segment.__name__ = "segment"
    stream = open_stream(camera=args.camera, videos=args.videos,
                         images=args.images,
                         image_folder=args.image_folder, loop=args.loop)
    pipeline = Pipeline(stream, [stage_segment], name="run_camera")

    n = 0
    for d in pipeline:
        n += 1
        if args.show:  # pragma: no cover - UI path
            import cv2
            masked = ((d["segm"][..., :3] * 0.5 + 0.5)
                      * d["segm"][..., 3:4])
            window = np.hstack([d["input"], masked])
            cv2.imshow("segmentation", window[..., ::-1])
            if cv2.waitKey(1) == ord("q"):
                break
        if args.max_frames and n >= args.max_frames:
            pipeline.close()
            break
    print(pipeline.report())
    return n


if __name__ == "__main__":
    main()
