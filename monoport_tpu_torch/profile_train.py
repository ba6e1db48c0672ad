"""The hourglass's slow f32 convolution on the card, under each way of
choosing its algorithm.

    python3 -m monoport_tpu_torch.profile_train

Times one f32 3x3 convolution 256 -> 128 at 128^2, batch 2 (the first
conv of the netG hourglass's ConvBlocks at its 512^2 training shape),
forward and forward + backward (CUDA events, mean of 5 after a warm-up),
with cuDNN's heuristic pick (TF32 off, as chip_smoke's phases run),
cuDNN's timed pick (``cudnn.benchmark``, what the training apps set on
the card through ``train_step.timed_convolutions``), PyTorch's own
convolution (cuDNN off) and cuDNN with TF32.
Each mode runs in a process of its own: PyTorch caches a shape's choice.
One JSON line a mode, then the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys

MODES = ("heuristic", "benchmark", "no_cudnn", "tf32")


def time_conv(mode: str) -> dict:
    import torch
    import torch.nn.functional as F

    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.benchmark = mode in ("benchmark", "tf32")
    torch.backends.cudnn.enabled = mode != "no_cudnn"
    x = torch.randn(2, 256, 128, 128, device="cuda", requires_grad=True)
    w = torch.randn(128, 256, 3, 3, device="cuda", requires_grad=True)
    g = torch.randn(2, 128, 128, 128, device="cuda")

    def ms(fn, reps: int = 5) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    return {"mode": mode, "cudnn": torch.backends.cudnn.version(),
            "fwd_ms": ms(lambda: F.conv2d(x, w, padding=1)),
            "fwd_bwd_ms": ms(lambda: torch.autograd.grad(
                F.conv2d(x, w, padding=1), (x, w), g)),
            "gflop_fwd": 2 * 2 * 128 * 128 * 128 * 256 * 9 / 1e9}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--mode":
        print(json.dumps(time_conv(sys.argv[2])), flush=True)
        return 0
    for mode in MODES:
        subprocess.run([sys.executable, "-m",
                        "monoport_tpu_torch.profile_train", "--mode", mode],
                       check=True, timeout=300)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
