"""Device milliseconds of the cell's backbone forward calls alone: netG's
``filter`` on a frame's image, and netC's ``filter`` on it with netG's last
feature map as the prior where the configuration has netC, in the compute
dtype, one call a body of the cell's traffic after an untimed round. The
device's busy time in the profiler's trace of those calls, a call: CUDA
events around them would time the host's launches too."""

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from cardbench.harness import trace


def read(ctx):
    eng = ctx.cell.engine
    images = ctx.cell.traffic.images.to(eng.compute_dtype)

    def call(b):
        feats = eng.netG.filter(images[b:b + 1])
        if eng.netC is not None:
            eng.netC.filter(images[b:b + 1], feats[-1][-1].float())
        torch.cuda.synchronize()

    with torch.inference_mode():
        for b in range(len(images)):
            call(b)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for b in range(len(images)):
                with record_function(trace.FRAME):
                    call(b)
    tr = trace.reduce(prof, len(images))
    return tr.busy_s / tr.frames * 1e3
