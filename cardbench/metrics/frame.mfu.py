"""The whole frame's share of the card's bf16 peak, in percent: the model
operations of every frame of the unprofiled window (``harness.work``:
the backbones' convolutions at the input size, and each head query by
the path, anchor plan and budget rung its calib and hint select) over the
window's seconds and the 989 TFLOP/s of an H100 SXM."""

from cardbench.harness import work


def read(ctx):
    cache = {}
    total = 0.0
    for _, pose, hint in ctx.window.meta:
        if (pose, hint) not in cache:
            cache[(pose, hint)] = work.frame_flops(
                ctx.cell.config, ctx.cell.traffic.calibs[pose], hint)
        total += cache[(pose, hint)]
    return 100.0 * total / ctx.window.elapsed / work.PEAK_BF16
