"""The whole frame's share of the card's bf16 peak, in percent: the model
operations of every frame of the unprofiled window (``harness.work``:
the backbones' convolutions at the input size, and each head query by
the path, anchor plan and budget rung its calib and hint select, or on a
path whose rows follow the image, by the rows the reference gives that
frame's image, ``Cell.head_rows``) over the window's seconds and the 989
TFLOP/s of an H100 SXM."""

from cardbench.harness import work


def read(ctx):
    cell = ctx.cell
    cache = {}
    total = 0.0
    for body, pose, hint in ctx.window.meta:
        rows = cell.head_rows(body, pose)
        if (rows, pose, hint) not in cache:
            cache[rows, pose, hint] = work.frame_flops(
                cell.config, cell.traffic.calibs[pose], hint, rows)
        total += cache[rows, pose, hint]
    return 100.0 * total / ctx.window.elapsed / work.PEAK_BF16
