"""Kernel 2's view-pooled form's share of its roofline, in percent: the
multi-view netG's per-point queries of the hierarchy's levels, at the
points the reference's copy of the hierarchy gives each traced frame's
subject (``Cell.head_rows``; ``reference/frames/dense_views.queries``),
over the device time of the port's f32 projection and view-pooled layer
kernels launched inside the program's ``recon.hierarchy`` span
(``harness.spans``: by name and span).

Work a point of V views (``views_point_work``): the layers up to the
pool (``n_layers // 2``) a view, V x (257 x 1,024 + 1,281 x 512 + 769 x
256) = V x 1,115,904 multiply-adds for netG's head, and the layers after
it once, 513 x 128 + 385 x 1 = 66,049; x 2 operations, at the 67 TFLOP/s
of f32 outside the tensor cores. Bytes: each view's input row read once
(4-byte operands), the parameters once, the output written once, at 3.35
TB/s. The bound is the larger of the two times. Nothing to read without
spans or where the kernel did not run (a single-view net, or a program
without the form)."""

from cardbench.harness import spans, work

KERNELS = ("xproj_kernel", "views_mlp_kernel")
SPAN = "recon.hierarchy"


def views_point_work(widths, points: int, views: int):
    """(operations, seconds of them at the f32 peak, bytes) of a
    view-pooled per-point query of ``points`` points of ``views`` views
    each."""
    c_in, outs, n_params = work.head_dims(widths)
    ins = [c_in] + [o + c_in for o in outs[:-1]]
    pool = len(outs) // 2
    per_view = sum(i * o for i, o in zip(ins[:pool + 1], outs[:pool + 1]))
    pooled = sum(i * o for i, o in zip(ins[pool + 1:], outs[pool + 1:]))
    flops = 2.0 * points * (views * per_view + pooled)
    nbytes = points * views * c_in * 4 + n_params * 4 + points * outs[-1] * 4
    return flops, flops / work.PEAK_F32, nbytes


def frame_bound_s(config: dict, rows) -> float:
    """The least time of one frame's view-pooled queries: each level's."""
    w = config["netG"]["head"]["widths"]
    views = config["netG"]["head"]["num_views"]
    return sum(work.bound_s(views_point_work(w, int(n), views))
               for n in rows)


def read(ctx):
    cell = ctx.cell
    views = cell.config["netG"]["head"].get("num_views", 1)
    r = spans.readings(ctx)
    if r is None or views < 2:
        return None
    ms = sum(v for (s, name), v in r.op_ms.items()
             if s == SPAN and any(k in name for k in KERNELS))
    if ms <= 0.0:
        return None
    bound = 0.0
    for i in range(r.traced_from, r.traced_from + r.frames):
        body, pose = cell.traffic.frame(i)
        bound += frame_bound_s(cell.config, cell.head_rows(body, pose))
    return 100.0 * bound / r.frames / (ms * 1e-3)
