"""Device milliseconds a frame of the port's own CUDA kernels (the wgmma
MLP kernel of every epilogue, the weighted-row pass, and the f32 route's
kernels), by kernel name in the traced frames."""

OURS = ("wgmma_mlp_kernel", "mix_rows_kernel", "xproj_kernel", "mlp_kernel")


def read(ctx):
    seconds = sum(s for name, (s, _) in ctx.trace.by_name.items()
                  if any(k in name for k in OURS))
    return seconds / ctx.trace.frames * 1e3 if seconds > 0.0 else None
