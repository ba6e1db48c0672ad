"""netG's backbone's share of the card's peak, in percent: the
backbone's convolution operations at the input size (``work.backbone_flops``
of the configuration's ``netG`` backbone, batch 1) over the device time a
frame launched inside the program's ``backbone.netG`` span (the graph
replay with its input copy and the maps' upcast; ``harness/spans.py``)
and the peak of the profile's compute dtype (989 TFLOP/s bf16, 67
TFLOP/s f32). Nothing to read where the program records no spans or the
span launched nothing."""

from cardbench.harness import spans, work


def read(ctx):
    r = spans.readings(ctx)
    if r is None:
        return None
    ms = r.device_ms.get("backbone.netG", 0.0)
    if ms <= 0.0:
        return None
    config = ctx.cell.config
    peak = (work.PEAK_F32 if config["profile"]["compute_dtype"] == "float32"
            else work.PEAK_BF16)
    flops = work.backbone_flops(config["netG"]["backbone"],
                                config["image_size"])
    return 100.0 * flops / (ms * 1e-3) / peak
