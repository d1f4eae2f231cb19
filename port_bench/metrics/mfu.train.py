"""mfu.train: the reference step's forward and backward FLOPs per image
times the images the window stepped, over the window's wall time times
the peak of the step's compute precision, in %."""

from port_bench.harness.yardstick import PEAK_FLOPS


def read(ctx: dict):
    if ctx.get("kind") != "train" or not ctx.get("flops_per_image") or not ctx.get("wall_s"):
        return None
    return 100.0 * ctx["flops_per_image"] * ctx["images"] / (ctx["wall_s"] * PEAK_FLOPS[ctx["dtype"]])
