"""mfu.serve: the reference's FLOPs per image times the images the window
completed, over the window's wall time times the peak of the cell's
precision (`harness/yardstick.py`), in %."""

from port_bench.harness.yardstick import PEAK_FLOPS


def read(ctx: dict):
    if ctx.get("kind") != "serve" or not ctx.get("flops_per_image") or not ctx.get("wall_s"):
        return None
    return 100.0 * ctx["flops_per_image"] * ctx["images"] / (ctx["wall_s"] * PEAK_FLOPS[ctx["dtype"]])
