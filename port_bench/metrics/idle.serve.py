"""idle.serve: the share of the profiled slice's wall time in which no
device operation runs (the union of their intervals), in %."""


def read(ctx: dict):
    sl = ctx.get("slice")
    if ctx.get("kind") != "serve" or sl is None or sl.window_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.window_s)
