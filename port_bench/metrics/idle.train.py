"""idle.train: the share of an unprofiled step in which no device
operation runs, in %: one less the device's busy seconds per step in the
profiled slice (the union of its operations' intervals) over the window's
wall seconds per step. The profiler's host cost stretches a profiled step
(the slice's own pace is in the run's notes), and the device's work per
step is what it traces truly; the window's steps are unprofiled."""


def read(ctx: dict):
    sl = ctx.get("slice")
    if ctx.get("kind") != "train" or sl is None or not sl.items or not ctx.get("items") or not ctx.get("wall_s"):
        return None
    return 100.0 * (1.0 - (sl.busy_s() / sl.items) / (ctx["wall_s"] / ctx["items"]))
