"""What the span metrics read: the port's span recorder
(`danet_densepose2smpl_tpu_torch.utils.profiling.recorded_items`), which
keeps each request (`serve.request`) or step (`train.step`) recorded under
the profiler, with each span's device ms (the time between its two CUDA
events) and its blocking host waits. The profiled slice's items are the
recorder's last `slice.items` of their kind. Nothing where the port has no
recorder, the slice recorded no item, or the spans have no device ms (the
CPU)."""

from __future__ import annotations


def slice_items(ctx: dict, root: str) -> list | None:
    """The profiled slice's items whose first span is `root`, or None."""
    sl = ctx.get("slice")
    if sl is None or not sl.items:
        return None
    try:
        from danet_densepose2smpl_tpu_torch.utils.profiling import recorded_items
    except ImportError:
        return None
    items = [it for it in recorded_items() if it["name"] == root][-sl.items:]
    if not items or any(s["device_ms"] is None for it in items for s in it["spans"]):
        return None
    return items


def device_ms_per_item(ctx: dict, root: str, names) -> float | None:
    """Mean over the slice's items of the device ms of their spans named
    in `names`; None where an item has none of them."""
    items = slice_items(ctx, root)
    if items is None:
        return None
    per = []
    for it in items:
        spans = [s["device_ms"] for s in it["spans"] if s["name"] in names]
        if not spans:
            return None
        per.append(sum(spans))
    return sum(per) / len(per)


def syncs_per_item(ctx: dict, root: str) -> float | None:
    """Mean blocking host waits per item over the slice's items."""
    items = slice_items(ctx, root)
    return None if items is None else sum(it["syncs"] for it in items) / len(items)
