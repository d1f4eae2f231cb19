"""bn_fused_share.serve: the share of the port's BatchNorm calls on the card
that took the one-pass kernel, in %: the 'bn_act.fused' counts over the
'bn_act.fused' and 'bn_act.plain' counts that `nn.layers.bn_act` adds to
the span recorder's open item, summed over the profiled slice's requests.
Nothing where the port counts no such call (a port without the counter)."""

from port_bench.harness.spans import slice_items


def read(ctx: dict):
    items = slice_items(ctx, "serve.request")
    if items is None:
        return None
    fused = sum(it.get("counts", {}).get("bn_act.fused", 0) for it in items)
    plain = sum(it.get("counts", {}).get("bn_act.plain", 0) for it in items)
    return 100.0 * fused / (fused + plain) if fused + plain else None
