"""bn_up_fused_share.serve: the share of HRNet's upsampled fuse terms on the
card that took the one-pass kernel's upsampling instance, in %: the
'bn_act.up_fused' counts over the 'bn_act.up_fused' and 'bn_act.up_plain'
counts that `nn.layers.bn_act` adds to the span recorder's open item for
its calls with `up` > 1, summed over the profiled slice's requests.
Nothing where the port counts no such call (a model without HRNet, or a
port without the counter)."""

from port_bench.harness.spans import slice_items


def read(ctx: dict):
    items = slice_items(ctx, "serve.request")
    if items is None:
        return None
    fused = sum(it.get("counts", {}).get("bn_act.up_fused", 0) for it in items)
    plain = sum(it.get("counts", {}).get("bn_act.up_plain", 0) for it in items)
    return 100.0 * fused / (fused + plain) if fused + plain else None
