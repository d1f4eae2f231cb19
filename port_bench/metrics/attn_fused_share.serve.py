"""attn_fused_share.serve: the share of the port's attention calls that
took the fused route (PyTorch's SDPA restricted to its fused backends), in
%: the 'attn.fused' counts over the 'attn.fused' and 'attn.plain' counts
that `nn/attention.py::attend` adds to the span recorder's open item,
summed over the profiled slice's requests. Nothing where the port counts
no such call (a port without the counter)."""

from port_bench.harness.spans import slice_items


def read(ctx: dict):
    items = slice_items(ctx, "serve.request")
    if items is None:
        return None
    fused = sum(it.get("counts", {}).get("attn.fused", 0) for it in items)
    plain = sum(it.get("counts", {}).get("attn.plain", 0) for it in items)
    return 100.0 * fused / (fused + plain) if fused + plain else None
