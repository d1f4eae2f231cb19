"""vit_ms.serve: device ms per request of the port's `hmr2.backbone` span
(HMR 2.0's ViT trunk: the patch embedding, the 32 blocks, the last norm):
the time between the span's two CUDA events, averaged over the profiled
slice's requests. Nothing where the port has no such span."""

from port_bench.harness.spans import device_ms_per_item


def read(ctx: dict):
    return device_ms_per_item(ctx, "serve.request", ("hmr2.backbone",))
