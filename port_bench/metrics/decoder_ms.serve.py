"""decoder_ms.serve: device ms per request of the port's `hmr2.head` span
(HMR 2.0's SMPL transformer-decoder head, its readouts and the 6D
conversion): the time between the span's two CUDA events, averaged over
the profiled slice's requests. Nothing where the port has no such span."""

from port_bench.harness.spans import device_ms_per_item


def read(ctx: dict):
    return device_ms_per_item(ctx, "serve.request", ("hmr2.head",))
