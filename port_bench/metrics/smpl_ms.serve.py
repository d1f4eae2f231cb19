"""smpl_ms.serve: device ms per request of the port's `serve.smpl` span
(SMPL LBS to the mesh and the joints): the time between the span's two CUDA events,
averaged over the profiled slice's requests."""

from port_bench.harness.spans import device_ms_per_item


def read(ctx: dict):
    return device_ms_per_item(ctx, "serve.request", ("serve.smpl",))
