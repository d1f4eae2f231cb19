"""syncs.serve: blocking host waits per request under the port's
`serve.request` span (synchronizing CUDA calls flagged by PyTorch's sync
debug mode while the request is open), averaged over the profiled slice's
requests."""

from port_bench.harness.spans import syncs_per_item


def read(ctx: dict):
    return syncs_per_item(ctx, "serve.request")
