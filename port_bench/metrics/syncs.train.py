"""syncs.train: blocking host waits per step under the port's
`train.step` span (synchronizing CUDA calls flagged by PyTorch's sync
debug mode while the step is open), averaged over the profiled slice's
steps."""

from port_bench.harness.spans import syncs_per_item


def read(ctx: dict):
    return syncs_per_item(ctx, "train.step")
