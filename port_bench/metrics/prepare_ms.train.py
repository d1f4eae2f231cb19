"""prepare_ms.train: device ms per step of the port's `train.ingest` and
`train.prepare_targets` spans (the ingest on the card, and the GT
preparation with K4's raster): the time between each span's two CUDA
events, summed over the two and averaged over the profiled slice's steps."""

from port_bench.harness.spans import device_ms_per_item


def read(ctx: dict):
    return device_ms_per_item(ctx, "train.step", ("train.ingest", "train.prepare_targets"))
