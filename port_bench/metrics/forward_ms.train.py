"""forward_ms.train: device ms per step of the port's `train.forward` span
(the train-mode forward under autocast): the time between the span's two
CUDA events, averaged over the profiled slice's steps."""

from port_bench.harness.spans import device_ms_per_item


def read(ctx: dict):
    return device_ms_per_item(ctx, "train.step", ("train.forward",))
