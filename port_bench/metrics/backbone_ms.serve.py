"""backbone_ms.serve: device ms per request of the port's `danet.backbone` span
(the IUV estimator's trunk (HRNet-W48 or PoseResNet-50)): the time between the span's two CUDA events,
averaged over the profiled slice's requests."""

from port_bench.harness.spans import device_ms_per_item


def read(ctx: dict):
    return device_ms_per_item(ctx, "serve.request", ("danet.backbone",))
