"""vit_attn_ms.serve: device ms per request of the port's `vit.attention`
spans (the attention core, `nn/attention.py::attend`, of each of the
trunk's blocks): the time between each span's two CUDA events, summed over
a request's spans and averaged over the profiled slice's requests.
Nothing where the port has no such span."""

from port_bench.harness.spans import device_ms_per_item


def read(ctx: dict):
    return device_ms_per_item(ctx, "serve.request", ("vit.attention",))
