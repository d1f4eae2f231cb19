"""regressor_ms.serve: device ms per request of the port's `danet.regressor` span
(`iuvmap_clean`, `clean_part_stacks` and the SMPL regressor): the time between the span's two CUDA events,
averaged over the profiled slice's requests."""

from port_bench.harness.spans import device_ms_per_item


def read(ctx: dict):
    return device_ms_per_item(ctx, "serve.request", ("danet.regressor",))
