"""The harness of the port's benchmark: cell specs, seeded weights and
inputs, the serve and train loops, the profiled slice, the yardstick and
the comparison with the plain reference under `port_bench/reference/`."""
