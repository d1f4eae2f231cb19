"""Command-line entry points of the port (`python -m danet_densepose2smpl_tpu_torch.cli.train`)."""
