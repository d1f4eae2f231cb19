"""The configuration dataclasses of the port.

They are the JAX package's jax-free `core/config.py` classes, re-exported so
that code driving the port imports only the port.
"""

from danet_densepose2smpl_tpu.core.config import (  # noqa: F401
    Config,
    DaNetConfig,
    RefinementConfig,
    SolverConfig,
    TrainConfig,
)

__all__ = ["Config", "DaNetConfig", "RefinementConfig", "SolverConfig", "TrainConfig"]
