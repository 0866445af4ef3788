from . import ops, ref
from .sdca_kernel import (
    SUPPORTED_LOSSES,
    build_all,
    reset_launch_counts,
    sdca_block_kernel,
    sdca_round_kernel,
)

__all__ = [
    "ops",
    "ref",
    "SUPPORTED_LOSSES",
    "build_all",
    "reset_launch_counts",
    "sdca_block_kernel",
    "sdca_round_kernel",
]
