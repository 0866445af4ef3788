from . import ops, ref
from .sdca_kernel import (
    SOURCES,
    SUPPORTED_LOSSES,
    reset_launch_counts,
    sdca_block_kernel,
    sdca_round_kernel,
)

__all__ = [
    "ops",
    "ref",
    "SOURCES",
    "SUPPORTED_LOSSES",
    "reset_launch_counts",
    "sdca_block_kernel",
    "sdca_round_kernel",
]
