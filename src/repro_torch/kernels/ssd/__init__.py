from . import ops, ref
from .ssd_kernel import SOURCES, ssd_chunk_bwd_kernel, ssd_chunk_kernel

__all__ = ["ops", "ref", "SOURCES", "ssd_chunk_bwd_kernel", "ssd_chunk_kernel"]
