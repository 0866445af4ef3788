from . import ops, ref
from .flash_kernel import SOURCES, flash_attention, flash_attention_bwd

__all__ = ["ops", "ref", "SOURCES", "flash_attention", "flash_attention_bwd"]
