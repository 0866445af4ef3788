"""Data pipelines: the paper's MTL datasets (synthetic and offline
stand-ins) and the LM token pipeline for the backbone substrate."""
from . import synthetic, tokens

__all__ = ["synthetic", "tokens"]
