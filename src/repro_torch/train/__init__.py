"""Training substrate of the port: so far the backbone <-> DMTRL head bridge
(``mtl_head``). The optimizer, the training loop and checkpointing are a
later slice (the LM kernels have no backward kernels yet)."""
from . import mtl_head
from .mtl_head import (
    MTLHeadResult,
    build_mtl_data_from_backbone,
    fit_mtl_heads,
    pooled_features,
)

__all__ = [
    "mtl_head",
    "MTLHeadResult",
    "build_mtl_data_from_backbone",
    "fit_mtl_heads",
    "pooled_features",
]
