"""Training substrate of the port: the optimizer, the LM training loop,
checkpointing, and the backbone <-> DMTRL head bridge (``mtl_head``)."""
from . import checkpoint, loop, mtl_head, optimizer
from .loop import TrainLogger, make_sharded_train_step, make_train_step, train
from .mtl_head import (
    MTLHeadResult,
    build_mtl_data_from_backbone,
    fit_mtl_heads,
    pooled_features,
)
from .optimizer import AdamW, AdamWState

__all__ = [
    "checkpoint",
    "loop",
    "mtl_head",
    "optimizer",
    "TrainLogger",
    "make_sharded_train_step",
    "make_train_step",
    "train",
    "AdamW",
    "AdamWState",
    "MTLHeadResult",
    "build_mtl_data_from_backbone",
    "fit_mtl_heads",
    "pooled_features",
]
