"""Backbone <-> DMTRL bridge: per-task heads over backbone features.

This is where the paper's technique plugs into the model substrate: the
backbone's pooled final hidden state is the paper's explicit feature map
phi(.), and the per-task linear heads are trained with DMTRL's
primal-dual W-step (``core.dmtrl.fit``) — the task data (e.g. per-tenant
classification sets) never leaves its worker; only the d-dimensional
delta_b vectors move.

On the card the features run through the flash-attention kernel (dense
backbones) or the SSD chunk kernel (Mamba2), and the fit through the SDCA
kernels of the solver the config names. Every entry point takes
``device``, the card unless the caller asks for the CPU; the backbone's
params must already be there.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.dmtrl import DMTRLConfig, DMTRLResult, resolve_device
from ..core.dmtrl import fit as dmtrl_fit
from ..core.mtl_data import MTLData, from_task_list
from ..models.transformer import trunk

Tensor = torch.Tensor


def pooled_features(cfg: ModelConfig, params, tokens: Tensor) -> Tensor:
    """Mean-pooled final hidden state (B, d_model) in fp32 == phi(x); a
    forward pass only (no graph is built)."""
    with torch.no_grad():
        return trunk(cfg, params, tokens).mean(dim=1).float()


def build_mtl_data_from_backbone(
    cfg: ModelConfig,
    params,
    task_tokens: Sequence[np.ndarray],  # per task: (n_i, S) int32
    task_labels: Sequence[np.ndarray],  # per task: (n_i,) +-1
    batch: int = 32,
    device="cuda",
) -> MTLData:
    """Encode every task's examples with the backbone into phi features,
    each row scaled to unit norm; the ``MTLData`` lands on ``device``.

    In the geo-distributed deployment each worker runs this locally on its
    own task shard with the SAME backbone checkpoint (broadcast once); the
    raw tokens never leave the worker.
    """
    device = resolve_device(device)
    xs: List[np.ndarray] = []
    for toks in task_tokens:
        outs = []
        for i in range(0, toks.shape[0], batch):
            chunk = torch.from_numpy(np.ascontiguousarray(toks[i:i + batch])).to(device)
            outs.append(pooled_features(cfg, params, chunk).cpu().numpy())
        feats = np.concatenate(outs, axis=0)
        feats /= np.maximum(np.linalg.norm(feats, axis=1, keepdims=True), 1e-9)
        xs.append(feats.astype(np.float32))
    return from_task_list(xs, list(task_labels), device=device)


@dataclasses.dataclass
class MTLHeadResult:
    dmtrl: DMTRLResult
    features_dim: int

    def predict(self, feats: np.ndarray, task: int) -> np.ndarray:
        return feats @ self.dmtrl.W[task].cpu().numpy()


def fit_mtl_heads(
    cfg: ModelConfig,
    params,
    task_tokens: Sequence[np.ndarray],
    task_labels: Sequence[np.ndarray],
    dmtrl_cfg: Optional[DMTRLConfig] = None,
    device="cuda",
) -> MTLHeadResult:
    data = build_mtl_data_from_backbone(cfg, params, task_tokens, task_labels, device=device)
    dcfg = dmtrl_cfg or DMTRLConfig(
        loss="hinge", lam=1e-4, outer_iters=3, rounds=10, local_iters=256
    )
    res = dmtrl_fit(dcfg, data, device=device)
    return MTLHeadResult(dmtrl=res, features_dim=data.d)
