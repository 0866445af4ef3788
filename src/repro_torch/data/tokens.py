"""Synthetic LM token pipeline for the backbone substrate.

Deterministic, seeded, shardable: per-host shard assignment, fixed-length
packed sequences, label shifting, and (for the audio arch) the
precomputed frame embeddings that the stub frontend produces.

A copy of ``repro.data.tokens`` (numpy ``RandomState`` only), so both
packages make the same batches and frames from one seed. The arrays stay
numpy; a caller moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov-chain order-1 synthetic text: makes loss curves non-trivial
    n_states: int = 256


class SyntheticTokenPipeline:
    """Order-1 Markov token stream; learnable structure so a few hundred
    training steps produce a visibly decreasing loss."""

    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        k = min(cfg.n_states, cfg.vocab_size)
        self._k = k
        # sparse-ish row-stochastic transition matrix over k "hot" tokens
        logits = rng.randn(k, k).astype(np.float32) * 2.0
        self._P = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        self._cum = np.cumsum(self._P, axis=1)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.RandomState((cfg.seed * 1_000_003 + step) % (2**31 - 1))
        b, s = cfg.global_batch, cfg.seq_len
        toks = np.zeros((b, s + 1), np.int32)
        toks[:, 0] = rng.randint(0, self._k, size=b)
        u = rng.rand(b, s)
        for t in range(s):
            toks[:, t + 1] = np.argmax(self._cum[toks[:, t]] > u[:, t : t + 1], axis=1)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "mask": np.ones((b, s), np.float32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def host_shard(batch: Dict[str, np.ndarray], host_id: int, n_hosts: int):
    """Slice the global batch for one host."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % n_hosts:
            raise ValueError(f"batch {b} does not split over {n_hosts} hosts")
        sl = slice(host_id * (b // n_hosts), (host_id + 1) * (b // n_hosts))
        out[k] = v[sl]
    return out


def embedding_side_inputs(
    kind: str, batch: int, d_model: int, seed: int = 0, frames: int = 1500
) -> Optional[np.ndarray]:
    """Stub modality frontends: precomputed frame embeddings (batch,
    frames, d_model) float32 for audio (whisper); None for the VLM
    (chameleon takes its VQ image tokens as ids in the vocabulary)."""
    if kind == "audio":
        rng = np.random.RandomState(seed)
        return rng.randn(batch, frames, d_model).astype(np.float32) * 0.02
    return None
