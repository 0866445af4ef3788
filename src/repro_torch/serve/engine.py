"""LM serving engine: per-slot continuous batching over one decode batch.

The engine owns a slot table over a batch-wide decode cache: each of the
``batch`` rows (slots) is free or holds exactly one in-flight request. New
requests are PREFILLED INDIVIDUALLY (B=1) and inserted into a free slot at
a decode-step boundary; the whole batch then advances ONE token per
``decode_tick``, and a request that hits EOS or its token budget frees its
slot for the next waiting request, so a long generation never gates the
other ``batch - 1`` rows.

Sampled tokens stay on the device in a detokenize backlog (one entry per
decode step) and are only copied to the host when the backlog drains
(every ``drain_every`` steps, when slots are needed, or at idle).

The port of the JAX package's ``serve/engine.py``, with three differences:
  * PyTorch runs eagerly, so the JAX engine's AOT-compiled executables
    (per prefill bucket, the decode step, the slot insert) are plain calls,
    and ``warmup()`` only allocates the batch state;
  * the batch cache is updated IN PLACE: a slot insert copies the B=1
    prefill cache into its row, and ``decode_step`` writes each new k/v,
    SSM state and conv window into the cache it is given, where the JAX
    engine builds updated copies with ``.at[].set``;
  * sampling is greedy only (``temperature > 0`` is not ported yet), and
    over the real vocabulary: the JAX engine's argmax also ranks the
    padded vocabulary's columns, so it can emit an id past ``vocab_size``.

Decoder-only attention architectures (dense: qwen1.5, nemotron-4,
gemma3 with its local ring buffers, the VLM chameleon; MoE: qwen3-moe,
kimi-k2) prefill in power-of-two buckets, right-padded, with the pad
carried as ``prefill(..., true_len=)``. SSM / hybrid architectures cannot
mask pad steps out of a state scan, and the encoder-decoder (whisper)
prefills its decoder the same way, so they prefill at EXACT prompt length.
An encoder-decoder request carries its audio frames (``Request.side``,
(F, d)); prefill encodes them and keeps each layer's cross-attention k/v
in the slot's ``DecodeCache.cross``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.dmtrl import resolve_device
from ..models import decode_step, init_decode_cache, prefill
from ..models.transformer import DecodeCache
from .scheduler import ModelSnapshot, ServeRequest

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch: int = 8        # decode slots
    max_len: int = 2048   # KV slots per sequence: prompt + generated tokens
    temperature: float = 0.0  # 0 => greedy (the only mode ported)
    eos_id: int = 1
    bucket_min: int = 16  # smallest prefill bucket (buckets are powers of 2)
    drain_every: int = 4  # decode steps between detokenize-backlog drains


def _sample(logits: Tensor, vocab_size: int) -> Tensor:
    """Greedy: the argmax token of each row, int32, over the real
    vocabulary only. The logits cover the padded vocabulary (a multiple of
    256); the JAX engine's argmax also ranks the pad columns, which with
    random weights can win and emit an id outside the vocabulary."""
    return torch.argmax(logits[..., :vocab_size], dim=-1).to(torch.int32)


@dataclasses.dataclass
class Request(ServeRequest):
    prompt: np.ndarray = None  # (S,) int32
    max_new_tokens: int = 32
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: Optional[str] = None  # "eos" | "length"
    side: Optional[np.ndarray] = None  # (F, d) audio frames for enc-dec cfgs


def _next_bucket(n: int, lo: int, hi: int) -> int:
    """Smallest power-of-two >= max(n, lo), capped at hi (hi >= n always
    holds because admission bounds prompt lengths)."""
    b = max(lo, 1)
    while b < n:
        b *= 2
    return min(b, hi)


def _tree_map(fn, *trees):
    """``fn`` over the matching tensor leaves of nested dicts and lists."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _map_cache(fn, *caches):
    """``fn(batch_axis, *leaves)`` over the matching leaves of DecodeCaches,
    or of the plain tensors scripted tests use in their place (axis 0). The
    batch axis is not uniform: uniform archs stack the layer caches as
    (n_layers, B, ...) dicts (batch at axis 1), the others keep per-layer
    lists of (B, ...) leaves, and the position is a scalar (B=1 prefill)
    or a (B,) vector (the batch). The hybrid's shared caches and the
    encoder-decoder's cross k/v keep the batch at axis 0."""
    c0 = caches[0]
    if not isinstance(c0, DecodeCache):
        return _tree_map(lambda *ls: fn(0, *ls), *caches)
    ax = 1 if isinstance(c0.layers, dict) else 0
    return DecodeCache(
        _tree_map(lambda *ls: fn(ax, *ls), *(c.layers for c in caches)),
        fn(0, *(c.position for c in caches)),
        _tree_map(lambda *ls: fn(0, *ls), *(c.shared for c in caches)),
        _tree_map(lambda *ls: fn(0, *ls), *(c.cross for c in caches)),
    )


class ServingEngine:
    """Slot-table LM engine: B=1 prefill into free slots, one shared decode
    batch stepping all occupied slots together.

    Two surfaces over the same slot machinery:

      * streaming: ``inject`` new requests at a decode-step boundary,
        ``decode_tick`` one step, finished requests surface from the drain
        backlog;
      * blocking ``run(requests)``: inject all, tick until every request
        finishes.

    The device state lives on ``device`` (the card unless the caller asks
    for the CPU); ``params`` must already be there.
    """

    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig, device="cuda"):
        if scfg.batch < 1:
            raise ValueError(f"batch must be >= 1, got {scfg.batch}")
        if scfg.drain_every < 1:
            raise ValueError(f"drain_every must be >= 1, got {scfg.drain_every}")
        if scfg.temperature > 0.0:
            raise NotImplementedError("sampling with temperature > 0 is not ported yet")
        self.cfg, self.params, self.scfg = cfg, params, scfg
        self.device = resolve_device(device)
        # one stable snapshot object: LM params never change
        self._snapshot = ModelSnapshot(version=0)
        # pad-masked bucketed prefill needs attention-only archs; state
        # scans (ssm/hybrid) and the enc-dec decoder prefill exactly
        self._maskable = not (
            cfg.arch_type in ("ssm", "hybrid") or cfg.is_encoder_decoder
        )
        # slot table
        B = scfg.batch
        self._slots: List[Optional[Request]] = [None] * B
        self._free: List[int] = list(range(B - 1, -1, -1))  # pop() -> slot 0 first
        self._emitted = [0] * B   # tokens sampled for the CURRENT attempt
        self._budget = [0] * B
        # device state (allocated on first inject or warmup)
        self._cache: Optional[DecodeCache] = None
        self._token: Optional[Tensor] = None  # (B,) next input token per row
        # detokenize/finalize backlog: [(device tokens, [(row, request)])]
        self._backlog: List[Tuple[Tensor, List[Tuple[int, Request]]]] = []
        self._finished: List[Request] = []

    # -- scheduler adapter surface -----------------------------------------
    @property
    def batch(self) -> int:
        return self.scfg.batch

    def model_snapshot(self) -> ModelSnapshot:
        return self._snapshot

    def admit(self, r: Request) -> None:
        prompt = np.asarray(r.prompt)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(
                f"prompt must be a non-empty 1-D token array, got shape {prompt.shape}"
            )
        if not np.issubdtype(prompt.dtype, np.integer):
            raise ValueError(f"prompt must hold integer token ids, got dtype {prompt.dtype}")
        r.prompt = prompt.astype(np.int32, copy=False)
        if r.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {r.max_new_tokens}")
        total = int(prompt.shape[0]) + int(r.max_new_tokens)
        if total > self.scfg.max_len:
            raise ValueError(
                f"prompt ({prompt.shape[0]}) + max_new_tokens ({r.max_new_tokens}) = "
                f"{total} exceeds max_len={self.scfg.max_len} KV slots"
            )
        if self.cfg.is_encoder_decoder and r.side is None:
            raise ValueError("encoder-decoder configs need per-request side frames (Request.side)")

    def run_tile(self, requests: Sequence[Request], snapshot: ModelSnapshot) -> None:
        """Whole-generation tile hook (non-streaming schedulers); LM params
        are fixed for the engine's lifetime, so the snapshot is ignored."""
        self.run(list(requests))

    # -- streaming surface --------------------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active(self) -> int:
        """Occupied slots (requests injected and not yet drained-finished)."""
        return self.scfg.batch - len(self._free)

    def inject(
        self, requests: Sequence[Request], snapshot: Optional[ModelSnapshot] = None
    ) -> None:
        """Admit <= free_slots requests into the running batch at a
        decode-step boundary: per-request prefill, slot assign, first token
        sampled from the prefill logits. Per-attempt decode state
        (``output``/``done``/``finish_reason``) is RESET on entry, so a
        request re-queued after a failed tile never double-appends."""
        if len(requests) > len(self._free):
            raise RuntimeError(
                f"{len(requests)} requests for {len(self._free)} free slots; "
                "drain() first or inject fewer"
            )
        for r in requests:
            r.output = []
            r.done = False
            r.finish_reason = None
            if snapshot is not None:
                r.snapshot_version = snapshot.version
            last_logits, one = self._prefill_one(r)
            if self._cache is None:
                self._alloc_batch_state(one)
            tok0 = _sample(last_logits, self.cfg.vocab_size)  # (1,)
            i = self._free.pop()  # slot assigned only after prefill succeeded
            self._slots[i] = r
            self._emitted[i] = 1
            self._budget[i] = int(r.max_new_tokens)
            self._insert(one, i, tok0)
            self._backlog.append((tok0, [(0, r)]))

    def decode_tick(self) -> List[Request]:
        """Advance every occupied slot one token; returns requests that
        FINISHED (possibly injected many ticks ago). Tokens pile into the
        backlog and drain every ``drain_every`` steps (or when no slot can
        take another token)."""
        active = [
            i for i, r in enumerate(self._slots)
            if r is not None and self._emitted[i] < self._budget[i]
        ]
        if not active:
            self._drain_backlog()
            return self._pop_finished()
        logits, cache = self._step_call(self._token, self._cache)
        self._cache = cache
        nxt = _sample(logits, self.cfg.vocab_size)  # (B,)
        self._token = nxt
        self._backlog.append((nxt, [(i, self._slots[i]) for i in active]))
        for i in active:
            self._emitted[i] += 1
        at_budget = all(
            self._emitted[i] >= self._budget[i]
            for i, r in enumerate(self._slots)
            if r is not None
        )
        if len(self._backlog) >= self.scfg.drain_every or at_budget:
            self._drain_backlog()
        return self._pop_finished()

    def drain(self) -> List[Request]:
        """Force a backlog drain; returns newly finished requests."""
        self._drain_backlog()
        return self._pop_finished()

    def evict_active(self) -> List[Request]:
        """Pull every in-flight (not yet finished) request out of the slot
        table — the failed-tile path: the caller re-queues them and the
        next ``inject`` resets their per-attempt state."""
        self._backlog.clear()
        evicted = [r for r in self._slots if r is not None]
        self._slots = [None] * self.scfg.batch
        self._free = list(range(self.scfg.batch - 1, -1, -1))
        self._emitted = [0] * self.scfg.batch
        self._budget = [0] * self.scfg.batch
        return evicted

    # -- blocking surface ---------------------------------------------------
    def run(self, requests: List[Request], side=None) -> List[Request]:
        """One-shot batch: inject every request, tick until all finish.
        ``side`` optionally carries stacked (B, F, d) enc-dec frames, given
        to the requests row by row."""
        if len(requests) > self.scfg.batch:
            raise ValueError(
                f"{len(requests)} requests exceed the engine batch "
                f"{self.scfg.batch}; run in tiles"
            )
        if side is not None:
            for i, r in enumerate(requests):
                r.side = np.asarray(side[i])
        for r in requests:
            self.admit(r)
        if len(requests) > len(self._free):
            raise RuntimeError(
                "blocking run() needs exclusive slots; engine has "
                f"{self.active} in-flight streaming requests"
            )
        self.inject(requests, self._snapshot)
        # bounded: every slot stops at its budget, drain then frees it
        while not all(r.done for r in requests):
            self.decode_tick()
        self._pop_finished()
        return requests

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> List[int]:
        """Allocate the batch state ahead of traffic and return the prefill
        lengths a JAX engine would compile (eager PyTorch compiles nothing).
        With no argument: the power-of-two ladder ``bucket_min ..
        max_len/2``. An encoder-decoder's batch state waits for its first
        prefill, as in the JAX engine: the cross k/v take the dtype the
        frames promote to."""
        scfg = self.scfg
        if buckets is None:
            buckets, b = [], scfg.bucket_min
            while b <= scfg.max_len // 2:
                buckets.append(b)
                b *= 2
        done = []
        for b in buckets:
            if b >= scfg.max_len:
                raise ValueError(f"bucket {b} leaves no decode room in max_len={scfg.max_len}")
            done.append(int(b))
        if self._cache is None and not self.cfg.is_encoder_decoder:
            self._alloc_batch_state(
                init_decode_cache(self.cfg, 1, scfg.max_len, device=self.device)
            )
        return done

    # -- internals: prefill -------------------------------------------------
    def _bucket_for(self, L: int) -> int:
        if not self._maskable:
            return L  # exact-length prefill (state scans can't mask pads)
        return _next_bucket(L, self.scfg.bucket_min, self.scfg.max_len - 1)

    def _prefill_one(self, r: Request) -> Tuple[Tensor, DecodeCache]:
        """B=1 prefill of one request -> (logits (1, Vp), cache). Tests stub
        THIS method to script token streams without a model."""
        L = int(r.prompt.shape[0])
        S = self._bucket_for(L)
        toks = np.zeros((1, S), np.int32)
        toks[0, :L] = r.prompt  # right-pad; the mask rides true_len
        side = None
        if self.cfg.is_encoder_decoder:
            side = torch.as_tensor(np.asarray(r.side, np.float32))[None].to(self.device)
        return prefill(
            self.cfg, self.params, torch.from_numpy(toks).to(self.device), side,
            extra_len=self.scfg.max_len - S,
            true_len=L if self._maskable else None,
        )

    # -- internals: batch state / insert / decode ---------------------------
    def _alloc_batch_state(self, one) -> None:
        """Allocate the batch-wide cache from the structure of one B=1
        prefill cache: every leaf's batch axis grows to ``batch``; the
        scalar position becomes a per-row (B,) vector."""
        B = self.scfg.batch

        def rep(ax, a):
            if a.ndim == 0:  # position scalar -> per-row vector
                return torch.zeros((B,), dtype=a.dtype, device=a.device)
            shape = list(a.shape)
            shape[ax] = B
            return a.new_zeros(shape)

        self._cache = _map_cache(rep, one)
        self._token = torch.zeros((B,), dtype=torch.int32, device=self.device)

    def _insert(self, one, i: int, tok0: Tensor) -> None:
        """Copy a B=1 prefill cache into slot ``i`` of the batch cache, in
        place, and set the slot's next input token."""

        def put(ax, full, o):
            if o.ndim == 0:
                full[i] = o
            else:
                full.narrow(ax, i, 1).copy_(o)

        _map_cache(put, self._cache, one)
        self._token[i] = tok0[0]

    def _step_call(self, token: Tensor, cache: DecodeCache):
        return decode_step(self.cfg, self.params, token, cache)

    # -- internals: detokenize/finalize backlog -----------------------------
    def _drain_backlog(self) -> None:
        """Copy backlogged device tokens to the host, append to request
        outputs in decode order, finalize EOS/budget stops, recycle their
        slots. The ONLY host-sync point of the decode loop."""
        if not self._backlog:
            return
        events = self._backlog
        self._backlog = []
        for dev, rows in events:
            arr = dev.cpu().numpy()
            for row, r in rows:
                if r.done:
                    continue  # post-EOS rows sampled before the drain
                tok = int(arr[row])
                r.output.append(tok)
                if tok == self.scfg.eos_id:
                    r.done = True
                    r.finish_reason = "eos"
                elif len(r.output) >= r.max_new_tokens:
                    r.done = True
                    r.finish_reason = "length"
        for j, r in enumerate(self._slots):
            if r is not None and r.done:
                self._slots[j] = None
                self._free.append(j)
                self._finished.append(r)

    def _pop_finished(self) -> List[Request]:
        out, self._finished = self._finished, []
        return out
