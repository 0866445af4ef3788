"""Wire formats for the transport layer: codecs + frame versioning.

The paper's communication-efficiency claim is about the ``(delta_w,
Sigma)`` messages the workers exchange; this module makes their wire cost
an explicit, measurable object instead of "whatever pickle does to a
float32 array".  Two independent pieces:

Codecs (``get_codec``)
----------------------
A ``Codec`` turns a float array into an ``Encoded`` payload and back:

  ``none``   float32 passthrough — the historical wire format.
  ``bf16``   bfloat16 truncation (round-to-nearest-even on the mantissa
             boundary), 2 bytes/element.  Deterministic, no state.
  ``int8``   symmetric per-block quantization: the flat array is split
             into ``block``-element blocks, each shipped as int8 codes
             plus one float32 scale (absmax / 127).  ~4x on the data plus
             a 1/block scale overhead.

Quantization is lossy, so repeated lossy *updates* (the ``delta_w``
commits, the gossip mixing exchanges) go through ``ErrorFeedback``: the
residual of every encode is added back into the next value before
encoding, which turns a biased per-step error into a bounded accumulated
one (the standard EF-SGD / CHOCO-style correction — see
arXiv:1609.09563's perturbed-fixed-point view for why the fixed point
tolerates exactly this kind of bounded perturbation).  State reads
(snapshot ``W_rows`` / Sigma rows) are re-encoded fresh each time and
need no feedback.

Frame versioning (``WIRE_VERSION``)
-----------------------------------
The multiprocess transport's length-prefixed pickle frames carry a
leading version byte.  A codec/protocol mismatch between two ends (old
worker binary against a new server, a frame from a foreign protocol)
surfaces as a clear ``TransportProtocolError`` instead of a pickle
garbage crash: legacy frames started with the high byte of a 64-bit
length — 0x00 for any sane message — which can never equal a valid
version (versions start at 1).

Everything here is numpy-only (no jax) so worker subprocesses can encode
and decode without touching the device runtime.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

# bump when the frame layout or the Encoded schema changes incompatibly
WIRE_VERSION = 2
# what the first byte of a legacy (pre-version-byte) frame looks like
_LEGACY_FIRST_BYTE = 0


class TransportProtocolError(RuntimeError):
    """A transport peer speaks a different wire protocol/codec version."""


def check_wire_version(got: int) -> None:
    """Validate the leading frame byte; raise with a diagnosis on skew."""
    if got == WIRE_VERSION:
        return
    if got == _LEGACY_FIRST_BYTE:
        raise TransportProtocolError(
            f"transport frame has no version byte (first byte 0x00): the "
            f"peer speaks the legacy unversioned framing; this end expects "
            f"wire version {WIRE_VERSION}. Upgrade both ends together."
        )
    raise TransportProtocolError(
        f"transport wire version mismatch: peer sent version {got}, this "
        f"end expects {WIRE_VERSION}. Upgrade both ends together."
    )


# ---------------------------------------------------------------------------
# encoded payloads
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Encoded:
    """One array as it travels on the wire.

    ``data`` holds the codec's element payload (float32 / uint16 / int8),
    ``scales`` the int8 per-block scales (None otherwise).  ``nbytes`` is
    the array payload the frame actually carries — the measurable quantity
    ``payload_nbytes`` and the transport wire counters report.
    """

    codec: str
    shape: Tuple[int, ...]
    dtype: str  # original dtype string, restored on decode
    data: np.ndarray
    scales: Optional[np.ndarray] = None

    @property
    def nbytes(self) -> int:
        n = int(self.data.nbytes)
        if self.scales is not None:
            n += int(self.scales.nbytes)
        return n


class Codec:
    """Base codec: encode/decode one array. Stateless; lossy codecs pair
    with ``ErrorFeedback`` for repeated delta encodes."""

    name: str = "?"
    lossy: bool = False

    def encode(self, x) -> Encoded:
        raise NotImplementedError

    def decode(self, enc: Encoded) -> np.ndarray:
        raise NotImplementedError


class NoneCodec(Codec):
    name = "none"
    lossy = False

    def encode(self, x) -> Encoded:
        x = np.asarray(x)
        return Encoded(
            codec=self.name,
            shape=tuple(x.shape),
            dtype=str(x.dtype),
            data=np.ascontiguousarray(x),
        )

    def decode(self, enc: Encoded) -> np.ndarray:
        return enc.data.reshape(enc.shape).astype(enc.dtype, copy=False)


def _f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even truncation of float32 to bfloat16 bit
    patterns (uint16). Matches hardware bf16 casts; NaN payloads are
    normalized by the rounding add, which is fine for weight traffic."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    bias = ((u >> 16) & np.uint32(1)) + np.uint32(0x7FFF)
    return ((u + bias) >> 16).astype(np.uint16)


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


class BF16Codec(Codec):
    name = "bf16"
    lossy = True

    def encode(self, x) -> Encoded:
        x = np.asarray(x)
        return Encoded(
            codec=self.name,
            shape=tuple(x.shape),
            dtype=str(x.dtype),
            data=_f32_to_bf16_bits(x),
        )

    def decode(self, enc: Encoded) -> np.ndarray:
        out = _bf16_bits_to_f32(enc.data).reshape(enc.shape)
        return out.astype(enc.dtype, copy=False)


class Int8Codec(Codec):
    """Symmetric per-block int8: codes in [-127, 127] plus one float32
    scale per ``block`` flat elements (absmax/127; all-zero blocks get
    scale 0 and decode exactly to zeros)."""

    name = "int8"
    lossy = True

    def __init__(self, block: int = 256):
        if block < 1:
            raise ValueError(f"int8 block must be >= 1, got {block}")
        self.block = int(block)

    def encode(self, x) -> Encoded:
        x = np.asarray(x)
        flat = np.ascontiguousarray(x, dtype=np.float32).ravel()
        n = flat.size
        pad = (-n) % self.block
        if pad:
            flat = np.concatenate([flat, np.zeros((pad,), np.float32)])
        blocks = flat.reshape(-1, self.block)
        absmax = np.max(np.abs(blocks), axis=1)
        scales = (absmax / 127.0).astype(np.float32)
        safe = np.where(scales > 0.0, scales, 1.0)
        q = np.clip(np.rint(blocks / safe[:, None]), -127, 127).astype(np.int8)
        # ship exactly n codes: the pad exists only for the blocked
        # quantization math, not on the wire (a tiny array must not cost
        # a whole block)
        return Encoded(
            codec=self.name,
            shape=tuple(x.shape),
            dtype=str(x.dtype),
            data=np.ascontiguousarray(q.ravel()[:n]),
            scales=scales,
        )

    def decode(self, enc: Encoded) -> np.ndarray:
        n = enc.data.size
        pad = (-n) % self.block
        codes = enc.data
        if pad:
            codes = np.concatenate([codes, np.zeros((pad,), np.int8)])
        blocks = codes.reshape(-1, self.block).astype(np.float32)
        out = (blocks * enc.scales[:, None]).ravel()[:n].reshape(enc.shape)
        return out.astype(enc.dtype, copy=False)


_CODECS: Dict[str, Codec] = {}


def register_codec(codec: Codec) -> Codec:
    _CODECS[codec.name] = codec
    return codec


def get_codec(name: str) -> Codec:
    try:
        return _CODECS[name]
    except KeyError as e:
        raise KeyError(
            f"unknown wire codec {name!r}; have {sorted(_CODECS)}"
        ) from e


def available_codecs() -> Dict[str, Codec]:
    return dict(sorted(_CODECS.items()))


register_codec(NoneCodec())
register_codec(BF16Codec())
register_codec(Int8Codec())


def roundtrip(codec: Codec, x) -> np.ndarray:
    """What the receiving end sees: decode(encode(x))."""
    return codec.decode(codec.encode(x))


# ---------------------------------------------------------------------------
# error feedback for repeated lossy delta encodes
# ---------------------------------------------------------------------------
class ErrorFeedback:
    """Residual accumulation around a lossy codec, keyed per stream.

    ``encode(key, x)`` encodes ``x + residual[key]`` and stores the new
    residual ``(x + r) - decode(enc)``; the receiver applies plain
    ``decode``.  Over a run, the *sum* of decoded deltas tracks the sum of
    true deltas to within one quantization step, so quantized commits and
    gossip mixing perturb the fixed point boundedly instead of drifting.
    For the exact ``none`` codec this degenerates to a passthrough with no
    stored state.
    """

    def __init__(self, codec: Codec):
        self.codec = codec
        self._resid: Dict[object, np.ndarray] = {}

    def encode(self, key, x) -> Encoded:
        x = np.asarray(x, dtype=np.float32)
        if not self.codec.lossy:
            return self.codec.encode(x)
        r = self._resid.get(key)
        if r is not None:
            x = x + r
        enc = self.codec.encode(x)
        self._resid[key] = x - self.codec.decode(enc).astype(np.float32)
        return enc

    def reset(self, key=None) -> None:
        """Drop residual state — after a Sigma install resets the consensus
        (the accumulated error no longer refers to live state)."""
        if key is None:
            self._resid.clear()
        else:
            self._resid.pop(key, None)
