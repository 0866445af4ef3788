"""The port's wire layer (repro_torch/core/wire.py, a numpy copy of the JAX
package's) against repro.core.wire: every codec's payload encoded by one
package decodes under the other to the same array (exact: both run the
same numpy arithmetic), error feedback keeps the same residuals, and the
"!BQ" frames written by one transport read under the other; legacy and
future frame versions raise TransportProtocolError on the port's side."""
import pickle
import socket
import struct

import numpy as np
import pytest

from repro.core import transport as jtransport
from repro.core import wire as jwire
from repro_torch.core import transport as ttransport
from repro_torch.core import wire as twire

SHAPES = [(3,), (256,), (257,), (300, 7), (1,), (8, 32)]
CODECS = ["none", "bf16", "int8"]


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_same_registry_and_version():
    assert set(twire.available_codecs()) == set(jwire.available_codecs())
    assert twire.WIRE_VERSION == jwire.WIRE_VERSION == 2
    with pytest.raises(KeyError, match="unknown wire codec"):
        twire.get_codec("zstd")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("codec", CODECS)
def test_payloads_cross_decode(codec, shape):
    """Port-encoded decodes under JAX and the reverse, bit for bit; the
    payloads themselves are equal, and so is their wire size."""
    x = _x(shape, seed=len(shape))
    tenc, jenc = twire.get_codec(codec).encode(x), jwire.get_codec(codec).encode(x)
    assert tenc.nbytes == jenc.nbytes
    assert np.array_equal(tenc.data, jenc.data)
    assert (tenc.scales is None) == (jenc.scales is None)
    if tenc.scales is not None:
        assert np.array_equal(tenc.scales, jenc.scales)
    a = jwire.get_codec(codec).decode(tenc)
    b = twire.get_codec(codec).decode(jenc)
    assert a.shape == b.shape == x.shape
    assert np.array_equal(a, b)
    assert np.array_equal(a, twire.roundtrip(twire.get_codec(codec), x))


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_error_feedback_streams_match(codec):
    """Twenty encodes of one stream through each package's ErrorFeedback:
    the same payloads every step (so the same residual is carried)."""
    tef = twire.ErrorFeedback(twire.get_codec(codec))
    jef = jwire.ErrorFeedback(jwire.get_codec(codec))
    total = np.zeros((40,), np.float32)
    sent = np.zeros((40,), np.float32)
    for k in range(20):
        x = _x((40,), seed=100 + k) * 0.1
        te, je = tef.encode("db", x), jef.encode("db", x)
        assert np.array_equal(te.data, je.data)
        total += x
        sent += twire.get_codec(codec).decode(te)
    # the decoded sum tracks the true sum to within one quantization step
    step = np.abs(total).max() / (127.0 if codec == "int8" else 128.0) + 1e-2
    assert np.abs(sent - total).max() <= step


def test_frames_cross_read():
    """A frame written by the port's transport reads under the JAX one's
    and the reverse (pickled numpy payloads and codec payloads both)."""
    enc = twire.get_codec("int8").encode(_x((33,)))
    msgs = [("commit", 3, np.arange(6, dtype=np.float32), enc), ("hello", 0)]
    for send, recv in ((ttransport._send_msg, jtransport._recv_msg),
                       (jtransport._send_msg, ttransport._recv_msg)):
        a, b = socket.socketpair()
        try:
            for msg in msgs:
                send(a, msg)
                got = recv(b)
                assert got[0] == msg[0] and got[1] == msg[1]
                if msg[0] == "commit":
                    assert np.array_equal(got[2], msg[2])
                    assert np.array_equal(
                        jwire.get_codec("int8").decode(got[3]),
                        twire.get_codec("int8").decode(enc),
                    )
        finally:
            a.close()
            b.close()


@pytest.mark.parametrize(
    "header, match",
    [
        (lambda n: struct.pack("!Q", n), "legacy"),  # the old unversioned frame
        (lambda n: struct.pack("!BQ", twire.WIRE_VERSION + 3, n), "mismatch"),
    ],
    ids=["legacy", "future"],
)
def test_skewed_frames_raise_transport_protocol_error(header, match):
    a, b = socket.socketpair()
    try:
        payload = pickle.dumps(("hello", 0))
        a.sendall(header(len(payload)) + payload)
        with pytest.raises(twire.TransportProtocolError, match=match):
            ttransport._recv_msg(b)
    finally:
        a.close()
        b.close()


def test_check_wire_version():
    twire.check_wire_version(twire.WIRE_VERSION)
    for bad in (0, twire.WIRE_VERSION + 1):
        with pytest.raises(twire.TransportProtocolError):
            twire.check_wire_version(bad)
