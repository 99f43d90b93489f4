"""runtime/transport.py through both packages over loopback: the framing
is shared, so a sender of either package talks to a receiver of the
other.

Arrays are numpy draws from a fixed seed and must arrive exactly
(lossless links) or within the int8 bound amax/127 (quantized links).
Every receiver's accept timeout is at most 10 s and every thread is
joined with a timeout.
"""

import threading

import numpy as np
import pytest
import torch

from defer_tpu.runtime import transport as jtransport
from defer_tpu_torch.runtime.transport import (
    ArrayReceiver,
    ArraySender,
    TransportError,
)

PACKAGES = {
    "torch": (ArraySender, ArrayReceiver),
    "jax": (jtransport.ArraySender, jtransport.ArrayReceiver),
}


def _arrays():
    rng = np.random.default_rng(0)
    return [
        rng.standard_normal((4, 8)).astype(np.float32),
        rng.integers(-5, 5, (3, 2, 2)).astype(np.int32),
        rng.standard_normal((16,)).astype(np.float16),
        rng.random((2, 3)) > 0.5,
        np.zeros((0, 3), np.uint8),
    ]


def _stream(sender_cls, receiver_cls, arrays, **sender_kwargs):
    """Send `arrays` through a loopback pair; returns (what arrived, the
    wire bytes send() reported, the receiver)."""
    recv = receiver_cls(0, host="127.0.0.1", accept_timeout_s=10.0)
    got = []
    t = threading.Thread(target=lambda: got.extend(recv), daemon=True)
    t.start()
    send = sender_cls("127.0.0.1", recv.port, **sender_kwargs)
    sent = sum(send.send(a) for a in arrays)
    send.close()
    t.join(timeout=10)
    recv.close()
    assert not t.is_alive() and len(got) == len(arrays)
    return got, sent, recv


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize(
    "sender,receiver", [("jax", "torch"), ("torch", "jax"), ("torch", "torch")]
)
def test_arrays_cross_the_packages(sender, receiver, compress):
    arrays = _arrays()
    got, sent, recv = _stream(
        PACKAGES[sender][0], PACKAGES[receiver][1], arrays, compress=compress
    )
    for a, b in zip(arrays, got):
        b = b.numpy() if isinstance(b, torch.Tensor) else b
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)
    assert sent == recv.rx_frame_bytes > 0
    if receiver == "torch":
        assert all(isinstance(b, torch.Tensor) for b in got)
        # The empty array takes zlib in both packages (the native codec
        # is given no empty payload).
        want = {(1,): 4, (2,): 1} if compress else {(0,): 5}
        assert recv.schemes == want


@pytest.mark.parametrize("sender", ["jax", "torch"])
def test_quantized_link_crosses_the_packages(sender):
    arrays = _arrays()
    got, _, recv = _stream(
        PACKAGES[sender][0], ArrayReceiver, arrays, quantize="int8"
    )
    # Floating payloads go int8; the others pass through losslessly
    # (the empty one through zlib).
    assert recv.schemes == {(3, 1): 2, (1,): 2, (2,): 1}
    for a, b in zip(arrays, got):
        b = b.numpy()
        if np.issubdtype(a.dtype, np.floating):
            bound = np.abs(a).max() / 127 * 0.5 + np.abs(a).max() * 2**-10
            assert np.abs(b.astype(np.float64) - a).max() <= bound
        else:
            np.testing.assert_array_equal(b, a)


def test_tensors_and_bfloat16_cross_to_the_reference():
    import ml_dtypes

    x = torch.from_numpy(
        np.random.default_rng(1).standard_normal((5, 6)).astype(np.float32)
    )
    xs = [x, x.to(torch.bfloat16), torch.arange(6, dtype=torch.int64)]
    got, _, _ = _stream(ArraySender, jtransport.ArrayReceiver, xs)
    np.testing.assert_array_equal(got[0], x.numpy())
    assert got[1].dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(
        got[1].astype(np.float32), x.to(torch.bfloat16).float().numpy()
    )
    np.testing.assert_array_equal(got[2], np.arange(6))


def test_receiver_accept_timeout():
    recv = ArrayReceiver(0, host="127.0.0.1", accept_timeout_s=0.2)
    with pytest.raises(TransportError, match="accept timeout"):
        next(iter(recv))
    recv.close()


def test_sender_connect_failure_and_mode_checks():
    # Bind then close: a port with nobody listening.
    probe = ArrayReceiver(0, host="127.0.0.1", accept_timeout_s=1.0)
    port = probe.port
    probe.close()
    with pytest.raises(TransportError, match="could not connect"):
        ArraySender("127.0.0.1", port, retries=2, backoff_base_s=0.01,
                    backoff_cap_s=0.02)
    with pytest.raises(ValueError, match="backoff"):
        ArraySender("127.0.0.1", 1, backoff_base_s=-0.1)
    with pytest.raises(ValueError, match="quantize"):
        ArraySender("127.0.0.1", 1, quantize="int4")


def test_receiver_read_timeout_surfaces_stalled_peer():
    recv = ArrayReceiver(
        0, host="127.0.0.1", accept_timeout_s=5.0, read_timeout_s=0.2
    )
    send = ArraySender("127.0.0.1", recv.port)
    with pytest.raises(TransportError, match="timed out"):
        next(iter(recv))
    send.close()
    recv.close()


def test_next_peer_accepts_a_second_stream():
    recv = ArrayReceiver(0, host="127.0.0.1", accept_timeout_s=10.0)
    got: list = []

    def consume():
        got.extend(recv)
        recv.next_peer()
        got.extend(recv)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    for i in range(2):
        s = ArraySender("127.0.0.1", recv.port)
        s.send(np.full((2,), i, np.int32))
        s.close()
    t.join(timeout=10)
    recv.close()
    assert [int(g[0]) for g in got] == [0, 1]
