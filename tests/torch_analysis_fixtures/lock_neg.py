"""NEGATIVE fixture: lock-discipline.

The frame is built under the lock and sent outside it; the one send
that must hold it carries its reason; a library call through `torch`
under the lock links no corpus helper of the same name. Expected: 0
findings (1 suppressed).
"""

import threading

import torch


class Sender:
    def __init__(self, sock):
        self._sock = sock
        self._lock = threading.Lock()
        self._frames = []

    def send(self, buf):
        with self._lock:
            frame = bytes(buf)
            self._frames.append(frame)
            torch.cuda.synchronize()
        self._sock.sendall(frame)

    def close(self):
        with self._lock:
            # analysis: ignore[lock-discipline] the STOP frame must not
            # interleave with a concurrent frame
            self._sock.sendall(b"STOP")


def synchronize():
    import time

    time.sleep(1)
