"""POSITIVE fixture: lock-discipline (the reference's rule, unchanged).

A frame send under the lock, and a helper whose body sleeps called
under it. Expected: 2 findings.
"""

import threading
import time


class Sender:
    def __init__(self, sock):
        self._sock = sock
        self._lock = threading.Lock()

    def send(self, buf):
        with self._lock:
            self._sock.sendall(buf)  # 1

    def flush(self):
        with self._lock:
            self._backoff()  # 2: blocks one call deep

    def _backoff(self):
        time.sleep(0.01)
