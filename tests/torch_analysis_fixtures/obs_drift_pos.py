"""POSITIVE fixture: obs-name-drift (the reference's rule, unchanged).
Expected: 3 findings."""


def register(reg):
    reg.counter("serving_tokens_total", "no defer_ prefix")  # 1
    reg.counter("defer_tokens", "a counter without _total")  # 2
    reg.gauge("defer_window_total", "a gauge ending in _total")  # 3
