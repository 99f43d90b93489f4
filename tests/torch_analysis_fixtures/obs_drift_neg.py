"""NEGATIVE fixture: obs-name-drift. Expected: 0 findings."""


def register(reg):
    reg.counter("defer_tokens_generated_total", "tokens")
    reg.gauge("defer_tokens_per_dispatch", "tokens a dispatch")
    reg.histogram("defer_ttft_seconds", "time to first token")
