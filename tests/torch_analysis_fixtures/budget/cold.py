"""Budget fixture (regressed): the metrics are registered, but neither
`_tick` nor `_tick_window` feeds any of them any more. Every contract
must fail statically, bench data or not."""


class ServingMetrics:
    def __init__(self, reg):
        self.host_dispatches = reg.counter(
            "defer_host_dispatches_total", "host dispatches"
        )
        self.kv_rows_read = reg.counter(
            "defer_kv_rows_read_total", "kv rows read a tick"
        )
        self.tokens_per_dispatch = reg.gauge(
            "defer_tokens_per_dispatch", "tokens a dispatch"
        )


class PagedDecodeServer:
    def _tick_window(self):
        return self.step()

    def _tick(self):
        return self._tick_window()
