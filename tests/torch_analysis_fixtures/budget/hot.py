"""Budget fixture (healthy): a paged-server-like loop whose `_tick` and
`_tick_window` feed every counter budgets.toml accounts through, the
window's tokens-a-dispatch gauge one call away (`_drain_window`), as
the port's server feeds it."""


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
    def _note_dispatch(self, n):
        self.obs.host_dispatches.inc()

    def _drain_window(self, toks):
        self.obs.tokens_per_dispatch.set(float(len(toks)))

    def _tick_window(self):
        self._note_dispatch(4)
        self._drain_window([1, 2, 3, 4])

    def _tick(self):
        if self.decode_window > 1:
            return self._tick_window()
        self.obs.kv_rows_read.inc(self.rows)
        self._note_dispatch(1)
