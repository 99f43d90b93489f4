"""NEGATIVE fixture: capture-in-hot-path.

The sanctioned pattern: a window captured once a key, kept on the
server and replayed (both memo forms), and a compile bound once at
module level. Expected: 0 findings.
"""

import torch


def capture_graph(body, device, warm_up):
    g = torch.cuda.CUDAGraph()
    warm_up()
    with torch.cuda.graph(g):
        body()
    return g


step = torch.compile(lambda x: x * 2)


class Server:
    def __init__(self):
        self._graphs = {}

    def _tick(self, key):
        self._window_program(key)()
        self._flat_window(key)
        return step(1)

    def _window_program(self, key):
        if key not in self._graphs:
            self._graphs[key] = (self._capture(self.body), self.body)
        return self._graphs[key][0].replay

    def _capture(self, body):
        return capture_graph(body, "cuda", lambda: None)

    def _flat_window(self, key):
        graph = self._graphs.get(key)
        if graph is None:
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin()
            self.body()
            graph.capture_end()
            self._graphs[key] = graph
        graph.replay()

    def body(self):
        return 1
