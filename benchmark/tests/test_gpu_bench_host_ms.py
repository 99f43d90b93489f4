"""The readers of the program's host-time counters (`host_ms.py`,
`metrics/host_ms.*.py`) on synthetic registry snapshots: ms a
microbatch over the window, and None where the window dispatched
nothing or the program has no such counter."""

import pytest

from benchmark import harness, host_ms, trace

CELL = "resnet50.chain4_b128"
READERS = ["host_ms.dispatch", "host_ms.place", "host_ms.stage_max",
           "host_ms.input_wait", "host_ms.card_wait"]


def _stage(stage, phase):
    return f'{host_ms.STAGE}{{phase="{phase}",stage="{stage}"}}'


def _wait(on):
    return f'{host_ms.WAIT}{{on="{on}"}}'


# Over the window: 200 microbatches; stage 0 places in 0.2 s and
# launches in 0.6 s, stage 1 0.4 + 0.2 s; input wait 0.1 s, card 0.9 s.
T0 = {host_ms.MICROBATCHES: 100, _stage(0, "place"): 1.0,
      _stage(0, "launch"): 2.0, _stage(1, "place"): 0.5,
      _wait("input"): 0.05, _wait("card"): 0.1}
T1 = {host_ms.MICROBATCHES: 300, _stage(0, "place"): 1.2,
      _stage(0, "launch"): 2.6, _stage(1, "place"): 0.9,
      _stage(1, "launch"): 0.2, _wait("input"): 0.15, _wait("card"): 1.0}
WANT = {"host_ms.dispatch": 7.0, "host_ms.place": 3.0,
        "host_ms.stage_max": 4.0, "host_ms.input_wait": 0.5,
        "host_ms.card_wait": 4.5}


def _ctx(t0, t1):
    return trace.Context(
        cell=harness.load_cell(CELL), outcome=None, traced=None,
        registry={"t0": {"counters": t0}, "t1": {"counters": t1}},
        device={"kind": "cpu"})


def _read(name, ctx):
    return harness.load_module("metrics", name).read(ctx)


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_ms_a_microbatch(name):
    assert _read(name, _ctx(T0, T1)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_without_a_microbatch(name):
    t1 = dict(T1, **{host_ms.MICROBATCHES: T0[host_ms.MICROBATCHES]})
    assert _read(name, _ctx(T0, t1)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_where_the_program_has_no_counter(name):
    """A program without the time counters (the parent of the change
    that added them) counts microbatches only."""
    only = {host_ms.MICROBATCHES: 10}
    assert _read(name, _ctx(only, {host_ms.MICROBATCHES: 20})) is None


def test_labels_parse_the_sample_name():
    assert host_ms.labels(_stage(3, "launch")) == {"phase": "launch",
                                                   "stage": "3"}


@pytest.mark.parametrize("name", READERS)
def test_readers_are_listed_for_their_cells(name):
    entry = next(m for m in harness.benchmark_spec()["per_layer"]
                 if m["name"] == name)
    assert (entry["unit"], entry["better"], entry["source"], entry["moves"]) == (
        "ms", "lower", "host_clock", "images_per_s")
    assert CELL in entry["workloads"]
