"""``portbench/spans.py``: the program's spans reduced by name, on CPU
profiles of nested spans across two threads and on scripted events."""
from __future__ import annotations

import threading
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from portbench import spans, trace
from onepose_tpu_torch.utils.profiling import span


def _work():
    x = torch.ones(64, 64)
    for _ in range(3):
        x = x @ x / 64.0
    return x


def _profile():
    """Main thread: ``a`` around ``a.b`` and ``a.c``, and around a second
    thread that runs ``a`` around ``a.b`` and, alone, ``b``; → the
    events."""
    from torch._C._profiler import _ExperimentalConfig

    def other():
        with span("a"), span("a.b"):
            _work()
        with span("b"):
            _work()

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        with span("a"):
            t = threading.Thread(target=other)
            t.start()
            t.join()
            with span("a.b"):
                _work()
            with span("a.c"):
                _work()
    return prof.events()


@pytest.fixture(scope="module")
def events():
    return _profile()


def _raw(events):
    return [(e.name[len(spans.PREFIX):], e.thread, e.time_range.start,
             e.time_range.end) for e in events
            if e.name.startswith(spans.PREFIX)
            and e.device_type == DeviceType.CPU]


def test_calls_and_host_time(events):
    tab, raw = spans.table(events), _raw(events)
    assert {k: v["calls"] for k, v in tab.items()} == {
        "a": 2, "a.b": 2, "a.c": 1, "b": 1}
    for name, row in tab.items():
        assert row["host_us"] == pytest.approx(
            sum(t - s for n, _, s, t in raw if n == name))
        assert len(row["intervals"]) == row["calls"]
        assert row["launches"] == row["waits"] == 0


def test_self_time_is_the_parent_less_its_children_on_its_thread(events):
    tab, raw = spans.table(events), _raw(events)
    main = next(th for n, th, _, _ in raw if n == "a.c")
    by = {(n, th): t - s for n, th, s, t in raw}
    other = next(th for n, th, _, _ in raw if n == "b")
    assert other != main
    want = (by[("a", main)] - by[("a.b", main)] - by[("a.c", main)]
            + by[("a", other)] - by[("a.b", other)])
    assert tab["a"]["self_us"] == pytest.approx(want)
    # the other thread's ``b`` runs inside main's ``a`` in time, not on
    # its thread: it is no child of it
    assert tab["b"]["self_us"] == pytest.approx(tab["b"]["host_us"])
    for leaf in ("a.b", "a.c", "b"):
        assert tab[leaf]["self_us"] == pytest.approx(tab[leaf]["host_us"])


def test_nesting_per_thread(events):
    assert {k: v["parents"] for k, v in spans.table(events).items()} == {
        "a": {None}, "a.b": {"a"}, "a.c": {"a"}, "b": {None}}


def _event(name, thread, start, end, device_us=0.0,
           device=DeviceType.CPU):
    return SimpleNamespace(name=name, thread=thread, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end),
                           device_time_total=device_us)


def test_launches_waits_and_device_time_by_thread():
    ev = [_event("onepose.pnp", 1, 0, 100, device_us=40.0),
          _event("onepose.pnp.solve", 1, 0, 50, device_us=10.0),
          _event("cudaLaunchKernel", 1, 5, 6),
          _event("cudaLaunchKernelExC", 1, 60, 61),
          _event("cudaGraphLaunch", 1, 70, 71),
          _event("cudaStreamSynchronize", 1, 10, 20),
          _event("cudaMemcpyAsync", 1, 30, 31),
          _event("cudaMemcpy", 1, 80, 90),
          _event("cudaEventSynchronize", 1, 95, 96),
          # another thread's calls at the same time count for nothing
          _event("cudaLaunchKernel", 2, 7, 8),
          _event("cudaDeviceSynchronize", 2, 40, 45),
          # a span's device-side copy is not a span
          _event("onepose.pnp", 1, 3, 99, device=DeviceType.CUDA)]
    tab = spans.table(ev)
    assert tab["pnp"]["launches"] == 3 and tab["pnp"]["waits"] == 3
    assert tab["pnp.solve"]["launches"] == 1
    assert tab["pnp.solve"]["waits"] == 1
    assert tab["pnp"]["calls"] == 1 and tab["pnp"]["device_us"] == 40.0
    assert tab["pnp"]["self_us"] == 50.0
    assert spans.QUANTITIES["pnp_host_waits"](None, tab) == 3
    assert spans.QUANTITIES["pnp_busy_ms"](None, tab) == 0.04


def test_idle_unnamed_by_the_spans_open_at_each_gap():
    tr = trace.Trace(kernels=[("k", 10, 20), ("k", 50, 60),
                              ("onepose.x", 20, 50)],
                     spans={}, launches=[], window=(0, 100), busy_us=20.0)
    tab = {"x": {"calls": 1, "intervals": [(7, 15, 40)]}}
    # gaps 0-10, 20-50 (its middle inside the span), 60-100
    assert spans.idle_holes(tr) == [(0, 10), (20, 50), (60, 100)]
    assert spans.idle_unnamed(tr, tab) == pytest.approx(100.0 * 50 / 80)


@pytest.mark.parametrize("name", sorted(spans.QUANTITIES))
def test_none_without_the_span(events, name):
    """A program without the spans (or a profile without a span of the
    quantity's) reads None, not 0."""
    tr = trace.Trace(kernels=[("k", 10, 20)], spans={}, launches=[],
                     window=(0, 100), busy_us=10.0)
    read = spans.QUANTITIES[name]
    assert read(tr, {}) is None
    assert read(None, None) is None
    if name != "idle_unnamed":
        assert read(tr, spans.table(events)) is None
