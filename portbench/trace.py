"""A profiler trace of a few steady steps, reduced to what the readers
need: device intervals by kernel, host annotations (the harness's own
spans), runtime launch events, and the idle gaps with what the host was
doing in each.

The trace is kept in memory (``torch.profiler``'s event list) and never
written out. Times are microseconds on the profiler's clock.
"""
from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict
from dataclasses import dataclass, field

LAUNCH = re.compile(r"LaunchKernel|GraphLaunch")
SPAN_PREFIX = "portbench."


@dataclass
class Trace:
    kernels: list            # (name, start, end) of each device activity
    spans: dict              # annotation name → [(start, end, thread)]
    launches: list           # (start, thread) of each launch call
    window: tuple            # (start, end) of the profiled steps
    busy_us: float           # union of device activity inside the window
    gaps: list = field(default_factory=list)   # (host op, us)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def kernel_us(self, pattern: str) -> tuple:
        """(total us, count) of the kernels whose name matches."""
        rx = re.compile(pattern)
        hits = [e - s for n, s, e in self.kernels if rx.search(n)]
        return sum(hits), len(hits)

    def launches_in(self, span: str) -> tuple:
        """(launch calls inside the spans named ``span``, spans)."""
        spans = self.spans.get(SPAN_PREFIX + span, [])
        n = sum(1 for t, th in self.launches for s, e, sth in spans
                if th == sth and s <= t <= e)
        return n, len(spans)

    def top_kernels(self, k=10) -> list:
        tot = defaultdict(float)
        for n, s, e in self.kernels:
            tot[_short(n)] += (e - s) / 1e6
        return sorted(tot.items(), key=lambda x: -x[1])[:k]

    def top_gaps(self, k=10) -> list:
        tot = defaultdict(float)
        for name, us in self.gaps:
            tot[name] += us / 1e6
        return sorted(tot.items(), key=lambda x: -x[1])[:k]


def _short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_:.-]", "_", name)[:64]


def span(name: str):
    """A host annotation that the readers find as ``name``."""
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)


@contextlib.contextmanager
def profiled():
    """Profile the block (CPU and CUDA); yields a list that holds the
    :class:`Trace` once the block has ended. The block is one span,
    ``portbench.window``, which ends after a device synchronise."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    holder = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with span("window"):
            yield holder
            torch.cuda.synchronize()
    holder.append(reduce(prof.events()))


def reduce(events) -> Trace:
    from torch.autograd import DeviceType

    kernels, spans, launches, host = [], defaultdict(list), [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.name.startswith(SPAN_PREFIX):
            if e.device_type != DeviceType.CUDA:   # not their device copy
                spans[e.name].append((s, t, e.thread))
                host.append((s, t, e.name))
        elif e.device_type == DeviceType.CUDA:
            kernels.append((e.name, s, t))
        elif LAUNCH.search(e.name):
            launches.append((s, e.thread))
            host.append((s, t, e.name))
        else:
            host.append((s, t, e.name))
    w0, w1 = spans[SPAN_PREFIX + "window"][0][:2]
    kernels = [k for k in kernels if k[2] > w0 and k[1] < w1]
    merged = []
    for _, s, t in sorted(kernels, key=lambda k: k[1]):
        s, t = max(s, w0), min(t, w1)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    holes = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
             if edges[i + 1] > edges[i]]
    return Trace(kernels, dict(spans), launches, (w0, w1), busy,
                 _attribute(holes, host))


def _attribute(holes, host):
    """Each idle gap named by the innermost host op or harness span
    running at its middle (the latest-starting one that covers it)."""
    host = sorted(host)
    starts = [h[0] for h in host]
    out = []
    for s, t in holes:
        mid = 0.5 * (s + t)
        i = bisect.bisect_right(starts, mid)
        name = "no_host_op_recorded"
        for j in range(i - 1, max(i - 2000, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        out.append((_short(name), t - s))
    return out
