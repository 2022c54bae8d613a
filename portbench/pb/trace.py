"""Device time from a ``torch.profiler`` trace or from CUDA events.

Both give a list of device intervals ``(name, start_s, end_s)`` on one
clock; :func:`reduce` turns them into the busy seconds (their union), the
seconds by name, the kernel count, and the longest idle gaps named by what
the host was doing (the harness's own spans around its calls into the
program).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

Interval = Tuple[str, float, float]


def profiler_intervals(prof, span_names) -> Tuple[List[Interval], List[Interval]]:
    """(device intervals, host spans) of a profile, in seconds: every
    device kernel, copy and set, and the CPU-side ranges named in
    ``span_names`` (the harness's ``record_function`` spans)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        item = (ev.name, tr.start * 1e-6, tr.end * 1e-6)
        if getattr(ev, "device_type", None) == DeviceType.CUDA:
            if getattr(ev, "is_user_annotation", False) or ("#" in ev.name and "(" not in ev.name):
                continue  # a range such as "Optimizer.step#Adam.step", not a device op
            dev.append(item)
        elif ev.name in span_names:
            host.append(item)
    return dev, host


class EventTimer:
    """Records a CUDA event pair around each call of the named methods of
    ``impl`` (a proxy that stands in for it) and gives their intervals."""

    def __init__(self, impl, names):
        self._impl = impl
        self._names = frozenset(names)
        self.records = []

    def __getattr__(self, name):
        fn = getattr(self._impl, name)
        if name not in self._names:
            return fn
        import torch

        def timed(*args, **kwargs):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            stop.record()
            self.records.append((name, start, stop))
            return out

        return timed

    def intervals(self) -> List[Interval]:
        import torch

        torch.cuda.synchronize()
        if not self.records:
            return []
        t0 = self.records[0][1]
        return [(name, 1e-3 * t0.elapsed_time(a), 1e-3 * t0.elapsed_time(b))
                for name, a, b in self.records]


def reduce(dev: List[Interval], label: Callable[[float, float], str], top: int = 10) -> dict:
    """busy_s (the union of the device intervals), seconds by name, the
    number of kernels (the intervals that are no copy or set), the ``top``
    names by time, and the ``top`` longest idle gaps between device
    intervals, each named by ``label(start, end)``."""
    by_name = {}
    for name, a, b in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    busy, gaps = 0.0, []
    end = None
    for name, a, b in sorted(dev, key=lambda r: r[1]):
        if end is None:
            busy += b - a
            end = b
        elif a > end:
            gaps.append((a - end, end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    gaps.sort(reverse=True)
    return dict(
        busy_s=busy,
        seconds_by_name=by_name,
        n_kernels=sum(1 for name, _, _ in dev
                      if not name.lower().startswith(("memcpy", "memset"))),
        device_ops=[[name, s] for name, s in sorted(by_name.items(), key=lambda r: -r[1])[:top]],
        idle_gaps=[[label(a, b), g] for g, a, b in gaps[:top]],
    )


def span_label(spans: List[Interval], default: str) -> Callable[[float, float], str]:
    """label(start, end): the host span holding the gap's midpoint (the
    innermost, by the latest start), else ``default``."""

    def label(a, b):
        mid = 0.5 * (a + b)
        best = None
        for name, s, e in spans:
            if s <= mid <= e and (best is None or s > best[1]):
                best = (name, s)
        return best[0] if best else default

    return label
