"""Spans, device intervals and phase timers of the drivers.

One clock: the host's ``time.perf_counter_ns``.

* :class:`span` is a named host interval.  It always measures its own
  duration (``.seconds`` after it closes), so log lines and reports read
  it.  While the recorder is on it also keeps a record (name, id, parent
  id, the id of its top-level span, start, end, attributes), and while a
  ``torch.profiler`` is recording it opens a ``record_function`` of the
  same name, so the program's spans sit in the profiler's timeline beside
  its kernels.
* :func:`device` brackets work queued on the current CUDA stream with a
  pair of CUDA events, tagged with the innermost open span.  Only while
  the recorder is on, and never while the stream is capturing a graph.
  The events are read in :func:`collect`, after a synchronise, and placed
  on the host clock by two anchors: an event recorded and synchronised at
  :func:`enable` and another at :func:`collect`, a device time mapped
  linearly between them.
* :class:`PhaseTimer` sums the durations of named phases (``adapt.<name>``
  spans) for a driver's report: the counterpart of ``PhaseTimer`` in
  ``qsfh_tpu/utils/profiling.py``.

The recorder is off by default.  Off, a span costs its two clock reads,
:func:`device` one flag check.  Whoever reads the trace calls :func:`enable`,
runs the work and calls :func:`collect`; :func:`summarize` reduces what it
returns.
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import time
from collections import defaultdict
from typing import Dict, List

import torch

_clock = time.perf_counter_ns

_on = False
_ids = itertools.count(1)
_stack: List["span"] = []  # open spans, recorder on
_spans: list = []  # closed spans: (name, id, parent, top, start_ns, end_ns, attrs)
_device: list = []  # (name, span id, start event, end event)
_anchor = None  # (host ns, window ns, event, device index) of the last enable() / collect()
_NULL = contextlib.nullcontext()
_streams: dict = {}  # stream id -> torch.cuda.Stream, for the event records
# anchor tries: the narrowest record-to-sync window is kept
_ANCHOR_TRIES = 5


def _take_anchor():
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    torch.cuda.synchronize()
    best = None
    for _ in range(_ANCHOR_TRIES):
        ev = torch.cuda.Event(enable_timing=True)
        t0 = _clock()
        ev.record()
        ev.synchronize()
        t1 = _clock()
        if best is None or t1 - t0 < best[1]:
            best = ((t0 + t1) // 2, t1 - t0, ev, torch.cuda.current_device())
    return best


def enable():
    """Turn the recorder on: spans and device intervals are kept from here.
    On a CUDA device, also takes the first clock anchor."""
    global _on, _anchor
    _anchor = _take_anchor()
    _on = True


def disable():
    """Turn the recorder off; what it holds stays for :func:`collect`."""
    global _on
    _on = False


def collect() -> dict:
    """Everything recorded since :func:`enable` (or the last collect), and
    clear it.  Synchronises the device first.

    ``spans``: dicts of name, id, parent (0: none), top (the id of its
    top-level span), start_ns, end_ns and attrs.  ``device``: dicts of
    name, span (the innermost open span's id, 0: none), start_ns and end_ns
    on the host clock.  ``anchor_ms``: each anchor's record-to-sync window;
    ``drift_ms``: the host clock's seconds between the anchors less the
    device clock's, in ms (None without a device)."""
    global _anchor, _spans, _device
    spans, dev = _spans, _device
    _spans, _device = [], []
    out = dict(
        spans=[dict(name=n, id=i, parent=p, top=t, start_ns=a, end_ns=b, attrs=at)
               for n, i, p, t, a, b, at in spans],
        device=[], anchor_ms=[], drift_ms=None)
    first = _anchor
    last = _take_anchor() if first is not None else None
    _anchor = last if _on else None
    if first is None or last is None:
        return out
    # each event's time from the one before it (elapsed_time is float32
    # milliseconds: short differences keep microseconds over a long window)
    prev, t = first[2], 0.0
    times = []
    for _, _, a, b in dev:
        t += prev.elapsed_time(a)
        ta = t
        t += a.elapsed_time(b)
        times.append((ta, t))
        prev = b
    dev_span_ms = t + prev.elapsed_time(last[2])
    host_span_ms = 1e-6 * (last[0] - first[0])
    scale = host_span_ms / dev_span_ms if dev_span_ms > 0 else 1.0
    for (name, sid, _, _), (ta, tb) in zip(dev, times):
        out["device"].append(dict(name=name, span=sid, start_ns=first[0] + 1e6 * ta * scale,
                                  end_ns=first[0] + 1e6 * tb * scale))
    out["anchor_ms"] = [1e-6 * first[1], 1e-6 * last[1]]
    out["drift_ms"] = host_span_ms - dev_span_ms
    return out


class span:
    """``with span(name, **attrs) as s: ...``; ``s.seconds`` after it closes."""

    __slots__ = ("name", "attrs", "id", "start_ns", "end_ns", "_rf")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self.id = 0
        self._rf = None

    def __enter__(self):
        self.id = 0
        if _on:
            self.id = next(_ids)
            _stack.append(self)
            if torch._C._autograd._profiler_enabled():
                self._rf = torch.profiler.record_function(self.name)
                self._rf.__enter__()
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc):
        self.end_ns = _clock()
        if self.id:
            if self._rf is not None:
                self._rf.__exit__(None, None, None)
                self._rf = None
            i = _stack.index(self)
            parent = _stack[i - 1].id if i else 0
            top = _stack[0].id
            del _stack[i:]
            if _on:
                _spans.append((self.name, self.id, parent, top, self.start_ns, self.end_ns,
                               self.attrs))
        return False

    @property
    def seconds(self) -> float:
        return 1e-9 * (self.end_ns - self.start_ns)


def _current_stream(index: int):
    """The device's current stream, a ``torch.cuda.Stream`` made once per
    stream (``torch.cuda.current_stream()`` builds one a call)."""
    sid, index, kind = torch._C._cuda_getCurrentStream(index)
    stream = _streams.get(sid)
    if stream is None:
        stream = _streams[sid] = torch.cuda.Stream(stream_id=sid, device_index=index,
                                                   device_type=kind)
    return stream


class _DeviceInterval:
    __slots__ = ("name", "start", "stream")

    def __init__(self, name: str):
        self.name = name
        self.start = None

    def __enter__(self):
        if (_anchor is not None and torch._C._cuda_getDevice() == _anchor[3]
                and not torch.cuda.is_current_stream_capturing()):
            self.stream = _current_stream(_anchor[3])
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            _device.append((self.name, _stack[-1].id if _stack else 0, self.start, end))
        return False


def device(name: str):
    """A context bracketing the work it queues on the current CUDA stream
    (recorder on, the stream not capturing, the device of :func:`enable`)."""
    return _DeviceInterval(name) if _on else _NULL


# -- reductions of a collected trace ----------------------------------------------


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _busy(merged, starts, a, b) -> float:
    """The part of [a, b] that the merged intervals cover (``starts``: their
    starts, for the search)."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0.0
    while i < len(merged) and merged[i][0] < b:
        x, y = merged[i]
        total += max(0.0, min(b, y) - max(a, x))
        i += 1
    return total


def summarize(trace: dict) -> dict:
    """Per span name: count, host ms, and the ms the device was idle while
    a span of that name was open (no device interval of the trace under
    it); per device interval name: count, device ms, and the idle ms
    between consecutive intervals of that name; the union of all device
    intervals (``busy_ms``); the anchors' windows and the drift."""
    dev = trace["device"]
    merged = _union((d["start_ns"], d["end_ns"]) for d in dev)
    starts = [a for a, _ in merged]

    def idle(a, b):
        return max(0.0, b - a) - _busy(merged, starts, a, b)

    spans: Dict[str, dict] = {}
    for s in trace["spans"]:
        a, b = s["start_ns"], s["end_ns"]
        row = spans.setdefault(s["name"], dict(n=0, ms=0.0, idle_ms=0.0))
        row["n"] += 1
        row["ms"] += 1e-6 * (b - a)
        row["idle_ms"] += 1e-6 * idle(a, b)
    by_name: Dict[str, list] = defaultdict(list)
    for d in dev:
        by_name[d["name"]].append((d["start_ns"], d["end_ns"]))
    devices = {}
    for name, ivs in by_name.items():
        own = _union(ivs)
        devices[name] = dict(
            n=len(ivs), ms=1e-6 * sum(b - a for a, b in own),
            gap_ms=1e-6 * sum(idle(own[i][1], own[i + 1][0]) for i in range(len(own) - 1)))
    return dict(spans=spans, device=devices, busy_ms=1e-6 * sum(b - a for a, b in merged),
                anchor_ms=trace["anchor_ms"], drift_ms=trace["drift_ms"])


# -- phase timers -------------------------------------------------------------------


class PhaseTimer:
    """Totals and counts of named phases; each phase is an
    ``adapt.<name>`` span.  A phase that ends in a host read of a device
    value includes the device time."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._t0 = _clock()

    @contextlib.contextmanager
    def phase(self, name: str):
        s = span("adapt." + name)
        try:
            with s:
                yield s
        finally:
            self.totals[name] += s.seconds
            self.counts[name] += 1

    def report(self) -> str:
        wall = 1e-9 * (_clock() - self._t0)
        lines = [f"wall: {wall:.2f}s"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"  {name}: {total:.2f}s ({100 * total / max(wall, 1e-9):.0f}%, "
                f"{n} calls, {1e3 * total / n:.1f} ms/call)"
            )
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)
