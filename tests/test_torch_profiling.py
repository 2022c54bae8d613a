"""The span recorder of ``qsfh_torch/utils/profiling.py`` on the CPU.

Spans and their nesting, the recorder off, ``PhaseTimer``'s report, the
fused runner's and the float64 engine's spans, the kernel library's one
launch seam and its table of launches, the device intervals' placement on the host clock (with
stand-in events: the card's own check is in ``tests/test_torch_gpu.py``)
and the reductions of a trace.
"""

import ast
import os
import re
import time

import numpy as np
import pytest
import torch

from qsfh_torch.engine import kernels as K
from qsfh_torch.utils import profiling as P


@pytest.fixture
def recorder():
    P.collect()
    P.enable()
    try:
        yield P
    finally:
        P.disable()
        P.collect()


def _names(trace):
    return [s["name"] for s in trace["spans"]]


def test_span_nesting_parents_and_tops(recorder):
    with P.span("a", n=1) as a:
        with P.span("a.b") as b:
            with P.span("a.b.c") as c:
                pass
        with P.span("a.d") as d:
            pass
    with P.span("e") as e:
        pass
    tr = P.collect()
    rows = {s["name"]: s for s in tr["spans"]}
    assert _names(tr) == ["a.b.c", "a.b", "a.d", "a", "e"]  # in the order they close
    assert rows["a"]["parent"] == 0 and rows["a"]["top"] == a.id
    assert rows["a.b"]["parent"] == a.id and rows["a.b"]["top"] == a.id
    assert rows["a.b.c"]["parent"] == b.id and rows["a.b.c"]["top"] == a.id
    assert rows["a.d"]["parent"] == a.id and rows["a.d"]["top"] == a.id
    assert rows["e"]["parent"] == 0 and rows["e"]["top"] == e.id
    assert rows["a"]["attrs"] == {"n": 1}
    assert len({a.id, b.id, c.id, d.id, e.id}) == 5
    for s in tr["spans"]:
        assert s["start_ns"] <= s["end_ns"]
    assert rows["a"]["start_ns"] <= rows["a.b"]["start_ns"] <= rows["a.b"]["end_ns"] \
        <= rows["a.d"]["start_ns"] <= rows["a"]["end_ns"]
    assert tr["device"] == [] and tr["drift_ms"] is None  # no device interval on the CPU
    assert P.collect()["spans"] == []  # collect clears


def test_off_keeps_nothing_but_times_the_span():
    P.disable()
    P.collect()
    with P.span("off") as s:
        time.sleep(0.002)
    assert s.seconds >= 0.002 and s.id == 0
    assert P.device("off") is P._NULL
    assert P.collect()["spans"] == []


def test_span_closed_by_an_exception_is_recorded(recorder):
    with pytest.raises(KeyError):
        with P.span("outer"):
            with P.span("inner"):
                raise KeyError
    with P.span("after") as after:
        pass
    tr = P.collect()
    assert _names(tr) == ["inner", "outer", "after"]
    assert tr["spans"][-1]["parent"] == 0 and tr["spans"][-1]["top"] == after.id


def test_span_enters_record_function_while_a_profiler_records(recorder):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with P.span("probe.profiled"):
            torch.ones(8).sum()
    assert "probe.profiled" in {ev.name for ev in prof.events()}
    P.disable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with P.span("probe.unprofiled"):
            torch.ones(8).sum()
    assert "probe.unprofiled" not in {ev.name for ev in prof.events()}


def test_phase_timer_report_and_spans(recorder):
    timer = P.PhaseTimer()
    for _ in range(2):
        with timer.phase("screening"):
            time.sleep(0.001)
    with timer.phase("step build") as s:
        pass
    assert s.name == "adapt.step build"
    assert timer.counts == {"screening": 2, "step build": 1}
    assert timer.totals["screening"] >= 0.002
    assert timer.as_dict() == dict(timer.totals)
    lines = timer.report().split("\n")
    assert re.fullmatch(r"wall: \d+\.\d\ds", lines[0])
    assert re.fullmatch(r"  screening: \d+\.\d\ds \(\d+%, 2 calls, \d+\.\d ms/call\)", lines[1])
    assert re.fullmatch(r"  step build: \d+\.\d\ds \(\d+%, 1 calls, \d+\.\d ms/call\)", lines[2])
    tr = P.collect()
    assert _names(tr) == ["adapt.screening", "adapt.screening", "adapt.step build"]
    total = sum(x["end_ns"] - x["start_ns"] for x in tr["spans"][:2])
    assert total == pytest.approx(1e9 * timer.totals["screening"], abs=1)


def _adapt(root, **kw):
    from qsfh_torch.algos.adapt import ADAPT

    cfg = dict(n_epoch=1, threshold1=1e-2, threshold2=1e-2, x_dimension=2, y_dimension=2,
               n_electrons=4, n_spin_up=2, n_spin_down=2, tunneling=1, coulomb=6, plot=False,
               log_metrics=False, max_inner_iterations=8)
    cfg.update(kw)
    return ADAPT(**cfg, results_root=str(root), device="cpu")


def test_fused_runner_spans_and_chunk_seam(recorder, tmp_path):
    """A 2x2 run of two K = 4 chunks: one ``fused.chunk`` and one
    ``fused.inflight_save`` a chunk, each top-level, one ``fused.select``,
    no device interval on the CPU, and ``on_chunk`` called after each save
    with the chunk's results and the two spans' seconds."""
    from qsfh_torch.algos.adapt_fused import FusedAdaptRunner

    a = _adapt(tmp_path)
    runner = FusedAdaptRunner(a, chunk_iters=4, verbose=False)
    seen = []
    inner = runner.run_inner

    def run_inner(lr, epoch, adam_state=None, inner_done=0):
        return inner(lr, epoch, adam_state, inner_done,
                     on_chunk=lambda res, c, s: seen.append((list(res["energy"]), c, s)))

    runner.run_inner = run_inner
    runner.run()
    tr = P.collect()
    names = _names(tr)
    assert names.count("fused.select") == 1
    assert names.count("fused.chunk") == names.count("fused.inflight_save") == 2
    assert [n for n in names if n.startswith("fused.c") or n.startswith("fused.i")] == [
        "fused.chunk", "fused.inflight_save"] * 2
    assert all(s["parent"] == 0 and s["top"] == s["id"] for s in tr["spans"])
    assert all(s["attrs"] == {"steps": 4} for s in tr["spans"] if s["name"] == "fused.chunk")
    assert tr["device"] == []
    assert [e for r in seen for e in r[0]] == a.results["iteration loss"]
    chunks = [s for s in tr["spans"] if s["name"] == "fused.chunk"]
    saves = [s for s in tr["spans"] if s["name"] == "fused.inflight_save"]
    for (_, c, s), ch, sv in zip(seen, chunks, saves):
        assert c == pytest.approx(1e-9 * (ch["end_ns"] - ch["start_ns"]))
        assert s == pytest.approx(1e-9 * (sv["end_ns"] - sv["start_ns"]))


def test_run_inner_name_kept_for_patched_instances(tmp_path):
    """``_run_inner`` runs ``run_inner``, and an instance's own
    ``build_chunk`` and ``_save_inflight`` (as a caller that wraps them
    sets them) are the ones it calls."""
    from qsfh_torch.algos.adapt_fused import FusedAdaptRunner

    a = _adapt(tmp_path, n_epoch=0)
    a.selected_indices = [0, 1]
    a.params_t = torch.zeros(2, dtype=torch.float64)
    runner = FusedAdaptRunner(a, chunk_iters=4, max_inner_iterations=8, verbose=False)
    build, save = runner.build_chunk, runner._save_inflight
    calls = []
    runner.build_chunk = lambda th, opt, k: (calls.append("build"), build(th, opt, k))[1]
    runner._save_inflight = lambda *args: (calls.append("save"), save(*args))[1]
    gnorm = runner._run_inner(0.01, 0)
    assert calls == ["build", "save", "save"]
    assert len(a.results["iteration loss"]) == 8 and np.isfinite(gnorm)
    assert os.path.exists(runner.inflight_path)


def test_adapt_run_phases_are_spans(recorder, tmp_path):
    a = _adapt(tmp_path, max_inner_iterations=2)
    a.run()
    names = _names(P.collect())
    assert names.count("adapt.screening") == 1
    assert names.count("adapt.step build") == 1
    assert names.count("adapt.inner iteration") == 2
    assert names.count("adapt.checkpoint") == 1
    assert a.timer.counts["inner iteration"] == 2


def test_value_and_grad_is_one_span(recorder):
    from qsfh_torch.native.statevec import Rot64Program

    seg = dict(xb=np.array([1], np.uint32), zb=np.array([0], np.uint32),
               scale=np.array([0.5]), pidx=np.array([0], np.int32), phre=np.array([1.0]),
               phim=np.array([0.0]))
    h = (np.array([0], np.uint32), np.array([1], np.uint32), np.array([1.0]), np.array([0.0]))
    prog = Rot64Program(1, seg, h, 1, device="cpu")
    for x in (0.3, 0.4, 0.5):
        e, g = prog.value_and_grad([x], np.array([1.0, 0.0]))
        assert abs(e - np.cos(x)) < 1e-12
    tr = P.collect()
    assert _names(tr) == ["f64.value_and_grad"] * 3
    assert tr["device"] == []


# -- the launch seam ----------------------------------------------------------------

# the library's queries: sizes and capacities, no launch
QUERIES = {"qsfh_error_string", "qsfh_inner_blocks", "qsfh_adjoint_blocks",
           "qsfh_resident_capacity", "qsfh_f64_blocks", "qsfh_rot64_blocks",
           "qsfh_res64_capacity"}


def _library_refs():
    with open(K.__file__) as fh:
        tree = ast.parse(fh.read())
    declared, called, launched = set(), [], []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute) and node.attr == "restype"
                and isinstance(node.value, ast.Attribute)):
            declared.add(node.value.attr)
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr.startswith("qsfh_"):
            called.append(f.attr)
        if isinstance(f, ast.Name) and f.id == "_launch":
            fn = node.args[1]
            assert isinstance(fn, ast.Attribute) and fn.attr.startswith("qsfh_")
            launched.append(fn.attr)
    return declared, called, launched


def test_every_library_launch_passes_the_seam():
    declared, called, launched = _library_refs()
    assert set(called) <= QUERIES, set(called) - QUERIES  # nothing else is called directly
    assert set(launched) | QUERIES == declared
    assert not set(launched) & QUERIES
    assert len(launched) == 21 and len(set(launched)) == 21


def test_launch_brackets_the_call_and_checks_its_code(monkeypatch):
    events = []

    class Interval:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            events.append(("enter", self.name))

        def __exit__(self, *exc):
            events.append(("exit", self.name))

    class Lib:
        @staticmethod
        def qsfh_error_string(rc):
            return b"planted"

    monkeypatch.setattr(K.profiling, "device", Interval)
    monkeypatch.setattr(K, "_lib", Lib())
    K._launch("probe_kernel", lambda *args: events.append(("call", args)) or 0, 1, 2)
    assert events == [("enter", "probe_kernel"), ("call", (1, 2)), ("exit", "probe_kernel")]
    with pytest.raises(RuntimeError, match="probe_kernel: CUDA error 7: planted"):
        K._launch("probe_kernel", lambda: 7)


# -- the launch table ----------------------------------------------------------------


def test_launch_counts_its_launches_under_its_name():
    """A launch whose call returns 0 adds its ``launches`` (1 by default)
    under its name; the other wrappers stay at 0, every wrapper of
    ``WRAPPERS`` is a key, and a call on the CPU (the plain version) counts
    nothing."""
    K.reset_launch_counts()
    psi = torch.zeros(8, dtype=torch.complex64)
    psi[0] = 1
    one = torch.ones(1)
    K.pauli_rotation(psi, torch.tensor([1]), torch.tensor([0]), one, one, 0 * one)
    assert sum(K.launch_counts().values()) == 0
    K._launch("rotation_tile_runs", lambda *args: 0, 1, 2, launches=609)
    K._launch("rotation_tile_runs", lambda: 0)
    K._launch("pauli_rotation_out", lambda: 0)
    counts = K.launch_counts()
    assert list(counts) == [fn.__name__ for fn in K.WRAPPERS] and len(counts) == 23
    assert {k: v for k, v in counts.items() if v} == {"rotation_tile_runs": 610,
                                                      "pauli_rotation_out": 1}
    K.reset_launch_counts()


def test_reset_launch_counts_zeroes_every_wrapper():
    K.reset_launch_counts()
    for fn in K.WRAPPERS:
        K._launch(fn.__name__, lambda: 0, launches=3)
    assert set(K.launch_counts().values()) == {3}
    K.reset_launch_counts()
    assert K.launch_counts() == {fn.__name__: 0 for fn in K.WRAPPERS}


def test_failed_launch_counts_nothing(monkeypatch):
    """A non-zero return code raises with the library's message and adds
    nothing to the table."""

    class Lib:
        @staticmethod
        def qsfh_error_string(rc):
            return b"planted"

    monkeypatch.setattr(K, "_lib", Lib())
    K.reset_launch_counts()
    with pytest.raises(RuntimeError, match="adjoint_tile_runs: CUDA error 7: planted"):
        K._launch("adjoint_tile_runs", lambda: 7, launches=5)
    assert sum(K.launch_counts().values()) == 0


# -- device intervals on the host clock, with stand-in events ----------------------


class _Event:
    """A stand-in for ``torch.cuda.Event`` at device time ``t`` (ms), the
    device clock running at ``rate`` of the host's."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return float(np.float32(other.t - self.t))


def test_collect_places_device_intervals_on_the_host_clock(monkeypatch):
    rate = 1 + 2e-4  # the device clock runs 200 ppm fast
    h0 = 10_000_000_000
    P.collect()
    P.enable()
    # the anchors and intervals: device times of host times (ns) h0 + x
    dev = lambda x: 1e-6 * x * rate  # noqa: E731
    monkeypatch.setattr(P, "_anchor", (h0, 20_000, _Event(dev(0)), 0))
    with P.span("outer") as outer:
        pass
    iv = [(1_000_000, 3_000_000), (50_000_000, 52_500_000), (150_000_000, 190_000_000)]
    P._device.extend(("k", outer.id, _Event(dev(a)), _Event(dev(b))) for a, b in iv)
    monkeypatch.setattr(P, "_take_anchor",
                        lambda: (h0 + 200_000_000, 30_000, _Event(dev(200_000_000)), 0))
    tr = P.collect()
    P.disable()
    assert tr["anchor_ms"] == pytest.approx([0.02, 0.03])
    assert tr["drift_ms"] == pytest.approx(-200 * 2e-4, rel=1e-4)
    assert len(tr["device"]) == 3
    for d, (a, b) in zip(tr["device"], iv):
        assert d["name"] == "k" and d["span"] == outer.id
        assert d["start_ns"] == pytest.approx(h0 + a, abs=50)  # float32 ms of each step
        assert d["end_ns"] == pytest.approx(h0 + b, abs=50)


def test_device_interval_needs_an_anchor(recorder):
    assert P._anchor is None  # the CPU: no device, no anchor
    with P.device("k"):
        pass
    assert P._device == []


def test_summarize():
    ms = 1_000_000
    trace = dict(
        spans=[dict(name="chunk", id=1, parent=0, top=1, start_ns=0, end_ns=10 * ms, attrs={}),
               dict(name="save", id=2, parent=0, top=2, start_ns=10 * ms, end_ns=14 * ms,
                    attrs={}),
               dict(name="chunk", id=3, parent=0, top=3, start_ns=14 * ms, end_ns=24 * ms,
                    attrs={})],
        device=[dict(name="replay", span=1, start_ns=1 * ms, end_ns=11 * ms),
                dict(name="replay", span=3, start_ns=15 * ms, end_ns=25 * ms),
                dict(name="copy", span=3, start_ns=12 * ms, end_ns=13 * ms)],
        anchor_ms=[0.01, 0.02], drift_ms=0.001)
    s = P.summarize(trace)
    assert s["busy_ms"] == pytest.approx(21.0)
    assert s["spans"]["chunk"] == pytest.approx(dict(n=2, ms=20.0, idle_ms=1.0 + 1.0))
    assert s["spans"]["save"]["idle_ms"] == pytest.approx(4.0 - 1.0 - 1.0)
    assert s["device"]["replay"] == pytest.approx(dict(n=2, ms=20.0, gap_ms=4.0 - 1.0))
    assert s["device"]["copy"]["gap_ms"] == 0.0
    assert s["anchor_ms"] == [0.01, 0.02] and s["drift_ms"] == 0.001
