"""Phase timers for the drivers.

Counterpart of ``PhaseTimer`` in ``qsfh_tpu/utils/profiling.py``: named
phase durations (screening / step build / inner iteration / checkpoint)
and a breakdown report.  Host wall clock; a phase that ends in a host read
of a device value includes the device time.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


class PhaseTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._t0 = time.time()

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.time()
        try:
            yield
        finally:
            self.totals[name] += time.time() - start
            self.counts[name] += 1

    def report(self) -> str:
        wall = time.time() - self._t0
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
