"""Per-stage wall-clock instrumentation: the port's copy of `StageTimer` from
`hvqm4_tpu/utils/profiling.py`. Each pipeline stage (plan / upload /
device) can be timed, at near-zero cost when disabled. Host clock only: a
stage that enqueues device work ends before the device does.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class StageTimer:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name:>10s}: {t * 1e3:9.2f} ms total, "
                         f"{t / max(n, 1) * 1e6:9.1f} us/call x{n}")
        return "\n".join(lines) or "(no stages recorded)"
