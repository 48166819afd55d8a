"""Per-stage wall-clock instrumentation: the port's copy of `StageTimer` from
`hvqm4_tpu/utils/profiling.py`. Each pipeline stage (plan / upload /
device) can be timed, at near-zero cost when disabled. Host clock only: a
stage that enqueues device work ends before the device does.

`torch_trace` is the counterpart of `jax_trace`: a `torch.profiler` trace
of a region, host and card, written for Perfetto or chrome://tracing.
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


@contextlib.contextmanager
def torch_trace(logdir: str | None):
    """Capture a `torch.profiler` trace of the region into `logdir` as
    `trace.json` (Chrome/Perfetto format): the host's ops always, the
    card's kernels and copies when CUDA is available. `None` or an empty
    string traces nothing."""
    if not logdir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
