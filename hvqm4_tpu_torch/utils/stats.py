"""Per-clip structured statistics (SURVEY.md §5 "Metrics / observability").

Mode histograms, stream byte budgets, and frame-type counts: useful both
for corpus sanity and for explaining timings (the mode mix drives kernel
cost). The counterpart of `hvqm4_tpu/utils/stats.py`, over the C++ planner;
`tests/test_torch_host.py` holds the JSON against the original's.
"""

from __future__ import annotations

import json
from collections import Counter

import numpy as np

from ..container import Demuxer
from ..native import NativePlanner
from ..plans import CLS_INTRA


def clip_stats(data: bytes) -> str:
    d = Demuxer(data)
    pl = NativePlanner(d.info.cfg)
    ftypes: Counter = Counter()
    modes: Counter = Counter()
    cls: Counter = Counter()
    payload_bytes = 0
    for r in d.video_records():
        ftypes[r.frame_char] += 1
        payload_bytes += len(r.payload)
        plan = pl.plan_frame(r.frame_char, r.payload)
        for p in plan.planes:
            intra = p.cls == CLS_INTRA
            cls["intra"] += int(intra.sum())
            cls["inter"] += int((~intra).sum())
            for m, n in zip(*np.unique(p.mode[intra], return_counts=True)):
                modes[f"intra_mode_{m}"] += int(n)
            for m, n in zip(*np.unique(p.mode[~intra], return_counts=True)):
                modes[f"inter_bases_{m}"] += int(n)
    return json.dumps({
        "frames": dict(ftypes),
        "video_payload_bytes": payload_bytes,
        "block_classes": dict(cls),
        "modes": dict(sorted(modes.items())),
    }, indent=2)
