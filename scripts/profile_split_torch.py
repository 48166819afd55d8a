"""The host-side cost split of the arena decode, a step at a time, on the port.

The counterpart of `scripts/profile_split.py`. After a warm
`run_pipelined` over the clip, a fresh decoder runs it again unpipelined
and times, summed over the steps:

  plan  — `plan_step`: the batched C++ planner call and the assembly
  xfer  — the step's two uploads (`_stage_arenas`: non-blocking copies
          from the pinned ring on the card; private copies on the CPU,
          whose ring a later step rewrites while this one may still read
          it)
  step  — the `_run_steps` dispatch (asynchronous on the card: the cost of
          queueing its launches)
  sync  — the final `torch.cuda.synchronize`: the device's residue

    python scripts/profile_split_torch.py [n_streams] [--device cuda|cpu]

Prints ONE JSON line: per-step ms of each, the KiB uploaded a step and
the effective upload rate, with `backend` (the torch device type) and
`card` (nvidia-smi's name and power limit, null off the card). The clip
is HVQM4_BENCH_CLIP (default testdata/ref640.h4m), K is
HVQM4_STEPS_PER_DISPATCH, as `bench_torch._setup` reads them. `--device`
defaults to `cuda` (`cpu` under HVQM4_BENCH_FORCE_CPU=1); without a card
the script fails.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from bench_torch import _setup, bench_device, card_line, sync  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("n_streams", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=bench_device(),
                    help="torch device (default: cuda)")
    args = ap.parse_args()

    import numpy as np

    from hvqm4_tpu_torch.parallel.multistream import _run_steps

    n, dev = args.n_streams, args.device
    _cfg, _cp, make_ms = _setup(n, dev)
    ms = make_ms()  # warm: allocator, pinned pages, first launches
    for _ in ms.run_pipelined():
        pass

    ms = make_ms()
    t_plan = t_xfer = t_step = 0.0
    nsteps = frames = bytes_up = 0
    sync(dev)
    t0 = time.perf_counter()
    while any(ms.active):
        t = time.perf_counter()
        buf, _metas, valid = ms.plan_step()
        t_plan += time.perf_counter() - t

        t = time.perf_counter()
        arenas = ms._stage_arenas(buf)
        size8, size32 = buf["sizes"]
        bytes_up += size8 + size32 * 4
        t_xfer += time.perf_counter() - t

        t = time.perf_counter()
        _run_steps(ms.cfg, ms.n, ms._k, *buf["variant"], arenas, ms.nest,
                   ms.ref_prev, ms.ref_last)
        t_step += time.perf_counter() - t
        nsteps += 1
        frames += int(np.sum(valid))
    t = time.perf_counter()
    sync(dev)
    t_sync = time.perf_counter() - t
    wall = time.perf_counter() - t0

    print(json.dumps({
        "streams": n, "steps": nsteps, "frames": frames,
        "steps_per_dispatch": ms._k,
        "wall_s": round(wall, 4), "fps": round(frames / wall, 1),
        "plan_ms_per_step": round(1e3 * t_plan / nsteps, 4),
        "xfer_ms_per_step": round(1e3 * t_xfer / nsteps, 4),
        "step_ms_per_step": round(1e3 * t_step / nsteps, 4),
        "sync_ms": round(1e3 * t_sync, 4),
        "kib_per_step": round(bytes_up / nsteps / 1024, 1),
        "upload_mb_per_s": round(bytes_up / wall / 1e6, 1),
        "backend": ms.device.type, "card": card_line(ms.device)}))


if __name__ == "__main__":
    main()
