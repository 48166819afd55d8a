"""Dispatch-and-compute ceiling of the packed replay, on the port.

The counterpart of `scripts/compute_ceiling.py`. Stages one packed pass
(`stage_packed`: one upload per dtype, the only host-to-device copy), then
times passes that REUSE the staged device arenas, each on a fresh decoder:
zero transfer, so the number is what the card and the dispatch path
sustain with the link out of the picture. It brackets `bench_torch.py`'s
device phase from above.

    HVQM4_BENCH_STREAMS=16 python scripts/compute_ceiling_torch.py [passes]
        [--device cuda|cpu]

Prints ONE JSON line with the JAX script's keys (`backend` is the torch
device type) and `card` (nvidia-smi's name and power limit, null off the
card). The clip is HVQM4_BENCH_CLIP (default testdata/ref640.h4m), K is
HVQM4_STEPS_PER_DISPATCH, as `bench_torch._setup` reads them; streams
default to 16. `--device` defaults to `cuda` (`cpu` under
HVQM4_BENCH_FORCE_CPU=1); without a card the script fails.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from bench_torch import (_setup, bench_device, card_line,  # noqa: E402
                         plan_pass, sync)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("passes", type=int, nargs="?", default=4)
    ap.add_argument("--device", default=bench_device(),
                    help="torch device (default: cuda)")
    args = ap.parse_args()

    n_streams = int(os.environ.get("HVQM4_BENCH_STREAMS", "16"))
    _cfg, _cp, make_ms = _setup(n_streams, args.device)
    p = plan_pass(make_ms())
    bufs, frames = p["bufs"], p["frames"]
    ms = make_ms()
    ms.stage_packed(bufs)          # the ONLY upload
    staged = [b.pop("arenas_staged") for b in bufs]

    def replay(dec):
        for b, st in zip(bufs, staged):
            b["arenas_staged"] = st
            dec.device_step(b)

    replay(ms)  # warm
    samples = []
    for _ in range(args.passes):
        dec = make_ms()
        sync(args.device)
        t0 = time.perf_counter()
        replay(dec)
        sync(args.device)
        samples.append(frames / (time.perf_counter() - t0))
    print(json.dumps({
        "compute_only_fps_samples": [round(s, 1) for s in samples],
        "compute_only_fps_best": round(max(samples), 1),
        "streams": n_streams, "frames_per_pass": frames,
        "backend": ms.device.type, "card": card_line(ms.device)}))


if __name__ == "__main__":
    main()
