"""Randomized device-path conformance soak on the port (one-off battery).

The counterpart of `scripts/soak_device.py`: randomized clips through the
PRODUCTION path of the port, the arena `MultiStreamDecoder` on `--device`
(C++ step planning into two packed staging buffers, threaded slice
planning, K fused steps, the CUDA kernels on the card), compared stream by
stream with the C oracle's output, byte for byte.

    python scripts/soak_device_torch.py [n_cases] [base_seed]
                                        [--device cuda|cpu]

Each case draws, from its seed, what `soak_device.py`'s `one_case` draws,
with the same rng calls in the same order (`case_clips`): width and height
in 16..96 in steps of 8, 4:2:0 or 4:4:4, version 1.3 or 1.5,
`HVQM4_PLANNER_THREADS` 1 or 4, 1-3 streams, K in {1, 2, 4}; per stream a
GOP pattern ("I" then one of "P", "BP", "BBP", "PBPB" or nothing), a slice
count and a `dc_shift`. Stream s of seed `seed` is the port's
`tools/encoder_torch.make_clip` of seed `seed * 17 + s`, so a seed gives
both soaks the same streams, byte for byte: every block mode chosen at
random in every frame type, forced escapes of DC and vector deltas, and
nest origins anywhere up to twice the block grid.

No run is split into subprocesses: the JAX script recycles its address
space every 50 cases because each geometry compiles there; nothing
compiles per geometry here. `--device` defaults to `cuda`; without a card
the script fails.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from hvqm4_tpu_torch.config import SeqConfig  # noqa: E402
from hvqm4_tpu_torch.parallel.multistream import MultiStreamDecoder  # noqa: E402
from tools.encoder_torch import make_clip  # noqa: E402


def oracle_yuv(oracle_bin, clip: bytes) -> bytes:
    with tempfile.TemporaryDirectory() as d:
        src = pathlib.Path(d) / "c.h4m"
        dst = pathlib.Path(d) / "c.yuv"
        src.write_bytes(clip)
        r = subprocess.run([str(oracle_bin), str(src), str(dst)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            # surface the oracle's diagnostic (names the offending record)
            raise RuntimeError(f"oracle failed: {r.stderr.strip()[:300]}")
        return dst.read_bytes()


def case_clips(seed: int) -> tuple:
    """The case of `seed`, drawn as `soak_device.py`'s `one_case` draws it:
    (cfg, clips, planner threads, K, description)."""
    rng = np.random.default_rng(seed)
    w = 8 * int(rng.integers(2, 13))
    h = 8 * int(rng.integers(2, 13))
    samp = int(rng.choice([1, 2]))
    version = str(rng.choice(["1.3", "1.5"]))
    cfg = SeqConfig(w, h, samp, samp, version=version)
    mh = cfg.mb_grid[0]
    threads = int(rng.choice([1, 4]))
    n_streams = int(rng.integers(1, 4))
    k = int(rng.choice([1, 2, 4]))  # fused-dispatch factor (virtual slots)
    clips, slices_used = [], []
    for si in range(n_streams):
        pattern = "I" + str(rng.choice(["P", "BP", "BBP", "PBPB", ""]))
        slices = int(rng.integers(1, min(mh, 6) + 1))
        slices_used.append(slices)
        clips.append(make_clip(cfg, [pattern], seed=seed * 17 + si,
                               dc_shift=int(rng.integers(0, 8)),
                               slices=slices))
    desc = (f"seed={seed} {w}x{h} samp={samp} v{version} "
            f"streams={n_streams} slices={slices_used} threads={threads} "
            f"K={k}")
    return cfg, clips, threads, k, desc


def one_case(oracle_bin, seed: int, device) -> str:
    """Decode on `device` and compare one random case; returns its
    description, raises AssertionError on a mismatch."""
    cfg, clips, threads, k, desc = case_clips(seed)
    os.environ["HVQM4_PLANNER_THREADS"] = str(threads)
    n_streams = len(clips)
    ms = MultiStreamDecoder(cfg, clips, device, steps_per_dispatch=k)
    got = [b""] * n_streams
    for frames, _metas, valid in ms.run_pipelined():
        fnp = [p.cpu().numpy() for p in frames]
        for si, ok in enumerate(valid):
            if ok:
                got[si] += b"".join(fnp[pi][si].tobytes() for pi in range(3))
    for si, clip in enumerate(clips):
        if got[si] != oracle_yuv(oracle_bin, clip):
            raise AssertionError(f"MISMATCH stream {si}: {desc}")
    return desc


def run(n: int, base: int, device, log=print) -> list[str]:
    """Build the oracle and soak `n` cases from seed `base`; returns their
    descriptions. `HVQM4_PLANNER_THREADS` is restored afterwards."""
    subprocess.run(["make", "-s", "-C", str(REPO / "oracle")], check=True)
    oracle_bin = REPO / "oracle" / "hvqm4_oracle"
    saved = os.environ.get("HVQM4_PLANNER_THREADS")
    descs = []
    try:
        for i in range(n):
            descs.append(one_case(oracle_bin, base + i, device))
            if (i + 1) % 10 == 0 or i == 0 or i == n - 1:
                log(f"[{i + 1}/{n}] ok  {descs[-1]}")
    finally:
        if saved is None:
            os.environ.pop("HVQM4_PLANNER_THREADS", None)
        else:
            os.environ["HVQM4_PLANNER_THREADS"] = saved
    return descs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("n_cases", type=int, nargs="?", default=100)
    ap.add_argument("base_seed", type=int, nargs="?", default=5000)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    run(args.n_cases, args.base_seed, args.device,
        log=lambda s: print(s, flush=True))
    print(f"PASS: {args.n_cases} randomized device-path configs bit-exact "
          f"vs oracle on {args.device}")


if __name__ == "__main__":
    main()
