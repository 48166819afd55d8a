"""Generate the retail-bitrate benchmark clip (testdata/retail640.h4m) with
the port's encoder.

The counterpart of `tools/make_retail_clip.py`, on the port's
`encode.encode_to_size` and `VideoEncoder` (`hvqm4_tpu_torch`, host numpy;
no device is used): the same `GOPS`, `retail_frames` and arguments, and
the same bytes. It imports nothing of the JAX package.

The primary corpus clip (`testdata/ref640.h4m`, tools/encoder.py seed 7) is
deliberately HEAVY content: near-incompressible payloads averaging ~132 KB
per 640×480 frame — ~10x the bitrate of real GameCube-era FMV (retail
`.h4m` clips ran ~1-4 Mbps ≈ 4-17 KB/frame at 30 fps). Heavy content is the
right conformance stress, but it makes the host→device plan upload the
dominant cost through a thin link, which misrepresents throughput on
representative streams. This tool renders smooth synthetic video (moving
gradients + a textured moving object — FMV-like statistics) and
rate-controls it to a retail-like size, giving the benchmark suite a second
operating point (BASELINE.md reports both).

Run: python tools/make_retail_clip_torch.py [--target-kb 340] [--iters 4]
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from hvqm4_tpu_torch.config import SeqConfig  # noqa: E402
from hvqm4_tpu_torch.encode import VideoEncoder, encode_to_size  # noqa: E402

GOPS = ["IBBPBP" + "BP" * 8, "IPPPPP"]  # same GOP structure as ref640


def retail_frames(cfg: SeqConfig, n: int, seed: int = 11):
    """FMV-like synthetic video: smooth gradients, global texture drift,
    and a textured 64×64 object moving across the frame."""
    rng = np.random.default_rng(seed)
    h, w = cfg.plane_shapes[0]
    gx = np.linspace(30, 210, w)[None, :]
    gy = np.linspace(0, 60, h)[:, None]
    tex = rng.normal(0, 6, (h, w))
    frames = []
    for t in range(n):
        y = gx + gy + np.roll(tex, (2 * t, 3 * t), (0, 1))
        x0 = (40 + 6 * t) % (w - 64)
        y0 = (30 + 4 * t) % (h - 64)
        y[y0:y0 + 64, x0:x0 + 64] = 200 + np.roll(tex, t, 0)[:64, :64]
        y = np.clip(y, 0, 255).astype(np.uint8)
        u = np.clip(110 + gx * 0.1 + gy * 0 + np.roll(tex, -t, 1) * 0.5,
                    0, 255).astype(np.uint8)[::2, ::2]
        v = np.clip(140 - gy * 0.2 + gx * 0, 0, 255).astype(
            np.uint8)[::2, ::2]
        frames.append([y, u, v])
    return frames


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--target-kb", type=float, default=None,
                    help="rate-control to a total clip size (e.g. 340 KB "
                         "/ 28 frames ≈ 12 KB/frame ≈ 2.9 Mbps at 30 fps); "
                         "each bisection pass costs a full encode, so the "
                         "default is a single --lam pass")
    ap.add_argument("--lam", type=float, default=8.0,
                    help="single-pass lambda when no --target-kb")
    ap.add_argument("--iters", type=int, default=4,
                    help="rate-control bisection passes (with --target-kb)")
    ap.add_argument("--out", default=str(pathlib.Path(__file__).parents[1]
                                         / "testdata" / "retail640.h4m"))
    args = ap.parse_args()

    cfg = SeqConfig(640, 480)
    n = sum(len(g) for g in GOPS)
    frames = retail_frames(cfg, n)
    t0 = time.perf_counter()
    if args.target_kb is not None:
        clip, lam = encode_to_size(cfg, frames, GOPS,
                                   target_bytes=int(args.target_kb * 1024),
                                   iters=args.iters)
    else:
        lam = args.lam
        clip = VideoEncoder(cfg, lambda_bits=lam).encode(frames, GOPS)
    pathlib.Path(args.out).write_bytes(clip)
    print(f"wrote {args.out}: {len(clip) / 1024:.0f} KB "
          f"({len(clip) / n / 1024:.1f} KB/frame), lambda={lam:.2f}, "
          f"{time.perf_counter() - t0:.0f}s")


if __name__ == "__main__":
    main()
