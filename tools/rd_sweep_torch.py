"""Rate-distortion sweep for the port's content-aware encoder.

The counterpart of `tools/rd_sweep.py`, on the port (`hvqm4_tpu_torch`):
the encoder is the port's `VideoEncoder`, the closed-loop decode its C++
`NativePlanner` (the JAX tool's Python `Planner` is not ported; both plan
alike) and its `refdec.GoldenDecoder`. It imports nothing of the JAX
package and prints the JAX tool's table for the same arguments.

Encodes the same frames across a ladder of lambda_bits values and prints
one row per point: lambda, bytes, bits-per-pixel, PSNR (closed-loop decode
vs source), plus mode histograms — the tool you reach for when tuning the
encoder's RD tradeoff on new content.

Usage:
    python tools/rd_sweep_torch.py [--width W] [--height H]
                                   [--gops IPBPB,IPP] [--seed S]
                                   [--lambdas 1,2,4,8,16]
                                   [--tpu-search [--device cuda|cpu]]
The frame count is the total length of the --gops patterns.
Synthesizes moving-texture content by default; pass --yuv FILE (planar
I420, W*H*1.5 bytes/frame) to sweep real frames instead.
`--tpu-search` scores every nest candidate with `encode_tpu.NestSearch` on
`--device` (default `cuda`; without a card the tool fails, and `--device
cpu` asks for the CPU); without it no device is used.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from hvqm4_tpu_torch.config import SeqConfig  # noqa: E402
from hvqm4_tpu_torch.container import Demuxer  # noqa: E402
from hvqm4_tpu_torch.encode import VideoEncoder  # noqa: E402
from hvqm4_tpu_torch.native import NativePlanner  # noqa: E402
from hvqm4_tpu_torch.refdec import GoldenDecoder  # noqa: E402


def synth_frames(cfg: SeqConfig, n: int, seed: int):
    """Blocky-DC base translating with additive texture evolution."""
    rng = np.random.default_rng(seed)
    h, w = cfg.plane_shapes[0]
    # base must cover the full pan: frame t slices at (2t, 3t)
    dcs = rng.integers(30, 230, ((h + 2 * n) // 4 + 2,
                                 (w + 3 * n) // 4 + 2)).astype(np.uint8)
    base = np.kron(dcs, np.ones((4, 4), np.uint8))
    frames = []
    for t in range(n):
        y = base[2 * t:2 * t + h, 3 * t:3 * t + w].astype(np.int32)
        if t:
            y = np.clip(y + rng.integers(-10, 11, y.shape), 0, 255)
        u = np.full(cfg.plane_shapes[1], 110 + 3 * t, np.uint8)
        v = np.full(cfg.plane_shapes[2], 140 - 2 * t, np.uint8)
        frames.append([y.astype(np.uint8), u, v])
    return frames


def load_yuv(path: str, cfg: SeqConfig, n: int):
    h, w = cfg.plane_shapes[0]
    ch, cw = cfg.plane_shapes[1]
    fsz = h * w + 2 * ch * cw
    raw = open(path, "rb").read()
    frames = []
    for t in range(min(n, len(raw) // fsz)):
        o = t * fsz
        y = np.frombuffer(raw, np.uint8, h * w, o).reshape(h, w)
        u = np.frombuffer(raw, np.uint8, ch * cw, o + h * w).reshape(ch, cw)
        v = np.frombuffer(raw, np.uint8, ch * cw,
                          o + h * w + ch * cw).reshape(ch, cw)
        frames.append([y.copy(), u.copy(), v.copy()])
    return frames


def evaluate(cfg: SeqConfig, clip: bytes, frames) -> tuple[float, dict]:
    dec = GoldenDecoder(cfg)
    pl = NativePlanner(cfg)
    disp = {}
    modes = {"weight": 0, "aot": 0, "raw": 0, "inter_k0": 0, "inter_res": 0}
    for r in Demuxer(clip).video_records():
        plan = pl.plan_frame(r.frame_char, r.payload)
        disp[plan.display_id] = dec.decode(plan)
        for p in plan.planes:
            intra = p.cls == 0
            modes["weight"] += int((intra & (p.mode == 0)).sum())
            modes["aot"] += int((intra & (p.mode >= 1) & (p.mode <= 4)).sum())
            modes["raw"] += int((intra & (p.mode == 6)).sum())
            modes["inter_k0"] += int(((p.cls == 1) & (p.mode == 0)).sum())
            modes["inter_res"] += int(((p.cls == 1) & (p.mode > 0)).sum())
    err = npix = 0.0
    for t, f in enumerate(frames):
        for got, want in zip(disp[t], f):
            err += float(((got.astype(np.int64)
                           - want.astype(np.int64)) ** 2).sum())
            npix += want.size
    mse = err / npix
    psnr = 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    return psnr, modes


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--gops", default="IPBPB,IPP")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lambdas", default="1,2,4,8,16")
    ap.add_argument("--yuv", default=None)
    ap.add_argument("--tpu-search", action="store_true",
                    help="score every nest candidate on --device")
    ap.add_argument("--device", default="cuda",
                    help="the search's torch device (default: cuda)")
    args = ap.parse_args()

    if args.tpu_search:
        from hvqm4_tpu_torch.encode_tpu import search_device

        try:
            search_device(args.device)  # no card: one line, exit 1
        except (RuntimeError, ValueError) as e:
            raise SystemExit(f"rd_sweep_torch.py: {e}")
    cfg = SeqConfig(args.width, args.height)
    gops = args.gops.split(",")
    n = sum(len(g) for g in gops)
    frames = (load_yuv(args.yuv, cfg, n) if args.yuv
              else synth_frames(cfg, n, args.seed))
    if len(frames) < n:
        raise SystemExit(f"need {n} frames, got {len(frames)}")

    npix = sum(p.size for p in frames[0]) * len(frames)
    print(f"{'lambda':>7} {'bytes':>8} {'bpp':>6} {'psnr_db':>8}  modes")
    for lam in [float(x) for x in args.lambdas.split(",")]:
        enc = VideoEncoder(cfg, lambda_bits=lam, seed=args.seed,
                           use_tpu_search=args.tpu_search, device=args.device)
        clip = enc.encode(frames, gops)
        psnr, modes = evaluate(cfg, clip, frames)
        bpp = 8.0 * len(clip) / npix
        mstr = " ".join(f"{k}={v}" for k, v in modes.items() if v)
        print(f"{lam:7.1f} {len(clip):8d} {bpp:6.3f} {psnr:8.2f}  {mstr}")


if __name__ == "__main__":
    main()
