"""End-to-end demo of the PyTorch port: encode → decode on the card → ViT
embeddings. The counterpart of `examples/end_to_end.py`; it imports only
`hvqm4_tpu_torch`.

    python examples/end_to_end_torch.py [--width 128 --height 96 --frames 10]
                                        [--device cuda|cpu] [--out clip.h4m]

Walks the port's surface:
1. synthesize a moving-pattern video
2. encode it to `.h4m` with the content-aware encoder (mode decision,
   half-pel motion search, B frames), every nest candidate scored on the
   device (`VideoEncoder(use_tpu_search=True)`)
3. decode it through `DecoderSession` on the device
4. check every decoded frame against the C oracle (built with
   `make -C oracle` when it is missing) and against the NumPy golden decoder
5. convert to RGB on the device and run the ViT feed through
   `VideoEmbedPipeline`, printing embedding stats

`--device` defaults to `cuda`; without a card the script fails. `--device
cpu` runs the plain PyTorch paths on purpose.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from hvqm4_tpu_torch import refdec  # noqa: E402
from hvqm4_tpu_torch.config import SeqConfig  # noqa: E402
from hvqm4_tpu_torch.encode import VideoEncoder  # noqa: E402
from hvqm4_tpu_torch.models.vit import ViTConfig  # noqa: E402
from hvqm4_tpu_torch.pipeline import VideoEmbedPipeline  # noqa: E402
from hvqm4_tpu_torch.session import DecoderSession  # noqa: E402
from hvqm4_tpu_torch.utils.hashing import fnv1a  # noqa: E402


def synth_video(cfg: SeqConfig, n: int):
    h, w = cfg.plane_shapes[0]
    ch, cw = cfg.plane_shapes[1]
    frames = []
    for t in range(n):
        yy, xx = np.mgrid[0:h, 0:w]
        y = (96 + 60 * np.sin(0.05 * xx + 0.3 * t) * np.cos(0.07 * yy))
        x0, y0 = (8 + 4 * t) % (w - 20), (6 + 3 * t) % (h - 20)
        y[y0:y0 + 20, x0:x0 + 20] = 235
        u = np.full((ch, cw), 96 + 8 * (t % 4), np.uint8)
        v = np.full((ch, cw), 150, np.uint8)
        frames.append([np.clip(y, 0, 255).astype(np.uint8), u, v])
    return frames


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=str(REPO / "build" / "e2e_demo.h4m"))
    args = ap.parse_args()

    cfg = SeqConfig(args.width, args.height)
    frames = synth_video(cfg, args.frames)
    pattern = "I" + "BP" * ((args.frames - 1) // 2) + "P" * ((args.frames - 1) % 2)
    print(f"encoding {args.frames} frames ({pattern}), nest search on "
          f"{args.device} ...")
    t0 = time.time()
    clip = VideoEncoder(cfg, lambda_bits=2.0, use_tpu_search=True,
                        device=args.device).encode(frames, [pattern])
    raw = cfg.frame_bytes * args.frames
    print(f"  {len(clip)} bytes ({raw / len(clip):.1f}x vs raw) "
          f"in {time.time() - t0:.1f}s")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_bytes(clip)

    print(f"decoding on {args.device} ...")
    t0 = time.time()
    got = [f"{fnv1a(f.yuv_bytes()):08x}"
           for f in DecoderSession(cfg, args.device).decode_clip(clip)]
    print(f"  {len(got)} frames in {time.time() - t0:.1f}s")
    golden = [f"{fnv1a(b''.join(p.tobytes() for p in planes)):08x}"
              for planes in refdec.decode_clip(cfg, clip)]
    if got != golden:
        raise SystemExit("the device decode DIVERGES from the golden decoder "
                         "on this clip")
    subprocess.run(["make", "-s", "-C", str(REPO / "oracle")], check=True)
    r = subprocess.run([str(REPO / "oracle" / "hvqm4_oracle"), "--hash",
                        str(out), "/dev/null"], capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"C oracle failed: {r.stderr.strip()[:200]}")
    want = [ln.split("hash=")[1] for ln in r.stdout.splitlines()
            if "hash=" in ln]
    if got != want:
        raise SystemExit("the device decode DIVERGES from the C oracle on "
                         "this clip")
    print(f"  C oracle decoded {len(want)} frames; its hashes match the "
          f"device decode and the golden decoder")

    print(f"decoding + embedding on {args.device} ...")
    pipe = VideoEmbedPipeline(
        cfg, [clip], ViTConfig(image_size=96, patch_size=8, dim=192,
                               depth=4, heads=6), device=args.device)
    t0 = time.time()
    embs = [e.cpu().numpy()[0] for e, _m, v in pipe.run() if v[0]]
    if not embs:
        raise SystemExit("no frames decoded")
    if not all(np.isfinite(e).all() for e in embs):
        raise SystemExit("an embedding is not finite")
    print(f"  {len(embs)} embeddings of dim {embs[0].shape[0]} "
          f"in {time.time() - t0:.1f}s on {args.device}")
    sims = [float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))
            for a, b in zip(embs, embs[1:])]
    if sims:
        print(f"  adjacent-frame cosine similarity: "
              f"min {min(sims):.3f} max {max(sims):.3f}")


if __name__ == "__main__":
    main()
