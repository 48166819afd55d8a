"""Config-5 throughput on the port: .h4m streams → ViT embeddings, fps.

The counterpart of `scripts/bench_embed.py`: `VideoEmbedPipeline`
(multi-stream decode → YUV→RGB → resize → ViT at batch N, every pixel on
the device) end to end, host planning overlapped. One warm-up run, then
one timed run; on the card the clock stops after `torch.cuda.synchronize()`.

    python scripts/bench_embed_torch.py [n_streams] [--clip PATH]
                                        [--image-size 224] [--device cuda|cpu]

Prints ONE JSON line: the JAX script's keys, with `device` and `card` (the
card's name and power limit as nvidia-smi gives them; null on the CPU) in
place of its `backend`. `--device` defaults to `cuda`; without a card the
script fails.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def card_line(device) -> str | None:
    """nvidia-smi's name and power limit of the card, None off the card."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("n_streams", type=int, nargs="?", default=8)
    ap.add_argument("--clip", default=str(REPO / "testdata" /
                                          "retail640.h4m"))
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args()

    from hvqm4_tpu_torch.container import Demuxer
    from hvqm4_tpu_torch.models.vit import ViTConfig
    from hvqm4_tpu_torch.pipeline import VideoEmbedPipeline

    clip = pathlib.Path(args.clip).read_bytes()
    cfg = Demuxer(clip).info.cfg
    vcfg = ViTConfig(image_size=args.image_size)

    def run() -> tuple[int, float]:
        pipe = VideoEmbedPipeline(cfg, [clip] * args.n_streams, vcfg,
                                  device=args.device)
        sync(args.device)
        t0 = time.perf_counter()
        frames = sum(sum(valid) for _emb, _metas, valid in pipe.run())
        sync(args.device)
        return frames, time.perf_counter() - t0

    run()  # warm-up: allocator, pinned ring, first launches
    frames, dt = run()
    print(json.dumps({
        "config": "decode->rgb->resize->vit_embed",
        "streams": args.n_streams,
        "clip": args.clip,
        "vit": f"{vcfg.dim}d x{vcfg.depth} p{vcfg.patch_size} "
               f"{vcfg.image_size}px",
        "frames": frames,
        "embed_fps": round(frames / dt, 1),
        "device": args.device,
        "card": card_line(args.device),
    }))


if __name__ == "__main__":
    main()
