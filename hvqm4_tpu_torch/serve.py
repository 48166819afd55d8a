"""Decode service on the card: the port of `hvqm4_tpu/serve.py`.

The wire protocol, admission and ingress bounds, auth, multiplexed
sessions, metrics and the clients are the JAX package's, reused through
`host.BaseDecodeServer` (they import no JAX). This module supplies the
device half: the port's `DecoderSession` per sequence shape, YUV→RGB
through the CUDA kernel, resize and the ViT.

    python -m hvqm4_tpu_torch.serve --port 8907 [--device cuda]
                                    [--auth-token T] [--max-pending K] ...
    python -m hvqm4_tpu.cli remote 127.0.0.1:8907 clip.h4m out.rgb --mode rgb

Continuous batching (`--batch-window-ms`) needs the arena
`MultiStreamDecoder`, which the port does not have yet, so a window above
0 is refused and `--max-batch` is not a flag. Requests decode on handler
and mux worker threads, one at a time under the base server's lock; each
`.cpu()` in `_chunks` is the point where a reply waits for the card, and a
CUDA error there becomes that request's error reply.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

import torch

from .cli import DeviceError, _device
from .host import (MODE_EMBED, MODE_METRICS, MODE_METRICS_PROM,  # noqa: F401
                   MODE_RGB, MODE_YUV, STATUS_AUTH, STATUS_BUSY,
                   STATUS_ERROR, STATUS_OK, BaseDecodeServer, BusyError,
                   MuxClient, decode_remote, fetch_metrics)
from .models.vit import ViTConfig, init_vit
from .ops.csc import frame_to_rgb, resize_bilinear
from .session import DecoderSession

PROG = "hvqm4_tpu_torch.serve"


class DecodeServer(BaseDecodeServer):
    """The JAX package's decode service with the port's device half on
    `device`. Fails at construction when the device is not available."""

    def __init__(self, addr, device="cuda", *, max_clip_bytes: int = 256 << 20,
                 vit_cfg: ViTConfig | None = None,
                 auth_token: bytes | str = b"", max_pending: int = 8,
                 max_pixels: int = 4096 * 4096, max_sessions: int = 16,
                 socket_timeout_s: float = 120.0, mux_workers: int = 4):
        self.device = _device(str(device))
        super().__init__(addr, backend="torch", max_clip_bytes=max_clip_bytes,
                         vit_cfg=vit_cfg, auth_token=auth_token,
                         max_pending=max_pending, max_pixels=max_pixels,
                         max_sessions=max_sessions,
                         socket_timeout_s=socket_timeout_s,
                         batch_window_s=0.0, mux_workers=mux_workers)

    def _session(self, cfg) -> DecoderSession:
        if cfg in self._sessions:
            self._sessions.move_to_end(cfg)  # LRU refresh
        else:
            # a client can present arbitrarily many distinct (valid) shapes
            while len(self._sessions) >= self._max_sessions:
                self._sessions.popitem(last=False)
            self._sessions[cfg] = DecoderSession(cfg, self.device)
        return self._sessions[cfg]

    def _chunks(self, frames, cfg, mode) -> list[bytes]:
        """Per-frame plane lists (decode order) → mode-specific wire chunks."""
        if mode == MODE_YUV:
            return [b"".join(p.cpu().numpy().tobytes() for p in planes)
                    for planes in frames]
        if mode == MODE_RGB:
            return [frame_to_rgb(planes, cfg.h_samp, cfg.v_samp)
                    .cpu().numpy().tobytes() for planes in frames]
        # MODE_EMBED
        if self._vit is None:
            vcfg = self._vit_cfg or ViTConfig()
            self._vit = (vcfg, init_vit(vcfg, torch.Generator().manual_seed(0),
                                        self.device))
        vcfg, model = self._vit
        out = []
        with torch.inference_mode():
            for planes in frames:
                rgb = frame_to_rgb(planes, cfg.h_samp, cfg.v_samp)
                img = resize_bilinear(rgb, vcfg.image_size, vcfg.image_size)
                emb = model(img[None])
                out.append(emb[0].cpu().numpy().astype("<f4").tobytes())
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8907)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu is the plain path)")
    ap.add_argument("--auth-token", default="",
                    help="require this shared token on every request")
    ap.add_argument("--max-pending", type=int, default=8,
                    help="queued requests beyond the active one before "
                         "shedding with status=busy")
    ap.add_argument("--max-pixels", type=int, default=4096 * 4096,
                    help="reject clips whose header declares more than this "
                         "many pixels per frame")
    ap.add_argument("--max-sessions", type=int, default=16,
                    help="LRU cap on cached per-shape decoder sessions")
    ap.add_argument("--socket-timeout", type=float, default=120.0,
                    help="per-connection socket timeout in seconds")
    ap.add_argument("--batch-window-ms", type=float, default=0.0,
                    help="continuous batching; not ported: only 0 (off)")
    ap.add_argument("--mux-workers", type=int, default=4,
                    help="per-connection decode concurrency for multiplexed "
                         "('H4MX') sessions")
    args = ap.parse_args(argv)
    if args.batch_window_ms > 0:
        print(f"{PROG}: error: --batch-window-ms needs the arena "
              f"MultiStreamDecoder, which the port does not have yet",
              file=sys.stderr)
        return 1
    try:
        srv = DecodeServer((args.host, args.port), device=args.device,
                           auth_token=args.auth_token,
                           max_pending=args.max_pending,
                           max_pixels=args.max_pixels,
                           max_sessions=args.max_sessions,
                           socket_timeout_s=args.socket_timeout,
                           mux_workers=args.mux_workers)
    except (DeviceError, OSError) as e:
        print(f"{PROG}: error: {e}", file=sys.stderr)
        return 1
    # shutdown() must not run on the thread blocked in serve_forever(), and
    # signal handlers run on the main thread: hand it to a helper thread
    signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
        target=srv.shutdown, daemon=True).start())
    print(f"{PROG}: decode service on {args.host}:{args.port} "
          f"(device={srv.device}, auth={'on' if args.auth_token else 'off'})",
          file=sys.stderr)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
