"""Command line for the PyTorch port.

    python -m hvqm4_tpu_torch.cli info    clip.h4m
    python -m hvqm4_tpu_torch.cli decode  clip.h4m [out.yuv] [--device cuda]
                                          [--start-block K | --start-time SEC]
                                          [--frames N] [--display-order]
                                          [--profile] [--ppm DIR] [--y4m]
    python -m hvqm4_tpu_torch.cli decode  clip.h4m [out.yuv] --gop-parallel
    python -m hvqm4_tpu_torch.cli hash    clip.h4m [--device cuda]
    python -m hvqm4_tpu_torch.cli verify  clip.h4m [--device cuda] [--batched]
    python -m hvqm4_tpu_torch.cli audio   clip.h4m out.wav
    python -m hvqm4_tpu_torch.cli stats   clip.h4m      # mode histograms
    python -m hvqm4_tpu_torch.cli remote  HOST:PORT clip.h4m [out]
                                          [--mode yuv|rgb|embed] [--token T]
                                          [--timeout SEC]
    python -m hvqm4_tpu_torch.cli remote  HOST:PORT --metrics [--prometheus]

`decode --gop-parallel` decodes the clip's GOP blocks as parallel streams
of the arena `MultiStreamDecoder`; `verify --batched` checks that decoder
on one stream through on-device checksums against `oracle --csum`.
`remote` is the client of the decode service (`python -m
hvqm4_tpu_torch.serve`).

`--device` defaults to `cuda`. Without a card the command fails with a
one-line error; it never falls back to the CPU. `--device cpu` runs the
plain PyTorch path on purpose. `info`, `audio`, `stats` and `remote` use no
device and take no `--device`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from fractions import Fraction
from pathlib import Path

import torch

from . import refdec
from .audio import decode_record, records_to_wav
from .container import ContainerError, Demuxer
from .native import PlannerError
from .ops.csc import frame_to_rgb
from .parallel.multistream import MultiStreamDecoder, decode_clip_gop_parallel
from .session import DecoderSession
from .utils.hashing import batch_csum, fnv1a, frame_csum, oracle_csums
from .utils.stats import clip_stats

PROG = "hvqm4_tpu_torch"
_ORACLE = Path(__file__).resolve().parent.parent / "oracle" / "hvqm4_oracle"
_Y4M_CHROMA = {(2, 2): "420jpeg", (2, 1): "422", (1, 1): "444"}


class DeviceError(RuntimeError):
    """The requested device is not available."""


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceError(f"device {name!r} requested but CUDA is not "
                          f"available (use --device cpu for the plain path)")
    if dev.type not in ("cuda", "cpu"):
        raise DeviceError(f"unsupported device {name!r}")
    return dev


def cmd_info(args) -> int:
    d = Demuxer(Path(args.clip).read_bytes())
    i = d.info
    c = i.cfg
    print(f"HVQM4 {c.version}  {c.width}x{c.height} "
          f"{'4:2:0' if c.h_samp == 2 else '4:4:4'}")
    print(f"blocks={i.block_count} video_frames={i.video_frames} "
          f"audio_frames={i.audio_frames}")
    fps = 1e6 / i.usec_per_frame if i.usec_per_frame else 0
    print(f"usec_per_frame={i.usec_per_frame} ({fps:.2f} fps)")
    if i.audio_channels:
        print(f"audio: {i.audio_channels}ch {i.audio_sample_rate} Hz IMA-ADPCM")
    return 0


def _y4m_header(info) -> bytes:
    """YUV4MPEG2 stream header for this clip's geometry and frame rate."""
    chroma = _Y4M_CHROMA.get((info.cfg.h_samp, info.cfg.v_samp))
    if chroma is None:
        raise ValueError(
            f"chroma sampling {info.cfg.h_samp}x{info.cfg.v_samp} has no "
            f"Y4M equivalent")
    fps = Fraction(1_000_000, info.usec_per_frame)
    return (f"YUV4MPEG2 W{info.cfg.width} H{info.cfg.height} "
            f"F{fps.numerator}:{fps.denominator} Ip A1:1 "
            f"C{chroma}\n").encode()


def cmd_decode(args) -> int:
    dev = _device(args.device)
    data = Path(args.clip).read_bytes()
    demux = Demuxer(data)
    cfg = demux.info.cfg
    if args.start_time is not None:
        if args.start_block:
            print(f"{PROG}: error: --start-time and --start-block are "
                  f"mutually exclusive", file=sys.stderr)
            return 1
        args.start_block = demux.block_for_time(args.start_time)
    if args.gop_parallel:
        return _decode_gop_parallel(args, data, dev)
    sess = DecoderSession(cfg, dev, profile=args.profile)
    if args.y4m:
        # a presentation container: frames in display order, to the output
        # path or to stdout for `| mpv -`
        args.display_order = True
        out = open(args.output, "wb") if args.output else sys.stdout.buffer
        out.write(_y4m_header(demux.info))
    else:
        out = open(args.output or os.devnull, "wb")
    it = (sess.decode_clip_display_order(data, start_block=args.start_block)
          if args.display_order else
          sess.decode_clip(data, start_block=args.start_block))
    n = 0
    try:
        for frame in it:
            if args.frames is not None and n >= args.frames:
                break
            if args.y4m:
                out.write(b"FRAME\n")
            out.write(frame.yuv_bytes())
            if args.ppm:
                _write_ppm(frame, cfg, Path(args.ppm) / f"frame{n:05d}.ppm")
            n += 1
    finally:
        if out is sys.stdout.buffer:
            out.flush()
        else:
            out.close()
    print(f"decoded {n} frames on {dev}", file=sys.stderr)
    if args.profile:
        print(sess.timer.report(), file=sys.stderr)
    return 0


def _decode_gop_parallel(args, data: bytes, dev) -> int:
    """`decode --gop-parallel`: the clip's GOP blocks as parallel streams,
    whole clip, decode order, raw YUV; the flags it would otherwise ignore
    are refused."""
    for flag, name in ((args.ppm, "--ppm"),
                       (args.start_block, "--start-block"),
                       (args.start_time is not None, "--start-time"),
                       (args.display_order, "--display-order"),
                       (args.y4m, "--y4m"),
                       (args.frames is not None, "--frames"),
                       (args.profile, "--profile")):
        if flag:
            print(f"{PROG}: error: {name} is not supported with "
                  f"--gop-parallel", file=sys.stderr)
            return 1
    n = 0
    with open(args.output or os.devnull, "wb") as out:
        for _bi, yuv in decode_clip_gop_parallel(data, dev):
            out.write(yuv)
            n += 1
    print(f"decoded {n} frames on {dev} (gop-parallel)", file=sys.stderr)
    return 0


def _write_ppm(frame, cfg, path: Path) -> None:
    """One frame as a binary PPM, converted on the frame's device."""
    rgb = frame_to_rgb(frame.planes, cfg.h_samp, cfg.v_samp).cpu().numpy()
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (rgb.shape[1], rgb.shape[0]))
        f.write(rgb.tobytes())


def cmd_hash(args) -> int:
    """Per-frame FNV-1a hashes in the oracle's --hash format."""
    dev = _device(args.device)
    data = Path(args.clip).read_bytes()
    sess = DecoderSession(Demuxer(data).info.cfg, dev)
    for i, frame in enumerate(sess.decode_clip(data)):
        print(f"frame {i} {frame.ftype} disp={frame.display_id} "
              f"hash={fnv1a(frame.yuv_bytes()):08x}")
    return 0


def cmd_verify(args) -> int:
    """Decode with the NumPy golden model and the torch port (and the C
    oracle when built) and compare byte for byte; with `--batched`, check
    the arena decoder through on-device checksums instead."""
    dev = _device(args.device)
    data = Path(args.clip).read_bytes()
    cfg = Demuxer(data).info.cfg
    if args.batched:
        return _verify_batched(cfg, data, Path(args.clip), dev)
    golden = [b"".join(p.tobytes() for p in planes)
              for planes in refdec.decode_clip(cfg, data)]
    got = [f.yuv_bytes() for f in DecoderSession(cfg, dev).decode_clip(data)]
    ok = golden == got
    print(f"numpy vs torch[{dev}] ({len(got)} frames): "
          f"{'MATCH' if ok else 'MISMATCH'}")
    if _ORACLE.exists():
        with tempfile.TemporaryDirectory() as td:
            out = Path(td) / "c.yuv"
            subprocess.run([str(_ORACLE), args.clip, str(out)], check=True)
            oracle_ok = out.read_bytes() == b"".join(got)
        print(f"torch[{dev}] vs C oracle: "
              f"{'MATCH' if oracle_ok else 'MISMATCH'}")
        ok = ok and oracle_ok
    else:
        print("C oracle not built (make -C oracle) — skipped")
    return 0 if ok else 1


def _verify_batched(cfg, data: bytes, clip_path: Path, dev) -> int:
    """The arena `MultiStreamDecoder` on one stream, every frame's
    checksum taken on the device (4 bytes a frame leave it), against
    `oracle --csum`, or against the NumPy golden model when the oracle is
    not built."""
    if _ORACLE.exists():
        golden = "C oracle"
        want = oracle_csums(_ORACLE, clip_path)
    else:
        golden = "NumPy golden"
        want = [f"{int(frame_csum([torch.from_numpy(p) for p in planes])):08x}"
                for planes in refdec.decode_clip(cfg, data)]
    ms = MultiStreamDecoder(cfg, [data], dev)
    got = [f"{int(batch_csum(*frames)[0]):08x}"
           for frames, _metas, valid in ms.run_pipelined() if valid[0]]
    ok = got == want
    print(f"batched decode on {dev} vs {golden} ({len(want)} frames, "
          f"on-device checksum): {'MATCH' if ok else 'MISMATCH'}")
    return 0 if ok else 1


def cmd_audio(args) -> int:
    d = Demuxer(Path(args.clip).read_bytes())
    ch = d.info.audio_channels
    if not ch:
        print("no audio in clip", file=sys.stderr)
        return 1
    recs = [decode_record(r.payload, ch) for r in d.audio_records()]
    records_to_wav(recs, d.info.audio_sample_rate, args.output)
    print(f"wrote {args.output}", file=sys.stderr)
    return 0


def cmd_stats(args) -> int:
    print(clip_stats(Path(args.clip).read_bytes()))
    return 0


def cmd_remote(args) -> int:
    """Client for the decode service (`python -m hvqm4_tpu_torch.serve`)."""
    from . import serve  # it imports this module

    host, _, port_s = args.server.rpartition(":")
    if not host or not port_s.isdigit() or not 1 <= int(port_s) <= 65535:
        print(f"{PROG}: error: server must be HOST:PORT (port 1-65535)",
              file=sys.stderr)
        return 1
    port = int(port_s)
    try:
        if args.metrics:
            if args.clip or args.output:
                print(f"{PROG}: error: --metrics takes no clip/output",
                      file=sys.stderr)
                return 1
            if args.prometheus:
                (raw,) = serve.decode_remote(host, port, b"",
                                             mode=serve.MODE_METRICS_PROM,
                                             token=args.token)
                sys.stdout.write(raw.decode())
            else:
                print(json.dumps(serve.fetch_metrics(host, port,
                                                     token=args.token),
                                 indent=2))
            return 0
        if not args.clip:
            print(f"{PROG}: error: clip required unless --metrics",
                  file=sys.stderr)
            return 1
        mode = {"yuv": serve.MODE_YUV, "rgb": serve.MODE_RGB,
                "embed": serve.MODE_EMBED}[args.mode]
        chunks = serve.decode_remote(host, port,
                                     Path(args.clip).read_bytes(),
                                     mode=mode, timeout=args.timeout,
                                     token=args.token)
    except (serve.BusyError, RuntimeError, PermissionError,
            ConnectionError) as e:
        print(f"{PROG}: error: {e}", file=sys.stderr)
        return 1
    if args.output:
        with open(args.output, "wb") as f:
            for c in chunks:
                f.write(c)
    what = "embeddings" if args.mode == "embed" else "frames"
    print(f"received {len(chunks)} {what} "
          f"({sum(map(len, chunks))} bytes)", file=sys.stderr)
    return 0


# subcommands that use no device and take no --device
_HOST_ONLY = (cmd_info, cmd_audio, cmd_stats, cmd_remote)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info")
    p.add_argument("clip")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("decode")
    p.add_argument("clip")
    p.add_argument("output", nargs="?")
    p.add_argument("--start-block", type=int, default=0)
    p.add_argument("--start-time", type=float, metavar="SEC",
                   help="seek to the GOP block containing this time")
    p.add_argument("--frames", type=int, metavar="N",
                   help="stop after N frames")
    p.add_argument("--display-order", action="store_true",
                   help="emit frames in presentation order (default: decode order)")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--ppm", metavar="DIR",
                   help="also write each frame as RGB .ppm into DIR")
    p.add_argument("--y4m", action="store_true",
                   help="write YUV4MPEG2 instead of raw YUV (to OUTPUT, or "
                        "stdout; implies --display-order)")
    p.add_argument("--gop-parallel", action="store_true",
                   help="batch independent GOP blocks as parallel streams")
    p.set_defaults(fn=cmd_decode)

    p = sub.add_parser("hash")
    p.add_argument("clip")
    p.set_defaults(fn=cmd_hash)

    p = sub.add_parser("verify")
    p.add_argument("clip")
    p.add_argument("--batched", action="store_true",
                   help="check the batched arena path via on-device "
                        "checksums (4 bytes a frame leave the device)")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("audio")
    p.add_argument("clip")
    p.add_argument("output")
    p.set_defaults(fn=cmd_audio)

    p = sub.add_parser("stats")
    p.add_argument("clip")
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser("remote")
    p.add_argument("server", help="decode-service address HOST:PORT")
    p.add_argument("clip", nargs="?")
    p.add_argument("output", nargs="?")
    p.add_argument("--mode", default="yuv", choices=["yuv", "rgb", "embed"])
    p.add_argument("--token", default="", help="shared auth token")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--metrics", action="store_true",
                   help="fetch the server metrics snapshot instead")
    p.add_argument("--prometheus", action="store_true",
                   help="with --metrics: Prometheus text format")
    p.set_defaults(fn=cmd_remote)

    for p in sub.choices.values():
        if p.get_default("fn") not in _HOST_ONLY:
            p.add_argument("--device", default="cuda",
                           help="torch device (default: cuda)")

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    # user-input and environment errors print one line, not a traceback
    except BrokenPipeError:
        # the downstream pipe closed early (`... | head`): die silently, as
        # Unix tools do; devnull over stdout so the interpreter's flush at
        # shutdown cannot raise again
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 141  # 128 + SIGPIPE, as for a process the shell killed
    except (DeviceError, ContainerError, PlannerError, OSError) as e:
        print(f"{PROG}: error: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        # torch and numpy raise ValueError on internal shape bugs too: only
        # one raised by this package's own code gets the one-liner, anything
        # else keeps its traceback
        tb = e.__traceback__
        while tb is not None and tb.tb_next is not None:
            tb = tb.tb_next
        mod = tb.tb_frame.f_globals.get("__name__", "") if tb else ""
        if not mod.startswith("hvqm4_tpu_torch"):
            raise
        print(f"{PROG}: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
