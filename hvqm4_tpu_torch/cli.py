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
    python -m hvqm4_tpu_torch.cli encode  in.yuv|in.y4m out.h4m
                                          [--width W --height H]
                                          [--sampling 420|444] [--gops IPPP,IBPBP]
                                          [--quality L] [--slices S]
                                          [--dc-shift D] [--psy P] [--audio a.wav]
                                          [--target-kb KB [--single-pass]]
    python -m hvqm4_tpu_torch.cli transcode clip.h4m out.h4m [--device cuda]
                                          [--quality L | --target-kb KB]
                                          [--gops ...] [--slices S] [--dc-shift D]

`decode --gop-parallel` decodes the clip's GOP blocks as parallel streams
of the arena `MultiStreamDecoder`; `verify --batched` checks that decoder
on one stream through on-device checksums against `oracle --csum`.
`remote` is the client of the decode service (`python -m
hvqm4_tpu_torch.serve`). `encode` turns raw planar YUV or a YUV4MPEG2 stream
into an `.h4m` clip on the host; `transcode` decodes a clip on `--device` and
encodes it again at another quality or size (audio carried through).

`--device` defaults to `cuda`. Without a card the command fails with a
one-line error; it never falls back to the CPU. `--device cpu` runs the
plain PyTorch path on purpose. `info`, `audio`, `stats`, `remote` and
`encode` use no device and take no `--device`.
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

import numpy as np
import torch

from . import refdec
from .audio import decode_record, records_to_wav
from .config import SeqConfig
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


def _default_gops(n: int) -> list[str]:
    """12-frame I+P GOP blocks covering n frames."""
    gops = []
    left = n
    while left > 0:
        g = min(12, left)
        gops.append("I" + "P" * (g - 1))
        left -= g
    return gops


def cmd_transcode(args) -> int:
    """Decode a clip and re-encode it at a new quality / size (audio
    remuxed through IMA-ADPCM when present)."""
    from .encode import VideoEncoder, encode_to_size

    dev = _device(args.device)
    data = Path(args.clip).read_bytes()
    d = Demuxer(data)
    cfg = d.info.cfg
    sess = DecoderSession(cfg, dev)
    # the encoder takes display-ordered frames
    frames = [f.to_numpy() for f in sess.decode_clip_display_order(data)]
    gops = args.gops.split(",") if args.gops else _default_gops(len(frames))
    audio = None
    audio_rate = 32000
    if d.info.audio_channels:
        recs = [decode_record(r.payload, d.info.audio_channels)
                for r in d.audio_records()]
        if recs:
            audio = np.concatenate(recs)
            audio_rate = d.info.audio_sample_rate
    if args.target_kb is not None:
        if audio is not None:
            print(f"{PROG}: error: --target-kb transcode is video-only "
                  "(source has audio; use --quality)", file=sys.stderr)
            return 1
        out, lam = encode_to_size(cfg, frames, gops,
                                  int(args.target_kb * 1024),
                                  slices=args.slices,
                                  dc_shift=args.dc_shift,
                                  usec_per_frame=d.info.usec_per_frame)
        print(f"rate control: lambda={lam:.3f}", file=sys.stderr)
    else:
        out = VideoEncoder(cfg, lambda_bits=args.quality, slices=args.slices,
                           dc_shift=args.dc_shift).encode(
            frames, gops, usec_per_frame=d.info.usec_per_frame,
            audio=audio, audio_rate=audio_rate)
    Path(args.output).write_bytes(out)
    print(f"transcoded {len(frames)} frames: {len(data)} -> {len(out)} bytes"
          f" ({len(out) / max(len(data), 1):.2f}x)", file=sys.stderr)
    return 0


_Y4M_SAMP = {"420jpeg": 2, "420mpeg2": 2, "420paldv": 2, "420": 2, "444": 1}


def _parse_y4m(data: bytes):
    """YUV4MPEG2 stream → (width, height, samp, usec_per_frame, frames).

    Self-describing encoder input (the inverse of decode --y4m): geometry,
    chroma sampling, and frame rate come from the stream header, so
    `ffmpeg -i anything -f yuv4mpegpipe` feeds the encoder directly.
    Chroma siting tags (jpeg/mpeg2/paldv) are accepted as plain 4:2:0."""
    nl = data.find(b"\n")
    if nl < 0:
        raise ValueError("truncated y4m header")
    fields = data[:nl].decode("ascii", "replace").split()
    w = h = None
    num, den = 30000, 1001
    chroma = "420jpeg"
    for f in fields[1:]:
        tag, val = f[:1], f[1:]
        try:
            if tag == "W":
                w = int(val)
            elif tag == "H":
                h = int(val)
            elif tag == "F":
                num, den = map(int, val.split(":"))
            elif tag == "C":
                chroma = val
        except ValueError:
            raise ValueError(f"bad y4m header field {f!r}") from None
    samp = _Y4M_SAMP.get(chroma)
    if samp is None:
        raise ValueError(f"unsupported y4m chroma C{chroma} "
                         f"(supported: {'/'.join(sorted(_Y4M_SAMP))})")
    if not w or not h or w <= 0 or h <= 0 or num <= 0 or den <= 0:
        raise ValueError("y4m header missing/invalid W/H/F")
    cfg = SeqConfig(w, h, samp, samp)
    shapes, fb = cfg.plane_shapes, cfg.frame_bytes
    frames = []
    off = nl + 1
    while off < len(data):
        fnl = data.find(b"\n", off)
        if fnl < 0 or not data[off:fnl].startswith(b"FRAME"):
            raise ValueError(f"bad y4m FRAME marker at byte {off}")
        off = fnl + 1
        if off + fb > len(data):
            raise ValueError("truncated y4m frame payload")
        planes, poff = [], off
        for ph, pw in shapes:
            planes.append(np.frombuffer(data, np.uint8,
                                        ph * pw, poff).reshape(ph, pw))
            poff += ph * pw
        frames.append(planes)
        off += fb
    return w, h, samp, round(1_000_000 * den / num), frames


def cmd_encode(args) -> int:
    """Raw planar YUV or YUV4MPEG2 → `.h4m`, on the host."""
    from .encode import VideoEncoder

    raw = Path(args.input).read_bytes()
    usec = 33366
    if raw.startswith(b"YUV4MPEG2"):
        try:
            w, h, samp, usec, frames = _parse_y4m(raw)
        except ValueError as e:
            print(f"{PROG}: error: {e}", file=sys.stderr)
            return 1
        if (args.width is not None and args.width != w) or \
           (args.height is not None and args.height != h):
            print(f"{PROG}: error: --width/--height conflict with the "
                  f"y4m header ({w}x{h})", file=sys.stderr)
            return 1
        if args.sampling is not None and \
                args.sampling != ("420" if samp == 2 else "444"):
            print(f"{PROG}: error: --sampling conflicts with the y4m "
                  f"header chroma", file=sys.stderr)
            return 1
        cfg = SeqConfig(w, h, samp, samp)
        n = len(frames)
    else:
        if args.width is None or args.height is None:
            print(f"{PROG}: error: --width/--height are required for raw "
                  "YUV input (or feed a .y4m stream)", file=sys.stderr)
            return 1
        samp = 2 if (args.sampling or "420") == "420" else 1
        cfg = SeqConfig(args.width, args.height, samp, samp)
        fb = cfg.frame_bytes
        if len(raw) % fb:
            print(f"{PROG}: error: input not a multiple of {fb} bytes",
                  file=sys.stderr)
            return 1
        n = len(raw) // fb
        shapes = cfg.plane_shapes
        frames = []
        for i in range(n):
            off = i * fb
            planes = []
            for h, w in shapes:
                planes.append(
                    np.frombuffer(raw, np.uint8, h * w, off).reshape(h, w))
                off += h * w
            frames.append(planes)
    gops = args.gops.split(",") if args.gops else _default_gops(n)
    enc = VideoEncoder(cfg, lambda_bits=args.quality, slices=args.slices,
                       dc_shift=args.dc_shift, psy=args.psy)
    audio = None
    audio_rate = 32000
    if args.audio:
        import wave

        with wave.open(args.audio, "rb") as w:
            if w.getsampwidth() != 2:
                print(f"{PROG}: error: audio must be 16-bit PCM WAV",
                      file=sys.stderr)
                return 1
            audio_rate = w.getframerate()
            audio = np.frombuffer(
                w.readframes(w.getnframes()), np.int16
            ).reshape(-1, w.getnchannels())
    if args.target_kb is not None:
        from .encode import encode_to_size

        if audio is not None:
            print(f"{PROG}: error: --target-kb does not support --audio "
                  "yet (video-only rate control)", file=sys.stderr)
            return 1
        if args.single_pass:
            data = enc.encode(frames, gops, usec_per_frame=usec,
                              target_bytes=int(args.target_kb * 1024))
            lam = enc.lam
        else:
            data, lam = encode_to_size(cfg, frames, gops,
                                       int(args.target_kb * 1024),
                                       slices=args.slices,
                                       dc_shift=args.dc_shift,
                                       psy=args.psy,
                                       usec_per_frame=usec)
        print(f"rate control: lambda={lam:.3f}", file=sys.stderr)
    else:
        data = enc.encode(frames, gops, usec_per_frame=usec,
                          audio=audio, audio_rate=audio_rate)
    Path(args.output).write_bytes(data)
    print(f"encoded {n} frames -> {args.output} ({len(data)} bytes)",
          file=sys.stderr)
    return 0


# subcommands that use no device and take no --device
_HOST_ONLY = (cmd_info, cmd_audio, cmd_stats, cmd_remote, cmd_encode)


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

    p = sub.add_parser("encode")
    p.add_argument("input", help="raw planar YUV file (frames back-to-back) "
                                 "or a YUV4MPEG2 (.y4m) stream, e.g. from "
                                 "`ffmpeg -i in.mp4 -f yuv4mpegpipe in.y4m`")
    p.add_argument("output")
    p.add_argument("--width", type=int,
                   help="frame width (required for raw YUV; .y4m is "
                        "self-describing)")
    p.add_argument("--height", type=int)
    p.add_argument("--sampling", choices=["420", "444"], default=None)
    p.add_argument("--gops", help="display-order patterns, e.g. IPPP,IBPBP")
    p.add_argument("--quality", type=float, default=4.0,
                   help="lambda (bits weight); lower = higher quality")
    p.add_argument("--slices", type=int, default=1,
                   help="entropy slices per frame (FORMAT.md §9; enables "
                        "slice-parallel host planning on decode)")
    p.add_argument("--audio", help="16-bit PCM WAV to mux as IMA-ADPCM "
                                   "records (one per GOP block)")
    p.add_argument("--target-kb", type=float, default=None,
                   help="rate control: bisect lambda to hit this clip size "
                        "(overrides --quality)")
    p.add_argument("--dc-shift", type=int, default=0,
                   help="DC delta quantization shift 0..7 (coarser DCs, "
                        "fewer bits)")
    p.add_argument("--psy", type=float, default=0.0,
                   help="psychovisual weighting strength 0..1: shift bits "
                        "from textured (masking) to flat regions")
    p.add_argument("--single-pass", action="store_true",
                   help="with --target-kb: per-GOP adaptive lambda in ONE "
                        "pass instead of bisection re-encodes")
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("transcode")
    p.add_argument("clip")
    p.add_argument("output")
    p.add_argument("--quality", type=float, default=4.0,
                   help="lambda (bits weight); lower = higher quality")
    p.add_argument("--target-kb", type=float, default=None,
                   help="rate control: bisect lambda to hit this clip size "
                        "(video-only; overrides --quality)")
    p.add_argument("--gops", help="display-order patterns for the re-encode")
    p.add_argument("--slices", type=int, default=1)
    p.add_argument("--dc-shift", type=int, default=0)
    p.set_defaults(fn=cmd_transcode)

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
