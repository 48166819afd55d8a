"""The port's command line against the JAX package's: the same input through
both `main`s, outputs compared byte for byte where both print, and every
refusal of the reference refused with the same single line.
"""

import json
import os
import re
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest

from hvqm4_tpu import cli as jcli
from hvqm4_tpu.utils.stats import clip_stats as jax_clip_stats
from hvqm4_tpu_torch import cli, serve
from hvqm4_tpu_torch.config import SeqConfig
from hvqm4_tpu_torch.container import Demuxer
from hvqm4_tpu_torch.models.vit import ViTConfig
from hvqm4_tpu_torch.session import DecoderSession
from tools.encoder import make_clip

from .conftest import REPO

CFG = SeqConfig(64, 48)
JAX_DEV = ["--backend", "numpy"]     # the reference CLI's host backend
PORT_DEV = ["--device", "cpu"]


@pytest.fixture()
def clip_path(tmp_path):
    p = tmp_path / "c.h4m"
    p.write_bytes(make_clip(CFG, ["IPB"], seed=55, audio_channels=2))
    return p


def run_both(capsys, argv, jax_extra=(), port_extra=()):
    """[(rc, stdout, stderr)] of the JAX CLI and of the port's."""
    out = []
    for main, extra in ((jcli.main, jax_extra), (cli.main, port_extra)):
        capsys.readouterr()
        rc = main([*argv, *extra])
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


def error_line(err: str, prog: str) -> str:
    """The one error line, after the program-name prefix."""
    lines = err.strip().splitlines()
    assert len(lines) == 1 and "Traceback" not in err, err
    assert lines[0].startswith(prog + ": error: "), err
    return lines[0][len(prog) + 2:]


def assert_same_refusal(results, contains: str = "") -> None:
    (jrc, _jout, jerr), (rc, _out, err) = results
    assert jrc == rc == 1
    line = error_line(err, "hvqm4_tpu_torch")
    assert line == error_line(jerr, "hvqm4_tpu") and contains in line


# -- the three faults of the port's CLI ---------------------------------------

def test_info_matches_jax_with_audio_line(capsys, clip_path):
    (jrc, jout, _je), (rc, out, _e) = run_both(capsys, ["info", str(clip_path)])
    assert jrc == rc == 0 and out == jout
    assert "64x48" in out and "video_frames=3" in out
    assert "audio: 2ch 32000 Hz IMA-ADPCM" in out


@pytest.mark.parametrize("module,dev", [("hvqm4_tpu.cli", JAX_DEV),
                                        ("hvqm4_tpu_torch.cli", PORT_DEV)])
def test_closed_pipe_exits_141_silently(clip_path, module, dev):
    """`decode --y4m | head -c 0`: the reader is gone before the first byte
    is written; both CLIs die as Unix tools do, 128 + SIGPIPE, and say
    nothing."""
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "decode", str(clip_path), "--y4m", *dev],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=REPO)
    proc.stdout.close()
    err = proc.stderr.read()
    assert proc.wait(timeout=300) == 141
    assert err == b""


def p_only_clip() -> bytes:
    """One block whose only video record is a P frame: it demuxes and
    plans, and has nothing to predict from."""
    clip = make_clip(CFG, ["IP"], seed=56)
    rec = list(Demuxer(clip).video_records())[1]
    assert rec.frame_char == "P"
    record = clip[-(8 + len(rec.payload)):]
    assert record[8:] == rec.payload
    head = bytearray(clip[:0x44])
    struct.pack_into(">I", head, 20, 8 + len(record))    # body_size
    struct.pack_into(">I", head, 28, 1)                  # video_frames
    return bytes(head) + struct.pack(">IHH", len(record), 0, 1) + record


def test_own_value_error_is_one_line_p_without_reference(capsys, tmp_path):
    p = tmp_path / "p.h4m"
    p.write_bytes(p_only_clip())
    res = run_both(capsys, ["decode", str(p)], JAX_DEV, PORT_DEV)
    assert_same_refusal(res, "P/B frame without reference")
    res = run_both(capsys, ["hash", str(p)], JAX_DEV, PORT_DEV)
    assert_same_refusal(res, "P/B frame without reference")


def test_own_value_error_is_one_line_config_mismatch(capsys, monkeypatch,
                                                     clip_path):
    """A session of another geometry than the clip's refuses the clip."""
    from hvqm4_tpu.config import SeqConfig as JaxSeqConfig
    from hvqm4_tpu.session import DecoderSession as JaxSession

    monkeypatch.setattr(jcli, "DecoderSession", lambda cfg, **kw: JaxSession(
        JaxSeqConfig(32, 16), **kw))
    monkeypatch.setattr(cli, "DecoderSession", lambda cfg, *a, **kw:
                        DecoderSession(SeqConfig(32, 16), *a, **kw))
    res = run_both(capsys, ["decode", str(clip_path)], JAX_DEV, PORT_DEV)
    assert_same_refusal(res, "do not match session config")


def test_y4m_without_equivalent_is_one_line(capsys, monkeypatch, clip_path):
    monkeypatch.setattr(cli, "_Y4M_CHROMA", {})
    monkeypatch.setattr(jcli, "_Y4M_CHROMA", {})
    res = run_both(capsys, ["decode", str(clip_path), "--y4m"], JAX_DEV,
                   PORT_DEV)
    assert_same_refusal(res, "has no Y4M equivalent")


@pytest.mark.parametrize("source", ["numpy", "test", "jax_package"])
def test_foreign_value_error_keeps_its_traceback(monkeypatch, tmp_path,
                                                 clip_path, source):
    """Only a ValueError raised by the port's own code is a user error:
    numpy's, a caller's and the JAX package's propagate."""
    def from_numpy(_data):
        return np.stack([])

    def from_test(_data):
        raise ValueError("raised outside the package")

    path = clip_path
    if source == "jax_package":
        path = tmp_path / "bad.h4m"
        path.write_bytes(b"not a clip" * 20)
    fn = {"numpy": from_numpy, "test": from_test,
          "jax_package": jax_clip_stats}[source]
    monkeypatch.setattr(cli, "clip_stats", fn)
    with pytest.raises(ValueError):
        cli.main(["stats", str(path)])


# -- the subcommands that were missing ----------------------------------------

def test_audio_and_stats_match_jax(tmp_path, capsys, clip_path):
    wavs = [tmp_path / "j.wav", tmp_path / "t.wav"]
    for main, wav in zip((jcli.main, cli.main), wavs):
        assert main(["audio", str(clip_path), str(wav)]) == 0
        assert capsys.readouterr().err == f"wrote {wav}\n"
    assert wavs[0].read_bytes()[:4] == b"RIFF"
    assert wavs[0].read_bytes() == wavs[1].read_bytes()
    (jrc, jout, _je), (rc, out, _e) = run_both(capsys,
                                               ["stats", str(clip_path)])
    assert jrc == rc == 0 and out == jout
    assert json.loads(out)["frames"] == {"I": 1, "P": 1, "B": 1}


def test_audio_without_audio_is_refused(tmp_path, capsys):
    p = tmp_path / "silent.h4m"
    p.write_bytes(make_clip(CFG, ["I"], seed=3))
    (jrc, _jo, jerr), (rc, _o, err) = run_both(
        capsys, ["audio", str(p), str(tmp_path / "x.wav")])
    assert jrc == rc == 1 and err == jerr == "no audio in clip\n"
    assert not (tmp_path / "x.wav").exists()


def test_host_only_subcommands_take_no_device(capsys, clip_path):
    for argv in (["info", str(clip_path)], ["stats", str(clip_path)],
                 ["audio", str(clip_path), "x.wav"],
                 ["remote", "127.0.0.1:1", "--metrics"]):
        with pytest.raises(SystemExit) as e:
            cli.main([*argv, "--device", "cpu"])
        assert e.value.code == 2
        assert "unrecognized arguments: --device" in capsys.readouterr().err


def test_decode_start_time_matches_jax(tmp_path, capsys):
    clip = tmp_path / "c.h4m"
    clip.write_bytes(make_clip(CFG, ["IPP", "IP"], seed=57))
    usec = Demuxer(clip.read_bytes()).info.usec_per_frame
    outs = {k: tmp_path / f"{k}.yuv" for k in ("j", "t", "b")}

    def decode(*flags):
        res = run_both(capsys, ["decode", str(clip)],
                       [str(outs["j"]), *JAX_DEV, *flags],
                       [str(outs["t"]), *PORT_DEV, *flags])
        return res

    # a time inside frame 4 (the second block starts at frame 3)
    res = decode("--start-time", str(3.5 * usec / 1e6))
    assert [r[0] for r in res] == [0, 0]
    assert cli.main(["decode", str(clip), str(outs["b"]), *PORT_DEV,
                     "--start-block", "1"]) == 0
    tail = outs["b"].read_bytes()
    assert len(tail) == 2 * CFG.frame_bytes
    assert outs["t"].read_bytes() == outs["j"].read_bytes() == tail
    # time 0 is the whole clip; past the end clamps to the last block
    assert [r[0] for r in decode("--start-time", "0")] == [0, 0]
    assert outs["t"].read_bytes() == outs["j"].read_bytes()
    assert len(outs["t"].read_bytes()) == 5 * CFG.frame_bytes
    assert [r[0] for r in decode("--start-time", "9999")] == [0, 0]
    assert outs["t"].read_bytes() == outs["j"].read_bytes() == tail
    # the refusals, each one line and the reference's words
    assert_same_refusal(decode("--start-time", "-1"), "non-negative")
    assert_same_refusal(decode("--start-time", "0", "--start-block", "1"),
                        "mutually exclusive")
    res = run_both(capsys, ["decode", str(clip), "--gop-parallel",
                            "--start-time", "0"], (), PORT_DEV)
    assert_same_refusal(
        res, "--start-time is not supported with --gop-parallel")


@pytest.fixture()
def server():
    srv = serve.DecodeServer(("127.0.0.1", 0), device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield "%s:%d" % srv.server_address
    srv.shutdown()
    srv.server_close()


def test_remote_roundtrip_matches_jax_client(tmp_path, capsys, clip_path,
                                             server):
    """Both CLIs' `remote` against the port's server: the same YUV, the
    session's frames; metrics in both formats."""
    outs = [tmp_path / "j.yuv", tmp_path / "t.yuv"]
    want = b"".join(f.yuv_bytes() for f in DecoderSession(CFG, "cpu")
                    .decode_clip(clip_path.read_bytes()))
    for main, out in zip((jcli.main, cli.main), outs):
        assert main(["remote", server, str(clip_path), str(out)]) == 0
        assert capsys.readouterr().err == \
            f"received 3 frames ({len(want)} bytes)\n"
        assert out.read_bytes() == want
    rgb = tmp_path / "t.rgb"
    assert cli.main(["remote", server, str(clip_path), str(rgb), "--mode",
                     "rgb"]) == 0
    assert rgb.stat().st_size == 3 * 64 * 48 * 3
    (jrc, jout, _je), (rc, out, _e) = run_both(capsys,
                                               ["remote", server, "--metrics"])
    assert jrc == rc == 0
    got, ref = json.loads(out), json.loads(jout)
    assert list(got) == list(ref) and got["requests_total"] == 3
    assert got["by_mode"] == {"yuv": 2, "rgb": 1, "embed": 0}
    (jrc, jout, _je), (rc, out, _e) = run_both(
        capsys, ["remote", server, "--metrics", "--prometheus"])
    assert jrc == rc == 0 and "hvqm4_serve_requests_total 3" in out
    assert [ln.split()[:3] for ln in out.splitlines() if ln[0] == "#"] \
        == [ln.split()[:3] for ln in jout.splitlines() if ln[0] == "#"]


def test_remote_embed_mode_and_token(tmp_path, capsys, clip_path):
    srv = serve.DecodeServer(("127.0.0.1", 0), device="cpu",
                             auth_token="s3cret",
                             vit_cfg=ViTConfig(32, 8, 64, 2, 4))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    addr = "%s:%d" % srv.server_address
    try:
        out = tmp_path / "e.bin"
        assert cli.main(["remote", addr, str(clip_path), str(out), "--mode",
                         "embed", "--token", "s3cret"]) == 0
        assert "received 3 embeddings" in capsys.readouterr().err
        emb = np.frombuffer(out.read_bytes(), "<f4").reshape(3, -1)
        assert emb.shape[1] == 64 and np.isfinite(emb).all()
        res = run_both(capsys, ["remote", addr, str(clip_path)])
        assert_same_refusal(res)                    # no token: refused
    finally:
        srv.shutdown()
        srv.server_close()


def test_remote_errors_match_jax(capsys, clip_path, server):
    # an unreachable server and a malformed address: one line each
    assert_same_refusal(run_both(
        capsys, ["remote", "127.0.0.1:1", str(clip_path), "/dev/null"]))
    for bad in ("nocolon", "host:0", "host:99999", ":80", "host:http"):
        assert_same_refusal(run_both(capsys, ["remote", bad, str(clip_path)]),
                            "HOST:PORT")
    assert_same_refusal(run_both(capsys, ["remote", server]),
                        "clip required unless --metrics")
    assert_same_refusal(run_both(
        capsys, ["remote", server, str(clip_path), "--metrics"]),
        "--metrics takes no clip/output")


def test_usage_lists_every_subcommand(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    usage = capsys.readouterr().out
    for sub in ("info", "decode", "hash", "verify", "audio", "stats",
                "remote", "encode", "transcode"):
        assert sub in usage and f"cli {sub}" in cli.__doc__
    with pytest.raises(SystemExit):
        jcli.main(["--help"])
    jusage = capsys.readouterr().out
    subs = next(g for g in re.findall(r"\{([^}]*)\}", jusage) if "info" in g)
    assert len(subs.split(",")) == 9
    assert all(sub in usage for sub in subs.split(","))


# -- encode and transcode -----------------------------------------------------

def _raw_yuv(n: int = 3) -> bytes:
    """n frames of 32x16 4:2:0: a noisy ramp over flat chroma."""
    rng = np.random.default_rng(0)
    raw = b""
    for _ in range(n):
        y = np.clip(np.linspace(30, 220, 16 * 32).reshape(16, 32)
                    + rng.normal(0, 2, (16, 32)), 0, 255).astype(np.uint8)
        raw += y.tobytes() + np.full((8, 16), 120, np.uint8).tobytes() \
            + np.full((8, 16), 130, np.uint8).tobytes()
    return raw


def _wav(path, width: int = 2):
    import wave

    t = np.arange(3200)[:, None]
    pcm = (6000 * np.sin(0.03 * t + np.arange(2)[None, :])).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(width)
        w.setframerate(32000)
        w.writeframes(pcm.astype("<i2").tobytes() if width == 2
                      else (pcm >> 8).astype(np.int8).tobytes())
    return path


def encode_both(capsys, tmp_path, argv):
    """Both CLIs' `encode` (or `transcode`) with their own output path:
    [(rc, stderr with the path taken out, output bytes or None)]."""
    out = []
    for main, name in ((jcli.main, "j.h4m"), (cli.main, "t.h4m")):
        path = tmp_path / name
        path.unlink(missing_ok=True)
        capsys.readouterr()
        rc = main([a if a != "OUT" else str(path) for a in argv])
        err = capsys.readouterr().err.replace(str(path), "OUT")
        out.append((rc, err, path.read_bytes() if path.exists() else None))
    return out


@pytest.mark.parametrize("flags", [
    ["--gops", "IPP"], [], ["--quality", "1.5", "--slices", "2",
                            "--dc-shift", "1", "--psy", "0.5"],
    ["--sampling", "420", "--gops", "IBP"],
    ["--target-kb", "0.5"], ["--target-kb", "0.5", "--single-pass"],
    ["--audio", "WAV"]])
def test_encode_raw_yuv_matches_jax(tmp_path, capsys, flags):
    src = tmp_path / "in.yuv"
    src.write_bytes(_raw_yuv())
    wav = str(_wav(tmp_path / "a.wav"))
    flags = [wav if f == "WAV" else f for f in flags]
    (jrc, jerr, jout), (rc, err, out) = encode_both(
        capsys, tmp_path, ["encode", str(src), "OUT", "--width", "32",
                           "--height", "16", *flags])
    assert jrc == rc == 0 and out == jout and err == jerr
    assert err.splitlines()[-1] == \
        f"encoded 3 frames -> OUT ({len(out)} bytes)"
    info = Demuxer(out).info
    assert info.cfg == SeqConfig(32, 16) and info.video_frames == 3
    assert info.audio_channels == (2 if "--audio" in flags else 0)
    assert ("rate control: lambda=" in err) == ("--target-kb" in flags)


def test_encode_from_y4m_matches_jax(tmp_path, capsys):
    """decode --y4m -> encode: the stream describes itself, so encode needs
    no flags, and the clip keeps the source's frame rate."""
    src = tmp_path / "src.h4m"
    src.write_bytes(make_clip(CFG, ["IPP"], seed=60, usec_per_frame=40000))
    y4m = tmp_path / "v.y4m"
    assert cli.main(["decode", str(src), str(y4m), *PORT_DEV, "--y4m"]) == 0
    assert y4m.read_bytes().startswith(b"YUV4MPEG2 W64 H48 F25:1 ")
    (jrc, jerr, jout), (rc, err, out) = encode_both(
        capsys, tmp_path, ["encode", str(y4m), "OUT", "--quality", "0.5"])
    assert jrc == rc == 0 and out == jout and err == jerr
    info = Demuxer(out).info
    assert (info.cfg.width, info.cfg.height) == (64, 48)
    assert info.usec_per_frame == 40000    # from the F tag, not a default
    # matching explicit geometry is accepted
    res = encode_both(capsys, tmp_path, [
        "encode", str(y4m), "OUT", "--quality", "0.5", "--width", "64",
        "--height", "48", "--sampling", "420"])
    assert [r[0] for r in res] == [0, 0] and res[0][2] == res[1][2] == out


def _y4m(header: bytes, frames: int = 1, size: int = 32 * 16 * 3 // 2):
    return header + b"\n" + (b"FRAME\n" + b"\x80" * size) * frames


@pytest.mark.parametrize("name,contains", [
    ("no_geometry", "--width/--height are required"),
    ("not_a_multiple", "input not a multiple of 2304 bytes"),
    ("y4m_size_conflict", "conflict with the y4m header (32x16)"),
    ("y4m_sampling_conflict", "--sampling conflicts with the y4m header"),
    ("y4m_bad_chroma", "unsupported y4m chroma C422"),
    ("y4m_bad_field", "bad y4m header field 'Wxx'"),
    ("y4m_no_size", "y4m header missing/invalid W/H/F"),
    ("y4m_truncated_header", "truncated y4m header"),
    ("y4m_truncated_frame", "truncated y4m frame payload"),
    ("y4m_bad_marker", "bad y4m FRAME marker at byte"),
    ("wav_not_16_bit", "audio must be 16-bit PCM WAV"),
    ("target_kb_with_audio", "--target-kb does not support --audio"),
    ("bad_slices", "slice count must be in [1, 2]"),
    ("bad_gops", "gop pattern length != frame count"),
    ("missing_input", "No such file"),
])
def test_encode_refusals_match_jax(tmp_path, capsys, name, contains):
    raw = tmp_path / "in.yuv"
    raw.write_bytes(_raw_yuv(2))
    y4m = tmp_path / "in.y4m"
    y4m.write_bytes(_y4m(b"YUV4MPEG2 W32 H16 F25:1 C420jpeg"))
    geo = ["--width", "32", "--height", "16"]

    def bad_y4m(data: bytes):
        y4m.write_bytes(data)
        return [str(y4m), "OUT"]

    argv = {
        "no_geometry": lambda: [str(raw), "OUT"],
        "not_a_multiple": lambda: [str(raw), "OUT", "--width", "32",
                                   "--height", "48"],
        "y4m_size_conflict": lambda: [str(y4m), "OUT", "--width", "128",
                                      "--height", "96"],
        "y4m_sampling_conflict": lambda: [str(y4m), "OUT", "--sampling",
                                          "444"],
        "y4m_bad_chroma": lambda: bad_y4m(
            _y4m(b"YUV4MPEG2 W32 H16 F25:1 C422")),
        "y4m_bad_field": lambda: bad_y4m(_y4m(b"YUV4MPEG2 Wxx H16")),
        "y4m_no_size": lambda: bad_y4m(_y4m(b"YUV4MPEG2 H16 F25:1")),
        "y4m_truncated_header": lambda: bad_y4m(b"YUV4MPEG2 W32 H16"),
        "y4m_truncated_frame": lambda: bad_y4m(
            _y4m(b"YUV4MPEG2 W32 H16 F25:1")[:-5]),
        "y4m_bad_marker": lambda: bad_y4m(
            _y4m(b"YUV4MPEG2 W32 H16 F25:1") + b"FRUME\n"),
        "wav_not_16_bit": lambda: [str(raw), "OUT", *geo, "--audio",
                                   str(_wav(tmp_path / "a8.wav", width=1))],
        "target_kb_with_audio": lambda: [
            str(raw), "OUT", *geo, "--target-kb", "1", "--audio",
            str(_wav(tmp_path / "a.wav"))],
        "bad_slices": lambda: [str(raw), "OUT", *geo, "--slices", "3"],
        "bad_gops": lambda: [str(raw), "OUT", *geo, "--gops", "IPP"],
        "missing_input": lambda: [str(tmp_path / "nope.yuv"), "OUT", *geo],
    }[name]()
    (jrc, jerr, jout), (rc, err, out) = encode_both(capsys, tmp_path,
                                                    ["encode", *argv])
    assert_same_refusal([(jrc, "", jerr), (rc, "", err)], contains)
    assert out is None and jout is None


def test_encode_takes_no_device(capsys, tmp_path):
    for dev in ("cuda", "cpu"):
        with pytest.raises(SystemExit) as e:
            cli.main(["encode", "in.yuv", str(tmp_path / "o.h4m"), "--width",
                      "32", "--height", "16", "--device", dev])
        assert e.value.code == 2
        assert "unrecognized arguments: --device" in capsys.readouterr().err


@pytest.mark.parametrize("gops,seed,usec,audio,flags", [
    (["IPB"], 55, 33366, 2, ["--quality", "2"]),
    (["IPP"], 61, 40000, 0, ["--quality", "8"]),
    (["IPB", "IP"], 62, 33366, 1, ["--gops", "IBP,IP", "--slices", "2",
                                   "--dc-shift", "1"]),
    (["IPPPP"], 56, 33366, 0, ["--target-kb", "3"]),
])
def test_transcode_matches_jax(tmp_path, capsys, oracle_bin, gops, seed, usec,
                               audio, flags):
    """`transcode --device cpu` against the JAX CLI's `--backend numpy`:
    the same bytes and the same report; geometry, frame count, frame rate
    and audio survive; the result decodes identically by the oracle."""
    src = tmp_path / "s.h4m"
    src.write_bytes(make_clip(CFG, gops, seed=seed, usec_per_frame=usec,
                              audio_channels=audio))
    results = []
    for extra, (main, name) in zip((JAX_DEV, PORT_DEV), (
            (jcli.main, "j.h4m"), (cli.main, "t.h4m"))):
        capsys.readouterr()
        rc = main(["transcode", str(src), str(tmp_path / name), *flags,
                   *extra])
        results.append((rc, capsys.readouterr().err,
                        (tmp_path / name).read_bytes()))
    (jrc, jerr, jout), (rc, err, out) = results
    assert jrc == rc == 0 and out == jout and err == jerr
    n = sum(map(len, gops))
    assert f"transcoded {n} frames: {src.stat().st_size} -> {len(out)}" in err
    info = Demuxer(out).info
    assert info.cfg == CFG and info.video_frames == n
    assert info.usec_per_frame == usec and info.audio_channels == audio
    assert ("rate control: lambda=" in err) == ("--target-kb" in flags)
    from hvqm4_tpu_torch.refdec import decode_clip

    from .conftest import run_oracle

    assert run_oracle(oracle_bin, out, tmp_path) == b"".join(
        p.tobytes() for planes in decode_clip(CFG, out) for p in planes)


def test_transcode_target_kb_with_audio_is_refused(tmp_path, capsys,
                                                   clip_path):
    res = []
    for main, extra in ((jcli.main, JAX_DEV), (cli.main, PORT_DEV)):
        capsys.readouterr()
        rc = main(["transcode", str(clip_path), str(tmp_path / "o.h4m"),
                   "--target-kb", "3", *extra])
        res.append((rc, "", capsys.readouterr().err))
    assert_same_refusal(res, "--target-kb transcode is video-only")
    assert not (tmp_path / "o.h4m").exists()


def test_transcode_without_cuda_fails_with_one_line(tmp_path, capsys,
                                                    clip_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    out = tmp_path / "o.h4m"
    assert cli.main(["transcode", str(clip_path), str(out)]) == 1
    line = error_line(capsys.readouterr().err, "hvqm4_tpu_torch")
    assert "CUDA is not available" in line and not out.exists()
    assert cli.main(["transcode", str(clip_path), str(out), "--device",
                     "cuda:0"]) == 1
    # the reference's --backend is not an option of the port
    with pytest.raises(SystemExit):
        cli.main(["transcode", str(clip_path), str(out), "--backend",
                  "numpy"])
