"""The port's host half against the JAX package's originals, which it copies
(config, container, plans and the C++ planner, the NumPy golden decoder,
the digests, the Y4M header, the service's wire protocol): the same inputs
give the same results, so the two copies cannot drift unseen.
"""

import dataclasses
import json
import threading

import numpy as np
import pytest

from hvqm4_tpu import audio as jaudio
from hvqm4_tpu import cli as jcli
from hvqm4_tpu import serve as jserve
from hvqm4_tpu.config import SeqConfig as JaxSeqConfig
from hvqm4_tpu.container import ContainerError as JaxContainerError
from hvqm4_tpu.container import Demuxer as JaxDemuxer
from hvqm4_tpu.native import NativePlanner as JaxPlanner
from hvqm4_tpu.session import DecoderSession as JaxSession
from hvqm4_tpu.utils import hashing as jhashing
from hvqm4_tpu.utils.stats import clip_stats as jax_clip_stats
from hvqm4_tpu_torch import audio, cli, native, refdec, serve
from hvqm4_tpu_torch.config import SeqConfig
from hvqm4_tpu_torch.container import ContainerError, Demuxer
from hvqm4_tpu_torch.utils import hashing
from hvqm4_tpu_torch.utils.stats import clip_stats
from tools.encoder import make_clip

from .conftest import REPO

# the three test clips, and make_clip streams whose vectors reach far
# beyond the frame (landscape 4:2:0; portrait 4:4:4)
CLIPS = ["i320.h4m", "ref640.h4m", "retail640.h4m",
         (64, 48, 2, ["IPBPB", "IPP"], 5), (48, 64, 1, ["IBBPB", "IP"], 6)]


def _clip(case) -> bytes:
    if isinstance(case, str):
        return (REPO / "testdata" / case).read_bytes()
    w, h, samp, gops, seed = case
    return make_clip(SeqConfig(w, h, samp, samp), gops, seed=seed,
                     mv_extreme=True)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _assert_same(a, b, what: str) -> None:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), what
    else:
        assert a == b, what


@pytest.mark.parametrize("case", CLIPS)
def test_planner_matches_jax(case):
    """Every frame's plan from the port's planner equals the JAX package's,
    field by field and plane by plane."""
    data = _clip(case)
    demux = Demuxer(data)
    cfg = demux.info.cfg
    ours = native.NativePlanner(cfg)
    theirs = JaxPlanner(JaxSeqConfig(**_fields(cfg)))
    n = 0
    for rec in demux.video_records():
        a = ours.plan_frame(rec.frame_char, rec.payload)
        b = theirs.plan_frame(rec.frame_char, rec.payload)
        for name, va in _fields(a).items():
            if name == "planes":
                continue
            _assert_same(va, getattr(b, name), f"frame {n} {name}")
        assert len(a.planes) == len(b.planes) == 3
        for pi, (pa, pb) in enumerate(zip(a.planes, b.planes)):
            for name, va in _fields(pa).items():
                _assert_same(va, getattr(pb, name),
                             f"frame {n} plane {pi} {name}")
        n += 1
    assert n == demux.info.video_frames > 0


@pytest.mark.parametrize("case", CLIPS)
def test_demuxer_and_config_match_jax(case):
    data = _clip(case)
    ours, theirs = Demuxer(data), JaxDemuxer(data)
    assert dataclasses.asdict(ours.info) == dataclasses.asdict(theirs.info)
    cfg, jcfg = ours.info.cfg, theirs.info.cfg
    for prop in ("plane_shapes", "block_grids", "mb_grid", "nest_shape",
                 "frame_bytes", "magic"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert ours.block_offsets == theirs.block_offsets
    for b in range(len(ours.block_offsets)):
        assert ([dataclasses.astuple(r) for r in ours.block_records(b)]
                == [dataclasses.astuple(r) for r in theirs.block_records(b)])
    assert ([dataclasses.astuple(r) for r in ours.records()]
            == [dataclasses.astuple(r) for r in theirs.records()])
    assert ([r.frame_char for r in ours.video_records()]
            == [r.frame_char for r in theirs.video_records()])
    assert ours.block_video_counts() == theirs.block_video_counts()
    assert sum(ours.block_video_counts()) == ours.info.video_frames
    assert ([dataclasses.astuple(r) for r in ours.audio_records()]
            == [dataclasses.astuple(r) for r in theirs.audio_records()])


def test_block_for_time_and_audio_records_match_jax():
    """A two-block clip with audio: every block index over a sweep of times
    (0, inside each frame, the block boundary, past the end), the refusal of
    a negative time, and the audio records field by field."""
    data = make_clip(SeqConfig(64, 48), ["IPP", "IP"], seed=57,
                     audio_channels=2)
    ours, theirs = Demuxer(data), JaxDemuxer(data)
    usec = ours.info.usec_per_frame
    assert ours.block_video_counts() == theirs.block_video_counts() == [3, 2]
    times = [0, 1e-9, 2.999 * usec / 1e6, 3 * usec / 1e6, 3.5 * usec / 1e6,
             5 * usec / 1e6, 9999.0]
    times += [k * usec / 4e6 for k in range(24)]
    got = [ours.block_for_time(t) for t in times]
    assert got == [theirs.block_for_time(t) for t in times]
    assert got[:7] == [0, 0, 0, 1, 1, 1, 1]
    with pytest.raises(ContainerError) as e_ours:
        ours.block_for_time(-0.5)
    with pytest.raises(JaxContainerError) as e_theirs:
        theirs.block_for_time(-0.5)
    assert str(e_ours.value) == str(e_theirs.value)
    a = list(ours.audio_records())
    b = list(theirs.audio_records())
    assert len(a) == len(b) == ours.info.audio_frames == 2
    for ra, rb in zip(a, b):
        assert dataclasses.asdict(ra) == dataclasses.asdict(rb)


@pytest.mark.parametrize("channels", [1, 2])
def test_audio_matches_jax(tmp_path, channels):
    """The port's IMA-ADPCM copy: tables, encode, decode and the WAV file
    equal the JAX package's on a seeded signal."""
    assert np.array_equal(audio.STEP_TABLE, jaudio.STEP_TABLE)
    assert np.array_equal(audio.INDEX_TABLE, jaudio.INDEX_TABLE)
    rng = np.random.default_rng(40 + channels)
    t = np.arange(501)[:, None] / 32000.0
    sig = 9000 * np.sin(2 * np.pi * 440 * (1 + np.arange(channels)) * t)
    sig = (sig + rng.normal(0, 300, sig.shape)).astype(np.int16)
    payloads = [audio.encode_record(sig[:257]), audio.encode_record(sig[257:])]
    assert payloads == [jaudio.encode_record(sig[:257]),
                        jaudio.encode_record(sig[257:])]
    ours = [audio.decode_record(p, channels) for p in payloads]
    theirs = [jaudio.decode_record(p, channels) for p in payloads]
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.int16 and np.array_equal(a, b)
    assert ours[0].shape == (257, channels)
    audio.records_to_wav(ours, 32000, str(tmp_path / "a.wav"))
    jaudio.records_to_wav(theirs, 32000, str(tmp_path / "b.wav"))
    wav = (tmp_path / "a.wav").read_bytes()
    assert wav[:4] == b"RIFF" and wav == (tmp_path / "b.wav").read_bytes()
    with pytest.raises(ContainerError, match="too short"):
        audio.decode_record(payloads[0][:3], channels)
    with pytest.raises(ContainerError, match="truncated"):
        audio.decode_record(payloads[0][:-5], channels)


@pytest.mark.parametrize("case", ["i320.h4m", (64, 48, 2, ["IPB"], 58)])
def test_clip_stats_match_jax(case):
    """`clip_stats` over the C++ planner gives the JSON that the JAX
    package's gives over its Python planner, byte for byte."""
    if isinstance(case, str):
        data = _clip(case)
    else:
        w, h, samp, gops, seed = case
        data = make_clip(SeqConfig(w, h, samp, samp), gops, seed=seed)
    got = clip_stats(data)
    assert got == jax_clip_stats(data)
    assert set(json.loads(got)) == {"frames", "video_payload_bytes",
                                    "block_classes", "modes"}


def test_digests_and_y4m_header_match_jax(oracle_bin):
    rng = np.random.default_rng(3)
    for n in (0, 1, 7, 4096):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert hashing.fnv1a(data) == jhashing.fnv1a(data)
    path = REPO / "testdata" / "retail640.h4m"
    assert hashing.oracle_csums(oracle_bin, path) \
        == jhashing.oracle_csums(oracle_bin, path)
    for case in CLIPS:
        data = _clip(case)
        assert cli._y4m_header(Demuxer(data).info) \
            == jcli._y4m_header(JaxDemuxer(data).info)


@pytest.mark.parametrize("case", CLIPS[3:])
def test_refdec_matches_jax_golden(case):
    """The port's golden decoder, which `cli verify` runs, equals the JAX
    package's (`DecoderSession(backend="numpy")`) frame for frame."""
    data = _clip(case)
    info = Demuxer(data).info
    cfg = info.cfg
    ours = [b"".join(p.tobytes() for p in planes)
            for planes in refdec.decode_clip(cfg, data)]
    theirs = [f.yuv_bytes() for f in JaxSession(
        JaxSeqConfig(**_fields(cfg)), backend="numpy").decode_clip(data)]
    assert ours == theirs and len(ours) == info.video_frames


def _serving(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def test_clients_and_servers_interoperate():
    """JAX clients against the port's server and the port's clients against
    the JAX numpy server: byte-equal YUV replies, on single-shot and
    multiplexed connections, and each side reads the other's metrics."""
    clips = [make_clip(SeqConfig(64, 48), ["IPB", "IP"], seed=s)
             for s in (70, 71)]
    port = _serving(serve.DecodeServer(("127.0.0.1", 0), device="cpu"))
    ref = _serving(jserve.DecodeServer(("127.0.0.1", 0), backend="numpy"))
    try:
        want = [jserve.decode_remote(*ref.server_address, c) for c in clips]
        assert [len(w) for w in want] == [5, 5]
        for client in (serve, jserve):
            for srv in (port, ref):
                addr = srv.server_address
                assert [client.decode_remote(*addr, c) for c in clips] == want
                with client.MuxClient(*addr) as mc:
                    ids = [mc.submit(c) for c in clips]
                    assert [mc.result(i, timeout=120)
                            for i in reversed(ids)] == want[::-1]
        assert serve.fetch_metrics(*ref.server_address)[
            "requests_total"] == 10
        assert jserve.fetch_metrics(*port.server_address)[
            "requests_total"] == 8
    finally:
        for srv in (port, ref):
            srv.shutdown()
            srv.server_close()


@pytest.mark.parametrize("cxx,flag,match", [
    ("no-such-compiler", None, "cannot run no-such-compiler"),
    ("g++", "-fno-such-flag", "failed"),
])
def test_planner_build_failure_raises(monkeypatch, tmp_path, cxx, flag,
                                      match):
    """A planner that cannot be built raises with the compiler's message:
    there is no Python planner to fall back to."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", cxx)
    if flag:
        monkeypatch.setattr(native, "CXXFLAGS", (*native.CXXFLAGS, flag))
    with pytest.raises(RuntimeError, match=match) as e:
        native.build()
    if flag:
        assert flag in str(e.value)  # g++ names the flag it refused
    assert not any(tmp_path.iterdir())
