"""The port's encoder against the JAX package's: the same frames, made from
a numpy seed, through both `VideoEncoder.encode`s give the same `.h4m` bytes,
with the sampled host search and with the full-nest search on (the port's on
`device="cpu"`), and every port stream decodes identically by the C oracle
and by the port's golden decoder. Byte data, compared exactly.
"""

import numpy as np
import pytest

from hvqm4_tpu.config import SeqConfig as JaxSeqConfig
from hvqm4_tpu.encode import VideoEncoder as JaxVideoEncoder
from hvqm4_tpu.encode import encode_to_size as jax_encode_to_size
from hvqm4_tpu_torch import VideoEncoder, encode_to_size
from hvqm4_tpu_torch import encode as port_encode
from hvqm4_tpu_torch.config import SeqConfig
from hvqm4_tpu_torch.container import Demuxer
from hvqm4_tpu_torch.native import NativePlanner
from hvqm4_tpu_torch.refdec import decode_clip

from .conftest import golden_decode, run_oracle
from .test_encode import _synthetic_video

CFG, JCFG = SeqConfig(64, 48), JaxSeqConfig(64, 48)


def _translated_grid_video():
    """An I frame of per-block-constant random DCs (a nest rich in
    structure), then noisy translations of it: motion search finds the
    shift, and residual bases pay their bits."""
    rng = np.random.default_rng(11)
    dcs = rng.integers(40, 220, (12 + 4, 16 + 4)).astype(np.uint8)
    base = np.kron(dcs, np.ones((4, 4), np.uint8))
    frames = []
    for t in range(4):
        y = base[2 * t:2 * t + 48, 3 * t:3 * t + 64].astype(np.int32)
        if t:
            y = np.clip(y + rng.integers(-12, 13, y.shape), 0, 255)
        frames.append([y.astype(np.uint8),
                       np.full(CFG.plane_shapes[1], 120, np.uint8),
                       np.full(CFG.plane_shapes[2], 130, np.uint8)])
    return frames


def _half_textured_video():
    rng = np.random.default_rng(17)
    h, w = CFG.plane_shapes[0]
    frames = []
    for t in range(4):
        y = np.full((h, w), 120, np.float64)
        y[:, : w // 2] += np.linspace(0, 30, w // 2)[None, :]
        y[:, w // 2:] += rng.normal(0, 40, (h, w // 2))
        frames.append([np.clip(y + t, 0, 255).astype(np.uint8),
                       np.full(CFG.plane_shapes[1], 110, np.uint8),
                       np.full(CFG.plane_shapes[1], 140, np.uint8)])
    return frames


def _pcm(n_frames: int, rate: int = 32000) -> np.ndarray:
    t = np.arange(round(n_frames * 33366e-6 * rate))[:, None]
    return (7000 * np.sin(0.02 * t + np.arange(2)[None, :])).astype(np.int16)


# name -> (frames, gops, constructor keywords, encode keywords)
CASES = {
    "ippp": (lambda: _synthetic_video(CFG, 4), ["IPPP"],
             dict(lambda_bits=2.0), {}),
    "ibpbp": (lambda: _synthetic_video(CFG, 5), ["IBPBP"],
              dict(lambda_bits=2.0), {}),
    "slices3": (lambda: _synthetic_video(CFG, 5, seed=7), ["IPBPB"],
                dict(seed=0, slices=3), {}),
    "dc_shift2": (lambda: _synthetic_video(CFG, 5, seed=21), ["IPBPB"],
                  dict(seed=0, dc_shift=2), {}),
    "psy1": (_half_textured_video, ["IPPP"],
             dict(lambda_bits=8.0, seed=0, psy=1.0), {}),
    "audio2": (lambda: _synthetic_video(CFG, 6, seed=5), ["IPP", "IPP"],
               dict(seed=0), dict(audio=_pcm(6), audio_rate=32000)),
    "inter_residuals": (_translated_grid_video, ["IPPP"], dict(seed=2), {}),
    "target_bytes": (lambda: _synthetic_video(CFG, 9, seed=23),
                     ["IPP", "IPP", "IPP"], dict(lambda_bits=0.5, seed=0),
                     dict(target_bytes=2600, usec_per_frame=40000)),
}


@pytest.fixture(scope="module",
                params=[(c, s) for c in CASES for s in (False, True)],
                ids=lambda p: f"{p[0]}-{'full' if p[1] else 'sampled'}")
def encoded(request):
    """One encode by each package per parameter set: (name, the JAX
    encoder and its clip, the port's encoder and its clip)."""
    name, search = request.param
    make, gops, ctor, kw = CASES[name]
    frames = make()
    jenc = JaxVideoEncoder(JCFG, use_tpu_search=search, **ctor)
    jclip = jenc.encode(frames, gops, **kw)
    enc = VideoEncoder(CFG, use_tpu_search=search, device="cpu", **ctor)
    clip = enc.encode(frames, gops, **kw)
    return name, jenc, jclip, enc, clip


def test_encode_bytes_match_jax(encoded):
    name, jenc, jclip, enc, clip = encoded
    assert clip == jclip
    assert enc.lam == jenc.lam
    if name == "target_bytes":
        assert enc.lam != 0.5            # the controller moved lambda
    info = Demuxer(clip).info
    assert info.cfg == CFG
    assert info.audio_channels == (2 if name == "audio2" else 0)


def test_port_stream_decodes_identically_everywhere(encoded, oracle_bin,
                                                    tmp_path):
    """The C oracle, the port's golden decoder over the C++ planner, and
    the JAX package's over the Python planner."""
    _name, _jenc, _jclip, _enc, clip = encoded
    want = run_oracle(oracle_bin, clip, tmp_path)
    got = b"".join(p.tobytes() for planes in decode_clip(CFG, clip)
                   for p in planes)
    assert got == want
    assert b"".join(f.tobytes() for f in golden_decode(JCFG, clip)) == want


def test_encoder_state_after_encode_matches_jax(encoded):
    """The closed loop over the C++ planner left the reconstruction that
    the JAX encoder's Python planner left: references, nest and the
    generator the sampled candidates are drawn from."""
    _name, jenc, _jclip, enc, _clip = encoded
    for mine, ref in ((enc.dec.ref_last, jenc.dec.ref_last),
                      (enc.dec.ref_prev, jenc.dec.ref_prev)):
        assert all(np.array_equal(a, b) for a, b in zip(mine, ref))
    assert np.array_equal(enc.dec.nest, jenc.dec.nest)
    assert enc.rng.integers(0, 1 << 30) == jenc.rng.integers(0, 1 << 30)


def test_cases_exercise_what_they_name():
    """The inter-residual case emits residual bases, the sliced case a
    sliced layout, the dc_shift case its shift, and B frames blend."""
    def plans(name, search=False):
        make, gops, ctor, kw = CASES[name]
        clip = VideoEncoder(CFG, use_tpu_search=search, device="cpu",
                            **ctor).encode(make(), gops, **kw)
        pl = NativePlanner(CFG)
        return clip, [pl.plan_frame(r.frame_char, r.payload)
                      for r in Demuxer(clip).video_records()]

    for search in (False, True):
        _clip, ps = plans("inter_residuals", search)
        assert sum(int(((p.cls == 1) & (p.mode > 0)).sum())
                   for plan in ps for p in plan.planes) > 0
    clip, ps = plans("slices3")
    rec = next(iter(Demuxer(clip).video_records()))
    assert rec.payload[9] == 3           # slice count in the frame header
    _clip, ps = plans("dc_shift2")
    assert all(p.dc_shift == 2 for p in ps)
    _clip, ps = plans("ibpbp")
    assert [p.ftype for p in ps] == ["I", "P", "B", "P", "B"]
    assert any(int((p.planes[0].refsel == 2).sum()) for p in ps)


@pytest.mark.parametrize("search", [False, True], ids=["sampled", "full"])
def test_encode_to_size_matches_jax(search, oracle_bin, tmp_path):
    frames = _synthetic_video(CFG, 3, seed=9)
    gops = ["IPB"]
    sizes = [len(VideoEncoder(CFG, lambda_bits=lam).encode(frames, gops))
             for lam in (0.25, 64.0)]
    assert sizes[1] < sizes[0]
    target = sum(sizes) // 2
    jclip, jlam = jax_encode_to_size(JCFG, frames, gops, target,
                                     tolerance=0.08, use_tpu_search=search)
    clip, lam = encode_to_size(CFG, frames, gops, target, tolerance=0.08,
                               use_tpu_search=search, device="cpu")
    assert clip == jclip and lam == jlam
    assert 0.25 <= lam <= 64.0
    assert run_oracle(oracle_bin, clip, tmp_path) == b"".join(
        p.tobytes() for planes in decode_clip(CFG, clip) for p in planes)
    with pytest.raises(ValueError, match="iters must be >= 1"):
        encode_to_size(CFG, frames, gops, target, iters=0)


def test_encode_to_size_builds_the_planner_library_once(monkeypatch):
    """Each probe pass constructs an encoder, hence a `NativePlanner`: the
    library is built and loaded once per process, not once per pass."""
    from hvqm4_tpu_torch import native

    native.NativePlanner(CFG)            # loaded before the count starts
    calls = []
    monkeypatch.setattr(native, "build",
                        lambda: calls.append(1) or native.library_path())
    frames = _synthetic_video(CFG, 1, seed=9)
    encode_to_size(CFG, frames, ["I"], 10, iters=2)
    assert calls == []


def test_encoder_closed_loop_matches_decoder():
    """The encoder's internal reconstruction IS the decoder output (no drift)."""
    frames = _synthetic_video(CFG, 4, seed=3)
    enc = VideoEncoder(CFG)
    clip = enc.encode(frames, ["IPPP"])
    decoded = list(decode_clip(CFG, clip))
    # encoder's final ref_last should equal the last decoded I/P frame
    assert all(np.array_equal(a, b)
               for a, b in zip(enc.dec.ref_last, decoded[-1]))


@pytest.mark.parametrize("kwargs,frames,gops,message", [
    (dict(dc_shift=8), 1, ["I"], "dc_shift must be in [0, 7]"),
    (dict(slices=7), 1, ["I"], "slice count must be in [1, 6]"),
    ({}, 2, ["IPP"], "gop pattern length != frame count"),
    ({}, 2, ["IB"], "B frame without two preceding references"),
])
def test_refusals_match_jax(kwargs, frames, gops, message):
    src = _synthetic_video(CFG, frames)
    errors = []
    for ctor, cfg in ((JaxVideoEncoder, JCFG), (VideoEncoder, CFG)):
        with pytest.raises(ValueError) as e:
            ctor(cfg, **kwargs).encode(src, gops)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and message in errors[1]


def test_port_encoder_uses_its_own_modules():
    assert port_encode.NativePlanner is NativePlanner
    assert port_encode.HuffWriter.__module__ == "hvqm4_tpu_torch.bitio"
    assert port_encode.build_nest.__module__ == "hvqm4_tpu_torch.plans"
    assert port_encode.GoldenDecoder.__module__ == "hvqm4_tpu_torch.refdec"
