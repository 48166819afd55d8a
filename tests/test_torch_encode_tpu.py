"""The port's full-nest search (`encode_tpu.NestSearch`, PyTorch, here on
`device="cpu"`) against the JAX package's: the same nest and the same
residuals, made from a numpy seed, give the same descriptors, terms and
scales. Integer data, compared exactly.
"""

import numpy as np
import pytest
import torch

from hvqm4_tpu.encode_tpu import NestSearch as JaxNestSearch
from hvqm4_tpu.encode_tpu import _all_candidates as jax_all_candidates
from hvqm4_tpu_torch.config import SeqConfig
from hvqm4_tpu_torch.encode import VideoEncoder, _CandidateSet
from hvqm4_tpu_torch.encode_tpu import TILE, NestSearch, _all_candidates
from hvqm4_tpu_torch.refdec import decode_clip

from .conftest import run_oracle
from .test_encode import _synthetic_video


def _nest(kind: str, shape=(38, 70)) -> np.ndarray:
    rng = np.random.default_rng(len(kind))
    nh, nw = shape
    if kind == "random":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if kind == "ramp":
        # smooth: many candidates are shifts of one another, so gains tie
        return ((np.arange(nh)[:, None] * 3 + np.arange(nw)[None, :] * 2)
                % 256).astype(np.uint8)
    if kind == "steps":
        # two levels in wide bands: most candidates repeat exactly
        return np.where((np.arange(nw)[None, :] // 9
                         + np.arange(nh)[:, None] // 7) % 2, 90, 160
                        ).astype(np.uint8)
    assert kind == "constant"
    return np.full(shape, 77, np.uint8)


@pytest.mark.parametrize("kind,shape", [
    ("random", (38, 70)), ("ramp", (38, 70)), ("steps", (70, 38)),
    ("constant", (38, 70))])
def test_all_candidates_match_jax(kind, shape):
    nest = _nest(kind, shape)
    desc, C = _all_candidates(nest)
    jdesc, jC = jax_all_candidates(nest)
    assert desc.dtype == jdesc.dtype and C.dtype == jC.dtype
    assert np.array_equal(desc, jdesc) and np.array_equal(C, jC)
    assert (len(C) == 0) == (kind == "constant")


@pytest.fixture(scope="module", params=["random", "ramp", "steps"])
def searches(request):
    nest = _nest(request.param)
    return nest, NestSearch(nest, device="cpu"), JaxNestSearch(nest)


@pytest.mark.parametrize("B", [1, 64, TILE + 76])
def test_best_matches_jax(searches, B):
    """All three results equal, on random and on tie-rich nests, at one
    residual, a small batch and a batch above one candidate tile; the first
    residual is all zero (index 0, scale 0) and the second a candidate
    itself (an exact hit)."""
    _nest_arr, search, jsearch = searches
    assert search.ok and jsearch.ok
    rng = np.random.default_rng(B)
    resid = rng.integers(-300, 300, (B, 16)).astype(np.int32)
    resid[0] = 0
    if B > 1:
        resid[1] = search.C[len(search.C) // 2]
    desc, terms, scales = search.best(resid)
    jdesc, jterms, jscales = jsearch.best(resid)
    assert np.array_equal(desc, jdesc)
    assert np.array_equal(terms, jterms)
    assert np.array_equal(scales, jscales)
    assert terms.dtype == jterms.dtype and scales.dtype == jscales.dtype
    assert scales[0] == 0 and np.array_equal(desc[0], search.desc[0])
    assert not terms[0].any()


def test_constant_nest_is_not_ok():
    nest = _nest("constant")
    search, jsearch = NestSearch(nest, device="cpu"), JaxNestSearch(nest)
    assert not search.ok and not jsearch.ok
    assert len(search.C) == len(jsearch.C) == 0


def test_search_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NestSearch(_nest("random"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VideoEncoder(SeqConfig(64, 48), use_tpu_search=True)
    with pytest.raises(ValueError, match="unsupported device"):
        NestSearch(_nest("random"), device="meta")
    VideoEncoder(SeqConfig(64, 48))    # search off: no device is touched


@pytest.mark.parametrize("precision", ["highest", "high", "medium"])
def test_search_ignores_the_matmul_precision_global(precision):
    """The product is float64, which the f32 matmul precision does not
    reach: the picks do not move with the global (on the card the same
    test runs against TF32)."""
    nest = _nest("ramp")
    resid = np.random.default_rng(5).integers(-300, 300, (200, 16))
    want = JaxNestSearch(nest).best(resid)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        got = NestSearch(nest, device="cpu").best(resid)
    finally:
        torch.set_float32_matmul_precision(before)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


# -- the mirrors of tests/test_encode_tpu.py ---------------------------------

def test_full_search_at_least_as_good_as_sampled():
    rng = np.random.default_rng(0)
    nest = rng.integers(0, 256, (38, 70), dtype=np.uint8)
    search = NestSearch(nest, device="cpu")
    sampled = _CandidateSet(nest, np.random.default_rng(1))
    residuals = rng.integers(-120, 120, (64, 16)).astype(np.int32)
    _desc, terms, _scales = search.best(residuals)
    # terms are unshifted; the decoder applies >> 4 to the (single-basis) sum
    full_sse = ((residuals - (terms >> 4)) ** 2).sum(1)
    for i in range(len(residuals)):
        hit = sampled.best(residuals[i])
        assert hit is not None
        _b, term = hit
        samp_sse = int(((residuals[i] - (term >> 4)) ** 2).sum())
        # full search scores every candidate; float scoring ties resolve to
        # within one quantization step of the sampled pick
        assert full_sse[i] <= samp_sse + 16, (i, full_sse[i], samp_sse)


def test_full_search_terms_are_exact_decoder_integers():
    rng = np.random.default_rng(2)
    nest = rng.integers(0, 256, (38, 70), dtype=np.uint8)
    search = NestSearch(nest, device="cpu")
    residuals = rng.integers(-100, 100, (8, 16)).astype(np.int32)
    desc, terms, scales = search.best(residuals)
    nh, nw = nest.shape
    for i in range(len(residuals)):
        nx, ny, sxb, syb, off = (int(v) for v in desc[i])
        rows = (ny + np.arange(4) * (syb + 1)) % nh
        cols = (nx + np.arange(4) * (sxb + 1)) % nw
        v = nest[np.ix_(rows, cols)].astype(np.int32).reshape(16)
        # unshifted (sample - off) * scale: the decoder shifts the SUM over
        # a block's bases once (FORMAT.md §6.2)
        want = (v - off) * int(scales[i])
        assert np.array_equal(terms[i], want)


def test_encode_with_device_search_roundtrips(oracle_bin, tmp_path):
    cfg = SeqConfig(64, 48)
    frames = _synthetic_video(cfg, 3, seed=5)
    clip = VideoEncoder(cfg, lambda_bits=2.0, use_tpu_search=True,
                        device="cpu").encode(frames, ["IPP"])
    oracle_yuv = run_oracle(oracle_bin, clip, tmp_path)
    got = b"".join(p.tobytes() for planes in decode_clip(cfg, clip)
                   for p in planes)
    assert got == oracle_yuv
