"""`data.FrameBatchLoader` of the port on the CPU against the JAX class: RGB
batches exact before the resize (integer colour conversion, then one
division by 255), within 1e-5 after it (`F.interpolate` against
`jax.image.resize`), the same `valid` lists and the same display-order
delivery; and the loader's batches feed a module under training.
"""

import inspect

import numpy as np
import pytest
import torch

import hvqm4_tpu_torch
from hvqm4_tpu.config import SeqConfig as JaxSeqConfig
from hvqm4_tpu.data import FrameBatchLoader as JaxLoader
from hvqm4_tpu_torch.config import SeqConfig
from hvqm4_tpu_torch.data import FrameBatchLoader
from hvqm4_tpu_torch.ops.csc import upsample_chroma, yuv_to_rgb
from hvqm4_tpu_torch.parallel.multistream import MultiStreamDecoder
from hvqm4_tpu_torch.session import DecoderSession
from tools.encoder import make_clip

from .test_torch_pipeline import poison_second_record

torch.set_num_threads(1)

CFG = SeqConfig(64, 48)
JCFG = JaxSeqConfig(64, 48)


def both(cfg, clips, **kw):
    jcfg = JaxSeqConfig(cfg.width, cfg.height, cfg.h_samp, cfg.v_samp)
    return (JaxLoader(jcfg, clips, **kw),
            FrameBatchLoader(cfg, clips, device="cpu", **kw))


# 72 is 8 mod 16: on the card that width takes the csc kernel's general
# variant, 64 the vector one; 4:4:4 has no chroma upsampling
@pytest.mark.parametrize("w,h,samp", [(64, 48, 2), (72, 48, 2), (48, 64, 1)])
@pytest.mark.parametrize("plan_ahead", [1, 2])
def test_loader_full_size_is_exact(w, h, samp, plan_ahead):
    cfg = SeqConfig(w, h, samp, samp)
    clips = [make_clip(cfg, ["IPB"], seed=s) for s in range(2)]
    jl = JaxLoader(JaxSeqConfig(w, h, samp, samp), clips)
    tl = FrameBatchLoader(cfg, clips, device="cpu", plan_ahead=plan_ahead)
    want, got = list(jl), list(tl)
    assert len(got) == len(want) == 3
    # the same frames through the session and the plain colour formula
    alone = [[yuv_to_rgb(f.planes[0], *(upsample_chroma(c, samp, samp)
                                        for c in f.planes[1:]))
              for f in DecoderSession(cfg, "cpu").decode_clip(c)]
             for c in clips]
    for st, ((wb, wv), (gb, gv)) in enumerate(zip(want, got)):
        assert gv == list(wv) == [True, True]
        assert gb.dtype == torch.float32 and gb.shape == (2, h, w, 3)
        assert 0.0 <= float(gb.min()) and float(gb.max()) <= 1.0
        g255 = np.rint(gb.numpy() * 255.0)
        assert np.array_equal(g255, np.rint(np.asarray(wb) * 255.0)), st
        for si in range(2):
            assert np.array_equal(g255[si], alone[si][st].numpy()), (st, si)


@pytest.mark.parametrize("image_size", [32, 80])
def test_loader_resized_matches_jax(image_size):
    """Down (antialiased, as `jax.image.resize`) and up."""
    clips = [make_clip(CFG, ["IPB"], seed=s) for s in range(2)]
    jl, tl = both(CFG, clips, image_size=image_size)
    want, got = list(jl), list(tl)
    assert len(got) == len(want) == 3
    for (wb, wv), (gb, gv) in zip(want, got):
        assert gv == list(wv) == [True, True]
        assert gb.shape == (2, image_size, image_size, 3)
        assert gb.min() >= 0.0 and gb.max() <= 1.0
        assert np.abs(gb.numpy() - np.asarray(wb)).max() <= 1e-5


def test_loader_valid_lists_match_jax_unequal_and_poisoned():
    """A short stream ends early and a poisoned one drops out: the `valid`
    lists are JAX's, and the live streams' pixels too."""
    clips = [make_clip(CFG, ["IPBPB"], seed=3), make_clip(CFG, ["IP"], seed=4),
             poison_second_record(make_clip(CFG, ["IPB"], seed=5))]
    jl, tl = both(CFG, clips)
    want, got = list(jl), list(tl)
    assert [gv for _b, gv in got] == [list(wv) for _b, wv in want]
    assert [gv for _b, gv in got] == [[True, True, True],
                                      [True, True, False]] + [[True, False,
                                                               False]] * 3
    for (wb, _wv), (gb, gv) in zip(want, got):
        live = [si for si, ok in enumerate(gv) if ok]
        assert np.array_equal(np.rint(gb.numpy()[live] * 255.0),
                              np.rint(np.asarray(wb)[live] * 255.0))


@pytest.mark.parametrize("plan_ahead", [1, 2])
def test_loader_display_order_matches_jax(plan_ahead):
    """Two streams of unequal length with B frames: the same
    `(stream, display id)` sequence as the JAX loader's, every id of every
    stream once and in order, each frame within 1e-5."""
    clips = [make_clip(CFG, ["IBPBP"], seed=7), make_clip(CFG, ["IBP"], seed=8)]
    jl = JaxLoader(JCFG, clips, image_size=16, display_order=True)
    tl = FrameBatchLoader(CFG, clips, image_size=16, device="cpu",
                          display_order=True, plan_ahead=plan_ahead)
    want, got = list(jl), list(tl)
    assert [[si for si, _f in r] for r in got] \
        == [[si for si, _f in r] for r in want]
    assert all(len(r) > 0 for r in got)
    for rg, rw in zip(got, want):
        for (_si, fg), (_sj, fw) in zip(rg, rw):
            assert fg.shape == (16, 16, 3) and fg.dtype == torch.float32
            assert np.abs(fg.numpy() - np.asarray(fw)).max() <= 1e-5
    # delivery is display order: each frame equals the decode-order batch's
    # frame with that display id
    dec = FrameBatchLoader(CFG, clips, image_size=16, device="cpu")
    by_id = [dict(), dict()]
    for (batch, valid), (_f, metas, _v) in zip(
            dec, MultiStreamDecoder(CFG, clips, "cpu").run_pipelined()):
        for si, ok in enumerate(valid):
            if ok:
                by_id[si][metas[si].display_id] = batch[si]
    seen = [[], []]
    for ready in got:
        for si, frame in ready:
            disp = len(seen[si])
            assert torch.equal(frame, by_id[si][disp]), (si, disp)
            seen[si].append(disp)
    assert [len(s) for s in seen] == [5, 3]


def test_loader_display_order_drains_a_gap():
    """A stream whose second frame is lost keeps what it decoded before the
    fault and the final drain hands out anything still held back."""
    clips = [make_clip(CFG, ["IBP"], seed=9),
             poison_second_record(make_clip(CFG, ["IBP"], seed=10))]
    jl = JaxLoader(JCFG, clips, display_order=True)
    tl = FrameBatchLoader(CFG, clips, device="cpu", display_order=True)
    want, got = list(jl), list(tl)
    assert [[si for si, _f in r] for r in got] \
        == [[si for si, _f in r] for r in want]
    assert sum(si == 0 for r in got for si, _f in r) == 3
    assert sum(si == 1 for r in got for si, _f in r) == 1


@pytest.mark.parametrize("image_size", [None, 32])
def test_loader_batches_feed_training_and_leave_grad_mode(image_size):
    """After a batch was taken the caller's grad mode is untouched (the
    loader's grad-free region closes before its `yield`), and the batch is an
    ordinary tensor that a module under training accepts."""
    clips = [make_clip(CFG, ["IPB"], seed=s) for s in range(2)]
    loader = FrameBatchLoader(CFG, clips, image_size=image_size, device="cpu")
    it = iter(loader)
    rgb, valid = next(it)
    assert torch.is_grad_enabled()
    assert not torch.is_inference_mode_enabled()
    assert not rgb.is_inference() and not rgb.requires_grad
    layer = torch.nn.Linear(3, 1)
    layer(rgb).sum().backward()
    assert layer.weight.grad is not None and valid == [True, True]
    rgb2, _valid = next(it)                    # and again after a backward
    assert torch.is_grad_enabled() and not rgb2.is_inference()
    it.close()


def test_loader_signature_and_default_device():
    """Only the listed options; `cuda` by default, refused without a card;
    exported lazily from the package."""
    sig = inspect.signature(FrameBatchLoader.__init__)
    assert list(sig.parameters) == ["self", "cfg", "clips", "image_size",
                                    "device", "display_order", "plan_ahead",
                                    "mesh"]
    assert sig.parameters["device"].default == "cuda"
    assert hvqm4_tpu_torch.FrameBatchLoader is FrameBatchLoader
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FrameBatchLoader(CFG, [make_clip(CFG, ["I"], seed=1)])
