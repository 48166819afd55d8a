"""`pipeline.VideoEmbedPipeline` of the port on the CPU against the JAX
class: the same clips and the same ViT weights (made once by the JAX
`init_vit`, carried across by `convert.vit_params_to_torch`) give the same
`valid`, the same metas and embeddings within the ViT's bound (max abs 2e-2,
cosine 0.9999: the two run bf16 products in different orders).
"""

import inspect
import struct

import jax
import numpy as np
import pytest
import torch

import hvqm4_tpu_torch
from hvqm4_tpu.config import SeqConfig as JaxSeqConfig
from hvqm4_tpu.models import vit as jvit
from hvqm4_tpu.pipeline import VideoEmbedPipeline as JaxPipeline
from hvqm4_tpu_torch.config import SeqConfig
from hvqm4_tpu_torch.container import Demuxer
from hvqm4_tpu_torch.convert import vit_params_to_torch
from hvqm4_tpu_torch.models.vit import ViT, ViTConfig
from hvqm4_tpu_torch.ops.csc import frame_to_rgb, resize_bilinear
from hvqm4_tpu_torch.parallel.multistream import MultiStreamDecoder
from hvqm4_tpu_torch.pipeline import VideoEmbedPipeline, embed_frames
from tools.encoder import make_clip

torch.set_num_threads(1)

CFG = SeqConfig(64, 48)
JCFG = JaxSeqConfig(64, 48)
VIT_ARGS = dict(image_size=64, patch_size=8, dim=128, depth=2, heads=4)
VIT = ViTConfig(**VIT_ARGS)
JVIT = jvit.ViTConfig(**VIT_ARGS)


@pytest.fixture(scope="module")
def clips():
    return [make_clip(CFG, ["IPB"], seed=s) for s in range(3)]


@pytest.fixture(scope="module")
def jax_params():
    return jvit.init_vit(JVIT, jax.random.key(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return vit_params_to_torch(jax.tree_util.tree_map(np.asarray, jax_params),
                               "cpu")


def poison_second_record(clip: bytes) -> bytes:
    """The clip's second video record gets a stream-size entry of
    0xFFFFFFFF: every planner rejects it, so the stream is poisoned from
    its second step on."""
    first = next(Demuxer(clip).video_records())
    sizes_off = 0x44 + 8 + 8 + len(first.payload) + 8 + 12
    out = bytearray(clip)
    struct.pack_into(">I", out, sizes_off, 0xFFFFFFFF)
    return bytes(out)


def run_jax(clips, jax_params, pipelined=True):
    pipe = JaxPipeline(JCFG, clips, JVIT, params=jax_params)
    return [(np.asarray(e), metas, valid)
            for e, metas, valid in pipe.run(pipelined=pipelined)]


def run_port(clips, params, pipelined=True, plan_ahead=1):
    pipe = VideoEmbedPipeline(CFG, clips, VIT, params, "cpu",
                              plan_ahead=plan_ahead)
    out = []
    for e, metas, valid in pipe.run(pipelined=pipelined):
        assert e.dtype == torch.float32 and e.device.type == "cpu"
        assert not e.requires_grad and not e.is_inference()
        out.append((e.numpy(), metas, valid))
    return out


def assert_within_vit_bound(got, want, what=""):
    assert np.abs(got - want).max() <= 2e-2, what
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert (cos >= 0.9999).all(), (what, cos)


def assert_steps_match(got, want):
    assert len(got) == len(want)
    for st, ((ge, gm, gv), (we, wm, wv)) in enumerate(zip(got, want)):
        assert list(gv) == list(wv), st
        assert ([m and (m.ftype, m.display_id) for m in gm]
                == [m and (m.ftype, m.display_id) for m in wm]), st
        assert ge.shape == we.shape == (len(gv), VIT.dim)
        assert np.isfinite(ge).all()
        live = [si for si, ok in enumerate(gv) if ok]
        assert_within_vit_bound(ge[live], we[live], st)


@pytest.mark.parametrize("pipelined,plan_ahead",
                         [(False, 1), (True, 1), (True, 2)])
def test_pipeline_matches_jax(clips, jax_params, params, pipelined,
                              plan_ahead):
    want = run_jax(clips, jax_params, pipelined)
    got = run_port(clips, params, pipelined, plan_ahead)
    assert len(got) == 3 and all(v == [True] * 3 for _e, _m, v in got)
    assert [m[0].ftype for _e, m, _v in got] == ["I", "P", "B"]
    assert_steps_match(got, want)


@pytest.mark.parametrize("pipelined,plan_ahead",
                         [(False, 1), (True, 1), (True, 2)])
def test_pipeline_is_deterministic(clips, params, pipelined, plan_ahead):
    """Two runs of the port give the same embeddings bit for bit, and so
    do the pipelined and the stepwise run."""
    a = run_port(clips, params, pipelined, plan_ahead)
    b = run_port(clips, params, pipelined, plan_ahead)
    c = run_port(clips, params, pipelined=False)
    for (ea, _ma, va), (eb, _mb, vb), (ec, _mc, vc) in zip(a, b, c):
        assert va == vb == vc
        assert np.array_equal(ea, eb) and np.array_equal(ea, ec)


@pytest.mark.parametrize("pipelined,plan_ahead", [(False, 1), (True, 2)])
def test_pipeline_poisoned_stream_matches_jax(clips, jax_params, params,
                                              pipelined, plan_ahead):
    """A stream whose second record does not plan: its `valid` goes false
    where JAX's does, and the other streams' embeddings are the ones of the
    run without the fault, bit for bit."""
    bad = [clips[0], poison_second_record(clips[1]), clips[2]]
    want = run_jax(bad, jax_params, pipelined)
    got = run_port(bad, params, pipelined, plan_ahead)
    assert_steps_match(got, want)
    assert [v[1] for _e, _m, v in got] == [True, False, False]
    clean = run_port(clips, params, pipelined, plan_ahead)
    for (ge, _gm, _gv), (ce, _cm, _cv) in zip(got, clean):
        assert np.array_equal(ge[[0, 2]], ce[[0, 2]])


def test_embed_is_the_three_calls_on_the_whole_batch(clips, params):
    """`embed_frames` is `frame_to_rgb` → `resize_bilinear` → `ViT.forward`
    over all N streams at once; the batched resize equals N single calls
    exactly, and the batched embedding a per-frame one within the bound."""
    model = ViT(VIT)
    model.load_state_dict(params)
    ms = MultiStreamDecoder(CFG, clips, "cpu")
    frames, _metas, _valid = ms.step()
    rgb = frame_to_rgb(frames, CFG.h_samp, CFG.v_samp)
    assert rgb.shape == (3, 48, 64, 3) and rgb.dtype == torch.uint8
    imgs = resize_bilinear(rgb, 64, 64)
    for si in range(3):
        assert torch.equal(imgs[si], resize_bilinear(rgb[si], 64, 64))
    got = embed_frames(model, frames, CFG.h_samp, CFG.v_samp)
    assert torch.equal(got, model(imgs))
    single = torch.cat([model(imgs[si:si + 1]) for si in range(3)])
    assert_within_vit_bound(got.numpy(), single.numpy())


def test_pipeline_leaves_the_callers_grad_mode_alone(clips, params):
    it = VideoEmbedPipeline(CFG, clips, VIT, params, "cpu").run()
    emb, _metas, _valid = next(it)
    assert torch.is_grad_enabled()
    assert not torch.is_inference_mode_enabled()
    head = torch.nn.Linear(VIT.dim, 1)
    head(emb).sum().backward()          # a probe trained on the embeddings
    assert head.weight.grad is not None
    it.close()


def test_pipeline_default_weights_and_seed(clips):
    """No `params`: weights drawn from `rng_seed`, the same for the same
    seed; and the default ViT config when none is given."""
    def first(seed):
        pipe = VideoEmbedPipeline(CFG, clips[:1], VIT, device="cpu",
                                  rng_seed=seed)
        return next(pipe.run(pipelined=False))[0]

    a, b, c = first(0), first(0), first(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    pipe = VideoEmbedPipeline(CFG, clips[:1], device="cpu")
    assert pipe.vit_cfg == ViTConfig() and pipe.decoder.n == 1


def test_pipeline_signature_and_default_device(clips):
    """Only the listed options; `cuda` by default, refused without a card;
    exported lazily from the package."""
    sig = inspect.signature(VideoEmbedPipeline.__init__)
    assert list(sig.parameters) == ["self", "cfg", "clips", "vit_cfg",
                                    "params", "device", "rng_seed",
                                    "plan_ahead", "mesh"]
    assert sig.parameters["device"].default == "cuda"
    assert hvqm4_tpu_torch.VideoEmbedPipeline is VideoEmbedPipeline
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VideoEmbedPipeline(CFG, clips, VIT)
