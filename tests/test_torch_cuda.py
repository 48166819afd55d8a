"""On the card: the CUDA kernels against their plain versions, the session
and the arena decoder on `cuda` against the C oracle and the CPU, the
decode service on `cuda`, unbatched and batched, against the same service
on the CPU, the loader and the embedding pipeline on `cuda` against the
same classes on the CPU, the encoder's full-nest search on `cuda` against
the same search on the CPU, and the training example's steps on `cuda`
against the same steps on the CPU.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so it also runs where JAX is not installed; tests/conftest.py
imports JAX, so run it there without the conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pathlib
import subprocess
import threading

import numpy as np
import pytest
import torch

from chip_smoke import (border_vectors, csc_planes, implicit_syncs,
                        random_plan)
from examples.train_vit_torch import (loss_fn, make_optimizer, make_probe,
                                      train_step, weight_of)
from hvqm4_tpu_torch import refdec, serve
from hvqm4_tpu_torch.convert import plan_to_torch
from hvqm4_tpu_torch.config import SeqConfig
from hvqm4_tpu_torch.data import FrameBatchLoader
from hvqm4_tpu_torch.encode import VideoEncoder
from hvqm4_tpu_torch.encode_tpu import NestSearch
from hvqm4_tpu_torch.kernels import _build
from hvqm4_tpu_torch.kernels.csc import (YUV_TO_RGB, _vector_ok, yuv_to_rgb,
                                         yuv_to_rgb_plain)
from hvqm4_tpu_torch.kernels.inter import inter_combine, inter_combine_plain
from hvqm4_tpu_torch.kernels.intra import intra_synth, intra_synth_plain
from hvqm4_tpu_torch.models.vit import ViTConfig, init_vit
from hvqm4_tpu_torch.parallel.dist import launch
from hvqm4_tpu_torch.parallel.multistream import MultiStreamDecoder
from hvqm4_tpu_torch.pipeline import VideoEmbedPipeline
from hvqm4_tpu_torch.session import DecoderSession
from hvqm4_tpu_torch.utils.hashing import batch_csum, oracle_csums
from tools.encoder_torch import make_clip

from .torch_sharded_ranks import steps_rank

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _plan(rng, bh, bw, n, mv_grid):
    """chip_smoke's random plans: raw blocks sprinkled in, every refsel,
    vectors on a per-block or per-MB grid, some far outside the plane."""
    grid = (bh, bw) if mv_grid == "block" else (bh // 2, bw // 2)
    return random_plan(rng, bh, bw, n, grid)


# (n or None for no stream axis, bh, bw, nest, vector grid): grids whose
# width is no multiple of a warp's 32 blocks and whose height is no
# multiple of a thread block's 8 rows (7 and 5, 45 and 13, 46 and 14),
# both nests, per-block and per-MB vectors, and the 640x480 grids at
# N = 1, 8 and 33. Random descriptors reach nest offsets up to 127, beyond
# both nest sides, so the modular addressing wraps.
CASES = [(None, 5, 7, (38, 70), "block"), (3, 12, 16, (70, 38), "mb"),
         (8, 120, 160, (38, 70), "mb"), (8, 60, 80, (70, 38), "block"),
         (1, 13, 45, (70, 38), "block"), (33, 14, 46, (38, 70), "mb"),
         (1, 120, 160, (70, 38), "block"), (33, 60, 80, (38, 70), "block")]


@pytest.mark.cuda
@pytest.mark.parametrize("n,bh,bw,nest_shape,mv_grid", CASES)
def test_cuda_kernels_match_plain(cuda, n, bh, bw, nest_shape, mv_grid):
    rng = np.random.default_rng(bh + bw)
    p = _plan(rng, bh, bw, n or 1, mv_grid)
    lead = (n,) if n else ()
    if not n:
        p = {k: v[0] for k, v in p.items()}
    tp = plan_to_torch(p, cuda)
    nest = torch.from_numpy(rng.integers(0, 256, (*lead, *nest_shape),
                                         dtype=np.uint8)).to(cuda)
    ref0, ref1 = (torch.from_numpy(rng.integers(
        0, 256, (*lead, bh * 4, bw * 4), dtype=np.uint8)).to(cuda)
        for _ in range(2))
    before = [k.launches for k in _build.kernels()]
    want_px, want_acc = intra_synth_plain(tp, nest)
    px, acc = intra_synth(tp, nest, want_acc=True)
    px_noacc, none = intra_synth(tp, nest, want_acc=False)
    out = inter_combine(tp, px, acc, ref0, ref1)
    torch.cuda.synchronize()
    assert none is None
    assert torch.equal(px, want_px) and torch.equal(px_noacc, want_px)
    assert torch.equal(acc, want_acc)
    assert torch.equal(out, inter_combine_plain(tp, want_px, want_acc,
                                                ref0, ref1))
    assert [k.launches - b for k, b in zip(_build.kernels(), before)] \
        == [1, 1, 1, 0]  # noacc, acc, inter; no yuv_to_rgb


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8])
def test_cuda_inter_windows_at_every_border(cuda, n):
    """Every block inter, with vectors of -9..9 in every half-pel phase, so
    that the windows of the blocks along each border straddle it, and
    backward vectors of +-2,000: the clamped path against the plain one."""
    rng = np.random.default_rng(40 + n)
    tp = plan_to_torch(border_vectors(rng, random_plan(rng, 12, 20, n,
                                                       (12, 20))), cuda)
    nest = torch.from_numpy(rng.integers(0, 256, (n, 38, 70),
                                         dtype=np.uint8)).to(cuda)
    ref0, ref1 = (torch.from_numpy(rng.integers(
        0, 256, (n, 48, 80), dtype=np.uint8)).to(cuda) for _ in range(2))
    px, acc = intra_synth_plain(tp, nest)
    got = inter_combine(tp, px, acc, ref0, ref1)
    torch.cuda.synchronize()
    assert torch.equal(got, inter_combine_plain(tp, px, acc, ref0, ref1))


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_inputs(cuda):
    rng = np.random.default_rng(3)
    tp = plan_to_torch(_plan(rng, 4, 4, 2, "block"), cuda)
    nest = torch.zeros((2, 38, 70), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="desc"):
        intra_synth({**tp, "desc": tp["desc"].long()}, nest)
    with pytest.raises(ValueError, match="contiguous"):
        intra_synth(tp, nest.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="nest"):
        intra_synth(tp, torch.zeros((2, 80, 80), dtype=torch.uint8,
                                    device=cuda))
    px, acc = intra_synth(tp, nest)
    with pytest.raises(ValueError, match="ref1"):
        inter_combine(tp, px, acc, px, px.cpu())
    fine = torch.zeros((2, 2, 16, 16), dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError, match="finer than the 4x4 blocks"):
        inter_combine({**tp, "mv": fine, "mv2": fine}, px, acc, px, px)
    words = torch.empty(acc.numel() + 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="acc: .* multiple of 16 bytes"):
        inter_combine(tp, px, words[1:].view(acc.shape), px, px)
    u8 = torch.empty(px.numel() + 1, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="ref0: .* multiple of 4 bytes"):
        inter_combine(tp, px, acc, u8[1:].view(px.shape), px)


@pytest.mark.cuda
def test_cuda_session_matches_oracle(cuda, tmp_path):
    subprocess.run(["make", "-s", "-C", str(REPO / "oracle")], check=True)
    cases = [(64, 48, 2, ["IPBPB", "IPP"], 1, False),
             (48, 64, 1, ["IPBPB"], 2, False),
             (256, 192, 2, ["IP"], 79, False),   # > 2,048 luma blocks
             (64, 48, 2, ["IPBPB", "IPP"], 5, True)]
    for w, h, samp, gops, seed, mv_extreme in cases:
        cfg = SeqConfig(w, h, samp, samp)
        clip = make_clip(cfg, gops, seed=seed, mv_extreme=mv_extreme)
        inp, out = tmp_path / "c.h4m", tmp_path / "c.yuv"
        inp.write_bytes(clip)
        subprocess.run([str(REPO / "oracle" / "hvqm4_oracle"), str(inp),
                        str(out)], check=True)
        got = b"".join(f.yuv_bytes()
                       for f in DecoderSession(cfg, cuda).decode_clip(clip))
        assert got == out.read_bytes(), (w, h, gops, seed)


# (n, H, W, sampling, form, variant): `form` as in `chip_smoke.csc_planes`
# ("view", the last frame of a stack, starts aligned at 640x480 and not at
# the ragged sizes); `variant` is the kernel variant the case must take.
# 640x480 at N = 1, 8 and 64, both samplings; widths that are 8 mod 16 (72,
# 360, 632) and ragged sizes.
CSC_CASES = [(None, 36, 48, 2, "2d", "vector"),
             (3, 74, 102, 2, "stack", "general"),
             (2, 30, 26, 1, "stack", "general"),
             (1, 480, 640, 2, "stack", "vector"),
             (8, 480, 640, 2, "stack", "vector"),
             (64, 480, 640, 2, "stack", "vector"),
             (1, 480, 640, 1, "stack", "vector"),
             (8, 480, 640, 1, "stack", "vector"),
             (64, 480, 640, 1, "stack", "vector"),
             (3, 48, 72, 2, "stack", "general"),
             (2, 200, 360, 2, "stack", "general"),
             (8, 480, 632, 2, "stack", "general"),
             (8, 480, 632, 1, "stack", "general"),
             (3, 480, 640, 2, "view", "vector"),
             (3, 250, 90, 2, "view", "general"),
             (3, 30, 26, 1, "view", "general"),
             (1, 48, 64, 2, "offset", "general"),
             (1, 48, 64, 1, "offset", "general")]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,samp,form,variant", CSC_CASES)
def test_cuda_yuv_to_rgb_matches_plain(cuda, n, h, w, samp, form, variant):
    rng = np.random.default_rng(h + w + samp)
    y, u, v = csc_planes(rng, n, h, w, samp, form, cuda)
    before = YUV_TO_RGB.launches
    got = yuv_to_rgb(y, u, v, samp, samp)
    torch.cuda.synchronize()
    assert YUV_TO_RGB.launches == before + 1
    assert got.shape == (*y.shape, 3) and got.dtype == torch.uint8
    took = _vector_ok(w, samp, y.data_ptr(), u.data_ptr(), v.data_ptr(),
                      got.data_ptr())
    assert ("vector" if took else "general") == variant
    assert torch.equal(got, yuv_to_rgb_plain(y, u, v, samp, samp))


@pytest.mark.cuda
def test_cuda_yuv_to_rgb_rejects_bad_inputs(cuda):
    y = torch.zeros((2, 16, 16), dtype=torch.uint8, device=cuda)
    c = torch.zeros((2, 8, 8), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="u: expected"):
        yuv_to_rgb(y, c.int(), c, 2, 2)
    with pytest.raises(ValueError, match="contiguous"):
        yuv_to_rgb(y.transpose(1, 2).contiguous().transpose(1, 2), c, c, 2, 2)
    with pytest.raises(ValueError, match="v: expected"):
        yuv_to_rgb(y, c, c.cpu(), 2, 2)
    with pytest.raises(ValueError, match="sampling"):
        yuv_to_rgb(y, c, c, 2, 1)
    with pytest.raises(ValueError, match="chroma"):
        yuv_to_rgb(y, c, c, 1, 1)
    # the C entry refuses the vector variant on a base it cannot take
    flat = torch.zeros(16 * 16 + 1, dtype=torch.uint8, device=cuda)
    out = torch.empty((1, 16, 16, 3), dtype=torch.uint8, device=cuda)
    before = YUV_TO_RGB.launches
    with pytest.raises(RuntimeError, match="hvqm4_yuv_to_rgb: CUDA error"):
        YUV_TO_RGB(flat[1:].data_ptr(), c.data_ptr(), c.data_ptr(),
                   out.data_ptr(), 1, 16, 16, 1, 1, 1,
                   _build.stream_ptr(cuda))
    assert YUV_TO_RGB.launches == before


@pytest.mark.cuda
def test_cuda_serve_matches_cpu_serve(cuda):
    """YUV and RGB replies of the server on the card equal the CPU
    server's; embeddings agree within the ViT's bf16 tolerance."""
    from hvqm4_tpu_torch.models.vit import ViTConfig, init_vit

    vcfg = ViTConfig(32, 8, 64, 2, 4)
    servers = []
    for dev in (cuda, "cpu"):
        srv = serve.DecodeServer(("127.0.0.1", 0), device=dev, vit_cfg=vcfg)
        srv._vit = (vcfg, init_vit(vcfg, torch.Generator().manual_seed(1),
                                   dev))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
    try:
        clip = make_clip(SeqConfig(64, 48), ["IPBPB", "IP"], seed=8)
        gpu, cpu = ([serve.decode_remote(*s.server_address, clip, mode=m)
                     for m in (serve.MODE_YUV, serve.MODE_RGB,
                               serve.MODE_EMBED)] for s in servers)
        assert gpu[:2] == cpu[:2]
        assert len(gpu[2]) == len(cpu[2]) == 7
        for a, b in zip(gpu[2], cpu[2]):
            a, b = np.frombuffer(a, "<f4"), np.frombuffer(b, "<f4")
            assert np.abs(a - b).max() <= 2e-2
            assert a @ b / np.linalg.norm(a) / np.linalg.norm(b) >= 0.9999
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()


def _oracle():
    subprocess.run(["make", "-s", "-C", str(REPO / "oracle")], check=True)
    return REPO / "oracle" / "hvqm4_oracle"


def _arena_run(cfg, clips, dev, k, plan_ahead):
    """Every step of a pipelined arena run, kept on `dev` with no
    synchronisation in the loop: per step (frame copies, csums, valid)."""
    ms = MultiStreamDecoder(cfg, clips, dev, steps_per_dispatch=k,
                            plan_ahead=plan_ahead)
    return [([f.clone() for f in frames], batch_csum(*frames), valid)
            for frames, _metas, valid in ms.run_pipelined()]


def _csums(steps, n):
    per = [[] for _ in range(n)]
    for _frames, cs, valid in steps:
        cs = cs.cpu().tolist()
        for j in range(n):
            if valid[j]:
                per[j].append(f"{cs[j]:08x}")
    return per


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
def test_cuda_arena_matches_oracle_and_cpu(cuda, tmp_path, k):
    """The arena decoder on the card, plan_ahead 2 and a consumer that
    never waits for the card (so the planning workers refill pinned ring
    slots while earlier uploads may still be in flight): every frame's
    csum equals `oracle --csum`, and every frame equals the CPU arena's."""
    oracle = _oracle()
    cfg = SeqConfig(128, 96)
    clips = [make_clip(cfg, ["IBBPBP", "IPP"], seed=s) for s in (3, 4)]
    clips.append(make_clip(cfg, ["IPB"], seed=5))
    gpu = _arena_run(cfg, clips, cuda, k, 2)
    cpu = _arena_run(cfg, clips, "cpu", k, 2)
    assert len(gpu) == len(cpu)
    for (fg, _cg, vg), (fc, _cc, vc) in zip(gpu, cpu):
        assert vg == vc
        for a, b in zip(fg, fc):
            assert torch.equal(a.cpu(), b)
    want = []
    for i, clip in enumerate(clips):
        path = tmp_path / f"c{i}.h4m"
        path.write_bytes(clip)
        want.append(oracle_csums(oracle, path))
    assert _csums(gpu, len(clips)) == want
    # the 640x480 clips, 4 streams of each, against the oracle
    names = ["ref640.h4m", "retail640.h4m"] * 4
    data = {n: (REPO / "testdata" / n).read_bytes() for n in names}
    steps = _arena_run(SeqConfig(640, 480), [data[n] for n in names], cuda,
                       k, 2)
    assert _csums(steps, 8) == [oracle_csums(oracle, REPO / "testdata" / n)
                                for n in names]


@pytest.mark.cuda
def test_cuda_arena_random_640x480_clip_matches_oracle(cuda, tmp_path):
    """A random 640x480 clip of the port's generator (every block mode,
    forced escapes, mv_extreme vectors) through the arena decoder on the
    card at K=2: every frame's csum equals `oracle --csum`."""
    cfg = SeqConfig(640, 480)
    clip = make_clip(cfg, ["IPB"], seed=9201, mv_extreme=True,
                     audio_channels=1)
    path = tmp_path / "r.h4m"
    path.write_bytes(clip)
    steps = _arena_run(cfg, [clip, clip], cuda, 2, 2)
    want = oracle_csums(_oracle(), path)
    assert len(want) == 3 and _csums(steps, 2) == [want, want]


@pytest.mark.cuda
def test_cuda_batched_serve_matches_cpu_batched_serve(cuda):
    """Concurrent YUV and RGB requests and a poisoned clip through the
    batching server on the card and on the CPU: equal replies, the
    poisoned clip failing alone on both."""
    import struct

    cfg = SeqConfig(64, 48)
    clips = [make_clip(cfg, ["IPBPB", "IP"], seed=70 + i) for i in range(3)]
    bad = bytearray(make_clip(cfg, ["IPB", "IPB"], seed=73))
    (len0,) = struct.unpack_from(">I", bad, 0x44)
    struct.pack_into(">I", bad, 0x44 + 8 + len0 + 8 + 8 + 12, 0xFFFFFFFF)
    jobs = [(clips[0], serve.MODE_YUV), (clips[1], serve.MODE_RGB),
            (clips[2], serve.MODE_RGB), (bytes(bad), serve.MODE_YUV)]
    replies = []
    for dev in (cuda, "cpu"):
        srv = serve.DecodeServer(("127.0.0.1", 0), device=dev,
                                 batch_window_s=0.25, max_batch=4)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        out = {}

        def req(i, clip, mode, addr=srv.server_address, out=out):
            try:
                out[i] = serve.decode_remote(*addr, clip, mode=mode)
            except RuntimeError as e:
                out[i] = str(e)

        try:
            threads = [threading.Thread(target=req, args=(i, c, m))
                       for i, (c, m) in enumerate(jobs)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            metrics = serve.fetch_metrics(*srv.server_address)
        finally:
            srv.shutdown()
            srv.server_close()
        assert metrics["batched_requests"] == 4 and metrics["batches"] <= 2
        replies.append([out[i] for i in range(len(jobs))])
    gpu, cpu = replies
    assert gpu == cpu
    assert "poisoned" in gpu[3] and all(len(r) == 7 for r in gpu[:3])


def _consumer_clips(cfg):
    """Three streams with B frames, one shorter than the others."""
    clips = [make_clip(cfg, ["IBBPBP", "IPP"], seed=s) for s in (13, 14)]
    return clips + [make_clip(cfg, ["IBP"], seed=15)]


def _assert_same_pixels(got, want):
    """Full-size batches hold u8 / 255: the same pixel values exactly. The
    floats themselves may differ in the last bit, because the card divides
    by a scalar by multiplying with its reciprocal."""
    assert torch.equal((got * 255.0).round(), (want * 255.0).round())
    assert float((got - want).abs().max()) <= 1.2e-7


# 128 wide takes the csc kernel's vector variant, 72 (8 mod 16) the general
@pytest.mark.cuda
@pytest.mark.parametrize("w,h", [(128, 96), (72, 48)])
@pytest.mark.parametrize("image_size", [None, 32])
def test_cuda_loader_matches_cpu_loader(cuda, w, h, image_size):
    """The loader on the card at plan_ahead 2, its consumer never waiting
    for the card: RGB exact at full size, within 1e-5 resized, the same
    `valid`; one `yuv_to_rgb` launch a step."""
    cfg = SeqConfig(w, h)
    clips = _consumer_clips(cfg)
    before = YUV_TO_RGB.launches
    gpu = list(FrameBatchLoader(cfg, clips, image_size, cuda, plan_ahead=2))
    assert YUV_TO_RGB.launches - before == len(gpu) == 9
    cpu = list(FrameBatchLoader(cfg, clips, image_size, "cpu", plan_ahead=2))
    assert [v for _b, v in gpu] == [v for _b, v in cpu]
    for (bg, _vg), (bc, valid) in zip(gpu, cpu):
        assert bg.device.type == "cuda" and bg.dtype == torch.float32
        live = [si for si, ok in enumerate(valid) if ok]
        if image_size is None:
            _assert_same_pixels(bg.cpu()[live], bc[live])
        else:
            assert float((bg.cpu()[live] - bc[live]).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_cuda_loader_display_order_matches_cpu(cuda):
    cfg = SeqConfig(128, 96)
    clips = _consumer_clips(cfg)
    gpu = list(FrameBatchLoader(cfg, clips, device=cuda, display_order=True,
                                plan_ahead=2))
    cpu = list(FrameBatchLoader(cfg, clips, device="cpu", display_order=True))
    assert [[si for si, _f in r] for r in gpu] \
        == [[si for si, _f in r] for r in cpu]
    for rg, rc in zip(gpu, cpu):
        for (_si, fg), (_sj, fc) in zip(rg, rc):
            _assert_same_pixels(fg.cpu(), fc)
    assert sum(len(r) for r in gpu) == 9 + 9 + 3


@pytest.mark.cuda
@pytest.mark.parametrize("pipelined", [True, False])
def test_cuda_pipeline_matches_cpu_pipeline(cuda, pipelined):
    """Embeddings on the card within the ViT's gate (max abs 2e-2, cosine
    0.9999: bf16 products in another order) of the CPU's, from the same
    weights; plan_ahead 2 and no synchronisation in the consumer."""
    cfg = SeqConfig(128, 96)
    vit = ViTConfig(image_size=64, patch_size=8, dim=128, depth=2, heads=4)
    clips = _consumer_clips(cfg)
    ref = VideoEmbedPipeline(cfg, clips, vit, device="cpu", rng_seed=3)
    want = [(e.numpy(), v) for e, _m, v in ref.run(pipelined=pipelined)]
    before = YUV_TO_RGB.launches
    pipe = VideoEmbedPipeline(cfg, clips, vit, ref.model.state_dict(), cuda,
                              plan_ahead=2)
    got = [(e, v) for e, _m, v in pipe.run(pipelined=pipelined)]
    assert YUV_TO_RGB.launches - before == len(got) == len(want) == 9
    for (eg, vg), (ec, vc) in zip(got, want):
        assert vg == vc and eg.device.type == "cuda"
        assert eg.dtype == torch.float32 and tuple(eg.shape) == (3, 128)
        live = [si for si, ok in enumerate(vc) if ok]
        a, b = eg.cpu().numpy()[live], ec[live]
        assert np.isfinite(a).all() and np.abs(a - b).max() <= 2e-2
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                 * np.linalg.norm(b, axis=-1))
        assert (cos >= 0.9999).all()
    # the caller's grad mode is its own
    assert torch.is_grad_enabled() and not torch.is_inference_mode_enabled()


def _search_inputs(b: int, amp: int = 300):
    """A smooth, tie-rich nest and `b` residuals in [-amp, amp), the first
    all zero."""
    nest = ((np.arange(38)[:, None] * 3 + np.arange(70)[None, :] * 2)
            % 256).astype(np.uint8)
    resid = np.random.default_rng(b).integers(-amp, amp, (b, 16))
    resid[0] = 0
    return nest, resid.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 19200])
def test_cuda_nest_search_matches_cpu(cuda, b):
    """`NestSearch.best` on the card against the same torch code on the
    CPU, at one residual and at the luma blocks of a 640x480 frame: the
    same descriptors, terms and scales."""
    nest, resid = _search_inputs(b)
    got = NestSearch(nest, cuda).best(resid)
    want = NestSearch(nest, "cpu").best(resid)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert got[2][0] == 0 and not got[1][0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("tf32", [True, False])
def test_cuda_nest_search_ignores_tf32(cuda, tf32):
    """With TF32 allowed for f32 products, by both of PyTorch's globals,
    the search still picks what the CPU picks: its product is float64.
    TF32 keeps 11 significant bits, so the residuals reach 4,000 (a second
    matching-pursuit round reaches 2,300): an f32 product of the same
    inputs under the same flag is then not exact, which shows that the
    flag was live; every dot still stays below 2^24."""
    nest, resid = _search_inputs(4096, amp=4000)
    want = NestSearch(nest, "cpu").best(resid)
    flag = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        search = NestSearch(nest, cuda)
        got = search.best(resid)
        r = torch.from_numpy(resid.astype(np.float32)).to(cuda)
        c = torch.from_numpy(search.C.astype(np.float32)).to(cuda)
        f32_exact = torch.equal((r @ c.T).double(), r.double() @ c.double().T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
        torch.set_float32_matmul_precision(precision)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert f32_exact == (not tf32)


@pytest.mark.cuda
def test_cuda_encoder_search_matches_cpu_and_decodes(cuda):
    """An encode with the search on the card gives the bytes of the same
    encode with the search on the CPU, and the clip decodes through the
    session on the card to the golden decoder's frames."""
    cfg = SeqConfig(64, 48)
    rng = np.random.default_rng(8)
    frames = [[rng.integers(0, 256, s, dtype=np.uint8)
               for s in cfg.plane_shapes] for _ in range(3)]
    clip = VideoEncoder(cfg, lambda_bits=2.0, use_tpu_search=True,
                        device=cuda).encode(frames, ["IPB"])
    assert clip == VideoEncoder(cfg, lambda_bits=2.0, use_tpu_search=True,
                                device="cpu").encode(frames, ["IPB"])
    got = [f.yuv_bytes() for f in DecoderSession(cfg, cuda).decode_clip(clip)]
    assert got == [b"".join(p.tobytes() for p in planes)
                   for planes in refdec.decode_clip(cfg, clip)]


def _leaves(model, head) -> list:
    """Every trained tensor, the ViT's by name and then the head's."""
    sd = model.state_dict()
    return [sd[k] for k in sorted(sd)] + [t.detach() for t in head]


@pytest.mark.cuda
def test_cuda_train_steps_match_cpu(cuda):
    """Three `train_step`s on the card against three on the CPU, from the
    same weights (zero head) on the same batches, one weight at 0: losses
    within 2e-2 relative and parameters within 1.6e-2 max abs, the bounds
    tests/test_torch_train.py holds the CPU to against optax."""
    vcfg = ViTConfig(image_size=32, patch_size=8, dim=64, depth=2, heads=2)
    rng = np.random.default_rng(11)
    batches = [torch.from_numpy(rng.random((4, 32, 32, 3), np.float32))
               for _ in range(3)]
    weight = torch.tensor([1.0, 1.0, 0.0, 1.0])
    sd = init_vit(vcfg, torch.Generator().manual_seed(4), "cpu").state_dict()
    start = (sd, torch.zeros(vcfg.dim, 3), torch.zeros(3))
    out = {}
    for dev in ("cpu", cuda):
        model, head = make_probe(vcfg, dev, params=start)
        opt = make_optimizer(model, head)
        losses = [float(train_step(model, head, opt, b.to(dev),
                                   weight.to(dev))) for b in batches]
        out[str(dev)] = losses, [t.cpu().float() for t in _leaves(model,
                                                                  head)]
    (lc, pc), (lg, pg) = out["cpu"], out[str(cuda)]
    assert all(abs(g - c) <= 2e-2 * abs(c) for g, c in zip(lg, lc)), (lg, lc)
    assert max(float((g - c).abs().max()) for g, c in zip(pg, pc)) <= 1.6e-2


@pytest.mark.cuda
def test_cuda_backward_default_vit_has_no_nan(cuda):
    """A backward pass of the probe's loss through the default ViT at
    batch 8 and 224x224, from a non-zero head: every gradient finite, every
    ViT leaf's non-zero but the never-added b2's, which is None."""
    vcfg = ViTConfig()
    model, (w, b) = make_probe(vcfg, cuda, seed=2)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        w.copy_(0.1 * torch.randn(w.shape, generator=gen))
    images = torch.rand((8, 224, 224, 3), generator=gen).to(cuda)
    loss_fn(model, w, b, images, torch.ones(8, device=cuda)).backward()
    for name, p in [*model.named_parameters(), ("head.w", w), ("head.b", b)]:
        if name.endswith(".b2"):
            assert p.grad is None, name
            continue
        assert bool(torch.isfinite(p.grad).all()), name
        assert bool(p.grad.any()), name


@pytest.mark.cuda
def test_cuda_loader_batch_trains_without_host_sync(cuda):
    """Each loader batch goes through `train_step` on the card without a
    host synchronisation that nobody asked for (torch's sync debug mode),
    and the losses read at the end are finite."""
    cfg = SeqConfig(64, 48)
    vcfg = ViTConfig(image_size=32, patch_size=8, dim=64, depth=2, heads=2)
    model, head = make_probe(vcfg, cuda)
    opt = make_optimizer(model, head)
    losses, syncs = [], []
    for images, valid in FrameBatchLoader(cfg, _consumer_clips(cfg), 32,
                                          cuda):
        syncs.append(implicit_syncs(lambda: losses.append(train_step(
            model, head, opt, images, weight_of(valid, cuda)))))
    assert len(losses) == 9 and syncs == [0] * 9
    assert bool(torch.isfinite(torch.stack(losses)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("backend,dp,tp", [("nccl", 1, 1), ("gloo", 1, 2),
                                           ("gloo", 2, 1)])
def test_cuda_mesh_train_steps_match_one_device(cuda, backend, dp, tp):
    """Two `train_step`s on a mesh of ranks on the card (NCCL at world size
    1; two gloo ranks sharing cuda:0, over "tp" and over "dp") against two
    on one device, from the same weights (step 1 trains only the zero
    head): every rank's losses within 1e-3 relative."""
    vcfg = ViTConfig(image_size=32, patch_size=8, dim=64, depth=2, heads=2)
    rng = np.random.default_rng(12)
    batches = [rng.random((4, 32, 32, 3), np.float32) for _ in range(2)]
    weight = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    model, head = make_probe(vcfg, cuda, seed=0)
    opt = make_optimizer(model, head)
    want = [float(train_step(model, head, opt, torch.from_numpy(b).to(cuda),
                             torch.from_numpy(weight).to(cuda)))
            for b in batches]
    got = launch(steps_rank, dp * tp, dp, tp, vcfg, batches, weight,
                 device="cuda", backend=backend)
    for losses in got:
        assert all(abs(g - w) <= 1e-3 * abs(w) for g, w in zip(losses, want)
                   ), (got, want)
