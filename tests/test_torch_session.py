"""The port's session, checksum, lock-step step and CLI on the CPU, against
the C oracle and the JAX package; and the port's independence from JAX.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _example_step_args
from hvqm4_tpu.config import SeqConfig as JaxSeqConfig
from hvqm4_tpu.parallel import multistream as jms
from hvqm4_tpu.session import DecoderSession as JaxSession
from hvqm4_tpu.utils.hashing import wsum32
from hvqm4_tpu_torch import cli
from hvqm4_tpu_torch.config import SeqConfig
from hvqm4_tpu_torch.container import Demuxer
from hvqm4_tpu_torch.convert import plan_to_torch, stack_plans, state_to_torch
from hvqm4_tpu_torch.parallel import multistream as tms
from hvqm4_tpu_torch.session import (DecoderSession, HVQM4BuffSize,
                                     HVQM4DecodeIpic, HVQM4InitSeqObj,
                                     HVQM4SetBuffer)
from hvqm4_tpu_torch.utils.hashing import batch_csum, frame_csum
from tools.encoder import make_clip

from .conftest import REPO, run_oracle

torch.set_num_threads(1)

# the make_clip cases of tests/test_device_core.py, plus an mv_extreme clip
# whose vectors reach far beyond the frame
CASES = [
    (64, 48, 2, ["IPBPB", "IPP"], 1, False),
    (48, 64, 1, ["IPBPB"], 2, False),            # portrait nest, 4:4:4
    (320, 240, 2, ["I", "I"], 8, False),
    (128, 96, 2, ["IBBPBP", "IPPP"], 3, False),
    (64, 48, 2, ["IPBPB", "IPP"], 5, True),
]


def _decode(sess, clip, **kw) -> list[bytes]:
    return [f.yuv_bytes() for f in sess.decode_clip(clip, **kw)]


@pytest.mark.parametrize("w,h,samp,gops,seed,mv_extreme", CASES)
def test_session_matches_oracle_and_jax(oracle_bin, tmp_path, w, h, samp,
                                        gops, seed, mv_extreme):
    cfg = SeqConfig(w, h, samp, samp)
    clip = make_clip(cfg, gops, seed=seed, mv_extreme=mv_extreme)
    got = _decode(DecoderSession(cfg, "cpu"), clip)
    assert b"".join(got) == run_oracle(oracle_bin, clip, tmp_path)
    assert got == _decode(JaxSession(JaxSeqConfig(w, h, samp, samp)), clip)


def test_session_seek_block():
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["IPP", "IPB", "IP"], seed=11)
    full = _decode(DecoderSession(cfg, "cpu"), clip)
    assert _decode(DecoderSession(cfg, "cpu"), clip, start_block=1) == full[3:]


def test_session_display_order_and_sdk_shims(oracle_bin, tmp_path):
    cfg = HVQM4InitSeqObj(64, 48)
    assert HVQM4BuffSize(cfg) == 4 * cfg.frame_bytes + 38 * 70
    clip = make_clip(cfg, ["IPBPB"], seed=12)
    sess = DecoderSession(cfg, "cpu")
    ids = [f.display_id for f in sess.decode_clip_display_order(clip)]
    assert ids == sorted(ids) == list(range(5))
    first = next(Demuxer(clip).video_records())
    frame = HVQM4DecodeIpic(HVQM4SetBuffer(cfg, "cpu"), first.payload)
    oracle = run_oracle(oracle_bin, clip, tmp_path)
    assert frame.yuv_bytes() == oracle[:cfg.frame_bytes]


def test_frame_csum_matches_wsum32():
    rng = np.random.default_rng(1)
    shapes = [(48, 64), (24, 32), (24, 32)]
    planes = [rng.integers(0, 256, (3, h, w), dtype=np.uint8)
              for h, w in shapes]
    got = batch_csum(*(torch.from_numpy(p) for p in planes))
    for j in range(3):
        want = wsum32(b"".join(p[j].tobytes() for p in planes))
        assert int(got[j]) == want
        assert int(frame_csum([torch.from_numpy(p[j]) for p in planes])) \
            == want
    full = [np.full((480, 640), 255, np.uint8),
            np.full((240, 320), 255, np.uint8),
            np.full((240, 320), 255, np.uint8)]  # the largest 640x480 sum
    assert int(frame_csum([torch.from_numpy(p) for p in full])) == wsum32(
        b"".join(p.tobytes() for p in full))


def _jax_step(plane_plans, nest, new_nest, is_i, is_ref, ref_prev, ref_last):
    j = jnp.asarray
    return jms.multi_frame_step(
        [{k: j(v) for k, v in p.items()} for p in plane_plans],
        j(nest), j(new_nest), j(is_i), j(is_ref),
        [j(r) for r in ref_prev], [j(r) for r in ref_last])


def _torch_step(plane_plans, nest, new_nest, is_i, is_ref, ref_prev,
                ref_last):
    t = torch.from_numpy
    state = state_to_torch(nest, ref_prev, ref_last, "cpu")
    assert all(not np.shares_memory(a, b.numpy()) for a, b in zip(
        [nest, *ref_prev, *ref_last], [state[0], *state[1], *state[2]]))
    return tms.multi_frame_step(
        [plan_to_torch(p, "cpu") for p in plane_plans], state[0],
        t(new_nest), t(is_i), t(is_ref), state[1], state[2])


def _assert_step_equal(want, got):
    frames, nest, prev, last = want
    tframes, tnest, tprev, tlast = got
    for a, b in zip(list(frames) + [nest] + list(prev) + list(last),
                    tframes + [tnest] + tprev + tlast):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_multi_frame_step_matches_jax_on_example_args():
    args = list(_example_step_args(JaxSeqConfig(64, 48), n=2))
    args[3] = np.array([True, False])   # is_i: one stream takes a new nest
    args[4] = np.array([True, False])   # is_ref: one stream rotates
    _assert_step_equal(_jax_step(*args), _torch_step(*args))


def test_multi_frame_step_matches_jax_on_planned_frames(oracle_bin, tmp_path):
    """Two lock-step steps (I then P/B) of two planned clips, state carried
    from the first step into the second, against JAX and the oracle."""
    cfg = SeqConfig(64, 48)
    clips = [make_clip(cfg, ["IPB"], seed=s) for s in (21, 22)]
    steps = list(tms.plan_steps(cfg, clips))[:2]
    state_j = state_t = None
    got = [[], []]
    for plans in steps:
        plane_plans, new_nest, is_i, is_ref = stack_plans(cfg, plans, "cpu")
        np_plans = [{k: v.numpy() for k, v in p.items()} for p in plane_plans]
        np_plans = [{**p, "desc": p["desc"].view(np.uint32)} for p in np_plans]
        if state_j is None:
            nest, prev, last = tms.init_state(cfg, 2, "cpu")
            state_j = (nest.numpy().copy(), [r.numpy().copy() for r in prev],
                       [r.numpy().copy() for r in last])
            state_t = (nest, prev, last)
        want = jms.multi_frame_step(
            [{k: jnp.asarray(v) for k, v in p.items()} for p in np_plans],
            jnp.asarray(state_j[0]), jnp.asarray(new_nest.numpy()),
            jnp.asarray(is_i.numpy()), jnp.asarray(is_ref.numpy()),
            [jnp.asarray(r) for r in state_j[1]],
            [jnp.asarray(r) for r in state_j[2]])
        res = tms.multi_frame_step(plane_plans, state_t[0], new_nest, is_i,
                                   is_ref, state_t[1], state_t[2])
        _assert_step_equal(want, res)
        state_j = (np.asarray(want[1]), [np.asarray(r) for r in want[2]],
                   [np.asarray(r) for r in want[3]])
        for j in range(2):
            got[j].append(b"".join(f[j].numpy().tobytes() for f in res[0]))
    fb = cfg.frame_bytes
    for j, clip in enumerate(clips):
        oracle = run_oracle(oracle_bin, clip, tmp_path)
        assert b"".join(got[j]) == oracle[:2 * fb]


def test_decode_lockstep_unequal_streams():
    """A stream that ends early is masked: the others decode as alone."""
    cfg = SeqConfig(64, 48)
    clips = [make_clip(cfg, ["IPBPB"], seed=31), make_clip(cfg, ["IP"], seed=32)]
    alone = [_decode(DecoderSession(cfg, "cpu"), c) for c in clips]
    got = [[], []]
    for frames, valid in tms.decode_lockstep(cfg, clips, "cpu"):
        for j in range(2):
            if valid[j]:
                got[j].append(b"".join(f[j].numpy().tobytes()
                                       for f in frames))
    assert got == alone


@pytest.fixture()
def clip_path(tmp_path):
    p = tmp_path / "c.h4m"
    p.write_bytes(make_clip(SeqConfig(64, 48), ["IPB", "IP"], seed=55))
    return p


def test_cli_hash_matches_oracle(capsys, clip_path, oracle_bin):
    assert cli.main(["hash", str(clip_path), "--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    want = subprocess.run([str(oracle_bin), "--hash", str(clip_path),
                           "/dev/null"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()
    assert got == want


def test_cli_decode_options(tmp_path, clip_path, oracle_bin):
    oracle = run_oracle(oracle_bin, clip_path.read_bytes(), tmp_path)
    fb = SeqConfig(64, 48).frame_bytes
    out = tmp_path / "o.yuv"
    assert cli.main(["decode", str(clip_path), str(out), "--device",
                     "cpu"]) == 0
    assert out.read_bytes() == oracle
    assert cli.main(["decode", str(clip_path), str(out), "--device", "cpu",
                     "--start-block", "1", "--frames", "1"]) == 0
    assert out.read_bytes() == oracle[3 * fb:4 * fb]
    assert cli.main(["decode", str(clip_path), str(out), "--device", "cpu",
                     "--display-order"]) == 0
    golden = JaxSession(JaxSeqConfig(64, 48), backend="numpy")
    assert out.read_bytes() == b"".join(
        f.yuv_bytes() for f in golden.decode_clip_display_order(
            clip_path.read_bytes()))


def test_cli_verify_and_info(capsys, clip_path, oracle_bin):
    assert cli.main(["verify", str(clip_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "numpy vs torch[cpu] (5 frames): MATCH" in out
    assert "vs C oracle: MATCH" in out
    assert cli.main(["info", str(clip_path)]) == 0
    assert "64x48" in capsys.readouterr().out


def test_cli_without_cuda_fails_with_one_line(capsys, clip_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    assert cli.main(["decode", str(clip_path)]) == 1
    err = capsys.readouterr().err.strip()
    assert len(err.splitlines()) == 1 and "CUDA is not available" in err
    assert cli.main(["hash", str(clip_path), "--device", "cuda"]) == 1


_NO_JAX = r"""
import sys
sys.modules["jax"] = None        # any `import jax` now raises ImportError,
sys.modules["hvqm4_tpu"] = None  # and so does any import of the JAX package
sys.modules["tools.encoder"] = None  # and of the JAX package's generator
import importlib
import pkgutil
import threading
import chip_smoke
import hvqm4_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(hvqm4_tpu_torch.__path__,
                                               "hvqm4_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
from hvqm4_tpu_torch import serve
from hvqm4_tpu_torch.container import Demuxer
from hvqm4_tpu_torch.session import DecoderSession
from hvqm4_tpu_torch.parallel.multistream import (MultiStreamDecoder,
                                                  decode_lockstep)
clip = open(sys.argv[1], "rb").read()
cfg = Demuxer(clip).info.cfg
frames = [f.yuv_bytes() for f in DecoderSession(cfg, "cpu").decode_clip(clip)]
steps = list(decode_lockstep(cfg, [clip], "cpu"))
assert len(frames) == len(steps) == 3
ms = MultiStreamDecoder(cfg, [clip, clip], "cpu", steps_per_dispatch=2)
arena = [b"".join(p[1].numpy().tobytes() for p in fr)
         for fr, _metas, valid in ms.run_pipelined() if valid[1]]
assert arena == frames
srv = serve.DecodeServer(("127.0.0.1", 0), device="cpu")
threading.Thread(target=srv.serve_forever, daemon=True).start()
rgb = serve.decode_remote(*srv.server_address, clip, mode=serve.MODE_RGB)
srv.shutdown()
srv.server_close()
assert [len(c) for c in rgb] == [32 * 16 * 3] * 3
srv = serve.DecodeServer(("127.0.0.1", 0), device="cpu",
                         batch_window_s=0.05, max_batch=2)
threading.Thread(target=srv.serve_forever, daemon=True).start()
yuv = serve.decode_remote(*srv.server_address, clip)
batches = serve.fetch_metrics(*srv.server_address)["batches"]
srv.shutdown()
srv.server_close()
assert yuv == frames and batches == 1
from hvqm4_tpu_torch import FrameBatchLoader, VideoEmbedPipeline, audio
from hvqm4_tpu_torch.models.vit import ViTConfig
from hvqm4_tpu_torch.utils.stats import clip_stats
assert audio.decode_record(audio.encode_record(
    __import__("numpy").zeros((8, 1), "int16")), 1).shape == (8, 1)
assert '"frames"' in clip_stats(clip)
pipe = VideoEmbedPipeline(cfg, [clip, clip], ViTConfig(16, 8, 32, 1, 2),
                          device="cpu")
emb, _metas, valid = next(pipe.run())
assert tuple(emb.shape) == (2, 32) and valid == [True, True]
rgb_batch, valid = next(iter(FrameBatchLoader(cfg, [clip, clip],
                                              device="cpu")))
assert tuple(rgb_batch.shape) == (2, 16, 32, 3) and valid == [True, True]
import os
from hvqm4_tpu_torch import VideoEncoder, cli, encode_to_size
for name in ("bitio", "gop", "encode", "encode_tpu"):
    assert "hvqm4_tpu_torch." + name in mods, name
src = [f.to_numpy() for f in
       DecoderSession(cfg, "cpu").decode_clip_display_order(clip)]
enc = VideoEncoder(cfg, use_tpu_search=True, device="cpu").encode(src, ["IPB"])
assert len(list(DecoderSession(cfg, "cpu").decode_clip(enc))) == 3
assert callable(encode_to_size)
out = os.path.join(os.path.dirname(sys.argv[1]), "t.h4m")
assert cli.main(["transcode", sys.argv[1], out, "--device", "cpu",
                 "--gops", "IPP"]) == 0
tinfo = Demuxer(open(out, "rb").read()).info
assert tinfo.cfg == cfg and tinfo.video_frames == 3
import scripts.bench_embed_torch
import scripts.bench_train_torch
import scripts.soak_device_torch
from examples.train_vit_torch import train
from hvqm4_tpu_torch.utils.profiling import torch_trace
with torch_trace(os.path.join(os.path.dirname(sys.argv[1]), "trace")):
    losses = train(cfg, [clip, clip], ViTConfig(16, 8, 32, 1, 2), epochs=1,
                   device="cpu")
assert len(losses) == 3
import scripts.fuzz_battery_torch
import tools.dump_payloads_torch
import tools.make_retail_clip_torch
import tools.rd_sweep_torch
from tools.encoder_torch import make_clip
assert make_clip(cfg, ["IPB"], seed=77) == clip
assert sys.modules["tools.encoder"] is None
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "hvqm4_tpu"))
assert loaded == ["hvqm4_tpu", "jax"], loaded   # only the blockers
print("ok", len(mods), len(frames), len(rgb))
"""


def test_port_never_imports_jax(tmp_path):
    """Every module of the port and `chip_smoke` import, and a clip
    decodes through the session, the lock-step step, the arena decoder
    (pipelined, K=2), the server, unbatched and batched, one pipeline step
    and one loader batch, is encoded with the full-nest search on the CPU
    and transcoded, and the training example trains an epoch under
    `torch_trace`, with both JAX and the JAX package blocked; the
    example's, the scripts' and the soak's modules import too, and so do
    the port's tools (`tools/*_torch.py`, `scripts/fuzz_battery_torch.py`),
    whose generator makes the test's clip byte for byte with
    `tools/encoder.py` blocked as well."""
    clip = tmp_path / "c.h4m"
    clip.write_bytes(make_clip(SeqConfig(32, 16), ["IPB"], seed=77))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _NO_JAX, str(clip)], env=env,
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    ok, n_mods, n_frames, n_rgb = res.stdout.split()
    assert (ok, n_frames, n_rgb) == ("ok", "3", "3")
    assert int(n_mods) >= 28
