"""The port's arena decoder end to end on the CPU, against the C oracle and
the port's `DecoderSession`: the pipelined decode at several lookahead
depths and K, the synchronous `step()`, GOP-parallel decode of one clip,
and the CLI paths that run it (`decode --gop-parallel`, `verify --batched`).
"""

import numpy as np
import pytest
import torch

from hvqm4_tpu_torch import cli
from hvqm4_tpu_torch.config import SeqConfig
from hvqm4_tpu_torch.parallel import multistream as tms
from hvqm4_tpu_torch.session import DecoderSession
from tools.encoder import make_clip

from .conftest import run_oracle
from .test_torch_arena import corrupt_second_block

torch.set_num_threads(1)


def session_frames(cfg, clip):
    return [f.yuv_bytes() for f in DecoderSession(cfg, "cpu").decode_clip(clip)]


def collect(steps, n):
    """Every valid frame of each of n streams, as YUV bytes."""
    per = [[] for _ in range(n)]
    for frames, _metas, valid in steps:
        fnp = [p.numpy() for p in frames]
        for si, ok in enumerate(valid):
            if ok:
                per[si].append(b"".join(fnp[pi][si].tobytes()
                                        for pi in range(3)))
    return per


@pytest.mark.parametrize("w,h,k,plan_ahead", [
    (64, 48, 1, 1), (64, 48, 2, 2), (128, 96, 1, 2), (128, 96, 2, 1)])
def test_pipelined_matches_oracle(oracle_bin, tmp_path, w, h, k, plan_ahead):
    cfg = SeqConfig(w, h)
    clips = [make_clip(cfg, ["IBBPBP", "IPP"], seed=s) for s in (3, 4)]
    clips.append(make_clip(cfg, ["IPB"], seed=5))   # ends early
    ms = tms.MultiStreamDecoder(cfg, clips, "cpu", steps_per_dispatch=k,
                                plan_ahead=plan_ahead)
    got = collect(ms.run_pipelined(), len(clips))
    fb = cfg.frame_bytes
    for si, clip in enumerate(clips):
        oracle = run_oracle(oracle_bin, clip, tmp_path)
        assert got[si] == [oracle[i:i + fb] for i in range(0, len(oracle), fb)]
    assert ms.stats["frames"] == 21
    assert ms.stats["steps"] == -(-9 // k)


def test_step_matches_session_and_the_ring_cursor_advances():
    """Every frame of the synchronous `step()` equals the session's; a
    pipelined run advances the decoder's ring cursor, so a later `step()`
    plans into the slot after the one its last device step read."""
    cfg = SeqConfig(64, 48)
    clips = [make_clip(cfg, ["IPBPB", "IPP"], seed=s) for s in (6, 7)]
    ms = tms.MultiStreamDecoder(cfg, clips, "cpu")
    assert collect(iter(ms.step, None), 2) == [session_frames(cfg, c)
                                              for c in clips]
    assert ms._cur == 8 % len(ms._bufs)
    ms2 = tms.MultiStreamDecoder(cfg, clips, "cpu", plan_ahead=2)
    assert sum(1 for _ in ms2.run_pipelined()) == 8
    assert ms2._cur == 8 % len(ms2._bufs) == 2


def test_gop_parallel_matches_session_and_skips_a_poisoned_lane():
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["IPB", "IPP", "IB" + "P" * 3, "I"], seed=77)
    want = session_frames(cfg, clip)
    got = list(tms.decode_clip_gop_parallel(clip, "cpu", max_streams=3))
    assert [yuv for _bi, yuv in got] == want
    assert [bi for bi, _ in got] == [0] * 3 + [1] * 3 + [2] * 5 + [3]
    three = make_clip(cfg, ["IPP", "IPP", "IPP"], seed=46)
    want = session_frames(cfg, three)
    got = list(tms.decode_clip_gop_parallel(corrupt_second_block(three),
                                            "cpu", max_streams=3))
    assert [bi for bi, _ in got] == [0, 0, 0, 2, 2, 2]
    assert [yuv for _bi, yuv in got] == want[0:3] + want[6:9]


@pytest.fixture()
def clip_path(tmp_path):
    p = tmp_path / "c.h4m"
    p.write_bytes(make_clip(SeqConfig(64, 48), ["IPB", "IPP", "IP"], seed=55))
    return p


def test_cli_gop_parallel_matches_oracle(tmp_path, clip_path, oracle_bin):
    out = tmp_path / "g.yuv"
    assert cli.main(["decode", str(clip_path), str(out), "--gop-parallel",
                     "--device", "cpu"]) == 0
    assert out.read_bytes() == run_oracle(oracle_bin, clip_path.read_bytes(),
                                          tmp_path)


@pytest.mark.parametrize("flag", [["--ppm", "d"], ["--start-block", "1"],
                                  ["--display-order"], ["--y4m"],
                                  ["--frames", "2"], ["--profile"]])
def test_cli_gop_parallel_refuses_flags(capsys, clip_path, flag):
    assert cli.main(["decode", str(clip_path), "--gop-parallel", "--device",
                     "cpu", *flag]) == 1
    err = capsys.readouterr().err.strip()
    assert err.splitlines() == [f"hvqm4_tpu_torch: error: {flag[0]} is not "
                                f"supported with --gop-parallel"]


def test_cli_verify_batched(capsys, clip_path, oracle_bin, monkeypatch):
    assert cli.main(["verify", str(clip_path), "--batched", "--device",
                     "cpu"]) == 0
    assert ("batched decode on cpu vs C oracle (8 frames, on-device "
            "checksum): MATCH") in capsys.readouterr().out
    monkeypatch.setattr(cli, "_ORACLE", clip_path.parent / "no_oracle")
    assert cli.main(["verify", str(clip_path), "--batched", "--device",
                     "cpu"]) == 0
    assert ("vs NumPy golden (8 frames, on-device checksum): MATCH"
            in capsys.readouterr().out)


def test_cli_batched_paths_need_a_card(capsys, clip_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    for argv in (["decode", str(clip_path), "--gop-parallel"],
                 ["verify", str(clip_path), "--batched"]):
        assert cli.main(argv) == 1
        err = capsys.readouterr().err.strip()
        assert len(err.splitlines()) == 1 and "CUDA is not available" in err
