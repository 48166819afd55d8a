"""The device half of the port's arena decoder against the JAX package's.

The port's `snapshot_step` payloads (byte-equal to the JAX package's:
tests/test_torch_arena.py) are replayed through the JAX `device_step` and
the port's plain `device_step` from the same zero state: every frame of
every step and the final state (nest, ref_prev, ref_last) must be equal.
Tolerance 0: this is integer code. Then poisoned-stream masking of the
pipelined decode against the JAX decoder's.

Each JAX variant compiles its own executable on the CPU, so the clips are
small (64x48) and few.
"""

import numpy as np
import pytest
import torch

from hvqm4_tpu.config import SeqConfig as JaxSeqConfig
from hvqm4_tpu.native import NativePlanner as JaxNativePlanner
from hvqm4_tpu.parallel import multistream as jms
from hvqm4_tpu_torch.config import SeqConfig
from hvqm4_tpu_torch.container import Demuxer
from hvqm4_tpu_torch.parallel import multistream as tms
from tools.encoder import make_clip

from .test_torch_arena import corrupt_second_block, widen_meta

torch.set_num_threads(1)

CFG = SeqConfig(64, 48)
JCFG = JaxSeqConfig(64, 48)


def port_payloads(clips, k=1, force=None):
    """Every step of the port's planner as a `snapshot_step` payload, with
    its validity; `force(buf)` widens a step's scratch before assembly."""
    ms = tms.MultiStreamDecoder(CFG, clips, "cpu", steps_per_dispatch=k)
    out = []
    while any(ms.active):
        buf, _metas, valid = ms.plan_step()
        if force is not None:
            force(buf)
            ms._assemble(buf)
        out.append((ms.snapshot_step(buf), valid))
    return out


def replay_both(clips, payloads, k=1):
    """Replay the payloads through the JAX and the port's device steps,
    step by step from fresh decoders; assert every frame and the final
    state equal. Returns the port's frames per step."""
    j = jms.MultiStreamDecoder(JCFG, clips, planner_factory=JaxNativePlanner,
                               steps_per_dispatch=k)
    t = tms.MultiStreamDecoder(CFG, clips, "cpu", steps_per_dispatch=k)
    frames = []
    for st, (payload, _valid) in enumerate(payloads):
        want = j.device_step(dict(payload))
        got = t.device_step(dict(payload))
        for pi in range(3):
            assert got[pi].dtype == torch.uint8
            assert np.array_equal(np.asarray(want[pi]), got[pi].numpy()), \
                (st, pi)
        frames.append([f.clone() for f in got])
    for a, b in zip([j.nest, *j.ref_prev, *j.ref_last],
                    [t.nest, *t.ref_prev, *t.ref_last]):
        assert np.array_equal(np.asarray(a), b.numpy())
    return frames


@pytest.mark.parametrize("k", [1, 2])
def test_replay_matches_jax_and_stage_packed(k):
    """I, P and B steps of three streams (one shorter: filler slots), then
    the whole pass through `stage_packed`, fresh and with its packed
    buffers reused, equal to the per-step replay."""
    clips = [make_clip(CFG, ["IPBPB", "IPP"], seed=s) for s in (21, 22)]
    clips.append(make_clip(CFG, ["IPP"], seed=23))
    payloads = port_payloads(clips, k)
    want = replay_both(clips, payloads, k)
    if k == 2:
        assert want[0][0].shape == (2, 3, 48, 64)
    packed = None
    for _ in range(2):
        ms = tms.MultiStreamDecoder(CFG, clips, "cpu", steps_per_dispatch=k)
        bufs = [dict(p) for p, _v in payloads]
        packed = ms.stage_packed(bufs, packed)
        for st, b in enumerate(bufs):
            got = ms.device_step(b)
            for pi in range(3):
                assert torch.equal(got[pi], want[st][pi]), (st, pi)


def test_replay_matches_jax_wide_vectors():
    clips = [make_clip(CFG, ["IPPP"], seed=s, mv_extreme=True) for s in (5, 6)]
    payloads = port_payloads(clips)
    assert any(p["variant"][2] == tms._MV_WIDE for p, _v in payloads)
    replay_both(clips, payloads)


@pytest.mark.parametrize("bits", [4, 5, 6])
def test_replay_matches_jax_every_meta_width(bits):
    """Widths the encoder never reaches, forced on every step (3 bits is
    the I steps' own width, replayed above)."""
    clips = [make_clip(CFG, ["IPB"], seed=s) for s in (31, 32)]
    payloads = port_payloads(clips, force=widen_meta(bits))
    assert min(p["variant"][4] for p, _v in payloads) == bits
    replay_both(clips, payloads)


# ---------------------------------------------------------------------------
# Poisoned-stream masking against the JAX decoder
# ---------------------------------------------------------------------------

def frames_per_stream(ms, pipelined=True):
    """Every valid frame of every stream, as YUV bytes."""
    per = [[] for _ in range(ms.n)]
    if pipelined:
        steps = ms.run_pipelined()
    else:
        steps = iter(ms.step, None)
    for frames, _metas, valid in steps:
        fnp = [np.asarray(p) for p in frames]
        for si, ok in enumerate(valid):
            if ok:
                per[si].append(b"".join(fnp[pi][si].tobytes()
                                        for pi in range(3)))
    return per


def both(clips=(), **kw):
    return (jms.MultiStreamDecoder(JCFG, list(clips),
                                   planner_factory=JaxNativePlanner, **kw),
            tms.MultiStreamDecoder(CFG, list(clips), "cpu", **kw))


def test_poisoned_stream_with_lookahead_matches_jax():
    """plan_ahead 4: frames of the corrupt stream dequeued into later steps
    before its failure was known come back invalid, as in JAX."""
    good = make_clip(CFG, ["IPPPPPPP"], seed=64)
    bad = corrupt_second_block(make_clip(CFG, ["IPPP", "IPPP"], seed=65))
    j, t = both([good, bad], plan_ahead=4)
    want, got = frames_per_stream(j), frames_per_stream(t)
    assert got == want
    assert len(got[0]) == 8 and len(got[1]) == 4 and t.streams[1].failed


def test_fused_dispatch_keeps_prefailure_frames_like_jax():
    """K=3: the corrupt stream keeps the frames planned before the bad one."""
    good = make_clip(CFG, ["IPP", "IPP"], seed=45)
    j, t = both([good, corrupt_second_block(good)], steps_per_dispatch=3)
    want, got = frames_per_stream(j), frames_per_stream(t)
    assert got == want
    assert got[1] == got[0][:3]


def test_b_without_references_poisons_like_jax():
    clip = make_clip(CFG, ["IPB"], seed=88)
    recs = [(r.block_index, r.frame_char, r.payload)
            for r in Demuxer(clip).video_records()]
    lanes = [[recs[0], recs[2]], recs]   # I then B: one anchor only
    j, t = both(record_lists=lanes)
    want = frames_per_stream(j, pipelined=False)
    got = frames_per_stream(t, pipelined=False)
    assert got == want
    assert t.streams[0].failed and len(got[0]) == 1 and len(got[1]) == 3
