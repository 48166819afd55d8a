"""The host half of the port's arena decoder against the JAX package's.

`MultiStreamDecoder` in both packages plans the same clips with the same
C++ planner into the same v6 staging layout: every `snapshot_step`
payload (the u8 and u32 staging prefixes, the variant and the sizes) must
be byte-equal, step by step, for every K, every mv encoding and every meta
width. No device step runs here (tests/test_torch_arena_device.py replays
the payloads). Then the port's C assembly against the JAX package's numpy
reference (`_assemble_numpy`), as tests/test_assemble.py holds the JAX
package's own C assembly.
"""

import struct

import numpy as np
import pytest

from hvqm4_tpu.config import SeqConfig as JaxSeqConfig
from hvqm4_tpu.native import NativePlanner as JaxNativePlanner
from hvqm4_tpu.parallel import multistream as jms
from hvqm4_tpu_torch.config import SeqConfig
from hvqm4_tpu_torch.parallel import multistream as tms
from tools.encoder import make_clip

from .conftest import REPO

CFG = SeqConfig(64, 48)


def corrupt_second_block(clip: bytes) -> bytes:
    """The second GOP block's first frame gets a stream-size entry of
    0xFFFFFFFF: every planner rejects it ("stream overruns payload"). The
    same poison as tests/test_multistream.py."""
    body = 0x44
    (len0,) = struct.unpack_from(">I", clip, body)
    sizes_off = body + 8 + len0 + 8 + 8 + 12
    out = bytearray(clip)
    struct.pack_into(">I", out, sizes_off, 0xFFFFFFFF)
    return bytes(out)


def decoders(cfg, clips, k=1):
    """(JAX decoder, port decoder on the CPU) over the same clips."""
    j = jms.MultiStreamDecoder(
        JaxSeqConfig(cfg.width, cfg.height, cfg.h_samp, cfg.v_samp), clips,
        planner_factory=JaxNativePlanner, steps_per_dispatch=k)
    return j, tms.MultiStreamDecoder(cfg, clips, "cpu", steps_per_dispatch=k)


def assert_same_payload(want, got, what=""):
    assert got["variant"] == want["variant"], what
    assert got["sizes"] == want["sizes"], what
    for g in ("u8", "u32"):
        a, b = want["staging"][g], got["staging"][g]
        assert a.dtype == b.dtype and a.shape == b.shape, (what, g)
        assert np.array_equal(a, b), (what, g)


def plan_both(j, t, force=None):
    """Plan every step on both decoders in lock-step; `force(buf)` may
    widen a step's planned scratch on both before it is assembled again.
    Returns, per step, the port's (payload, valid, mv2 pool entries)."""
    out = []
    while any(j.active):
        assert t.active == j.active
        bj, _mj, vj = j.plan_step()
        bt, _mt, vt = t.plan_step()
        assert vt == vj
        if force is not None and force(bj):
            force(bt)
            j._assemble(bj)
            t._assemble(bt)
        sj, st = j.snapshot_step(bj), t.snapshot_step(bt)
        assert_same_payload(sj, st, f"step {len(out)}")
        out.append((st, vt, int(bt["slot_used"][:, 3].sum())))
        j._cur ^= 1   # the port's plan_step moves its own ring cursor
    assert not any(t.active)
    return out


@pytest.mark.parametrize("k", [1, 2, 3])
def test_payloads_match_jax_small(k):
    """Three 64x48 streams: 8, 8 and 3 frames (no multiple of 2 or 3; the
    short stream leaves filler slots)."""
    clips = [make_clip(CFG, ["IPBPB", "IPP"], seed=s) for s in (1, 2)]
    clips.append(make_clip(CFG, ["IPP"], seed=3))
    steps = plan_both(*decoders(CFG, clips, k))
    assert len(steps) == -(-8 // k)
    seen = {p["variant"][2:4] for p, _v, _m in steps}
    assert (tms._MV_PACKED8, True) in seen or (tms._MV_NONE, True) in seen
    assert (tms._MV_PACKED8, False) in seen


def test_payloads_match_jax_640():
    """Both 640x480 test clips as two streams, K=1, host only."""
    clips = [(REPO / "testdata" / n).read_bytes()
             for n in ("ref640.h4m", "retail640.h4m")]
    steps = plan_both(*decoders(SeqConfig(640, 480), clips))
    assert len(steps) == 28
    assert all(v == [True, True] for _p, v, _m in steps)


def test_payloads_match_jax_every_mv_mode():
    """An mv_extreme stream (WIDE), an all-I step (NONE + nest), P and B
    steps (PACKED8, refsel-2 vectors in the mv2 pool)."""
    wide = plan_both(*decoders(CFG, [make_clip(CFG, ["IPPP"], seed=s,
                                               mv_extreme=True)
                                     for s in (5, 6)]))
    assert any(p["variant"][2] == tms._MV_WIDE for p, _v, _m in wide)
    steps = plan_both(*decoders(CFG, [make_clip(CFG, ["IBBPBP", "IPP"],
                                                seed=13) for _ in range(2)]))
    modes = {p["variant"][2:4] for p, _v, _m in steps}
    assert (tms._MV_NONE, True) in modes          # all-I step, nest ships
    assert (tms._MV_PACKED8, False) in modes      # P/B steps, no nest
    assert sum(m for _p, _v, m in steps) > 0      # refsel-2 pool entries


def widen_meta(bits: int):
    """Force a step to a meta width the encoder never reaches: OR unused
    meta values into every slot's mask until the worst slot holds more
    distinct values than the next narrower codebook (8, 16, 32)."""
    need = {3: 0, 4: 9, 5: 17, 6: 33}[bits]

    def force(buf):
        masks = buf["meta_mask"]
        for v in range(len(masks)):
            m = int(masks[v])
            for val in range(64):
                if bin(m).count("1") >= need:
                    break
                m |= 1 << val
            masks[v] = np.uint64(m)
        return True

    return force


@pytest.mark.parametrize("bits", [3, 4, 5, 6])
def test_payloads_match_jax_every_meta_width(bits):
    """3 bits is the I step's own width; 4-6 are forced on every step."""
    clips = [make_clip(CFG, ["IPBPB"], seed=s) for s in (7, 8)]
    steps = plan_both(*decoders(CFG, clips), force=widen_meta(bits))
    widths = [p["variant"][4] for p, _v, _m in steps]
    assert bits in widths and min(widths) == bits


def test_payloads_match_jax_poisoned_mid_step():
    """K=3: the corrupt stream's frame 4 fails inside the second dispatch;
    its stream is poisoned from there, its earlier frames stay valid, and
    the step is planned again without it."""
    good = make_clip(CFG, ["IPP", "IPP"], seed=45)
    steps = plan_both(*decoders(CFG, [good, corrupt_second_block(good)], 3))
    valid = [v for _p, v, _m in steps]
    assert valid[0] == [[True, True]] * 3
    assert valid[1] == [[True, False]] * 3


# ---------------------------------------------------------------------------
# The port's C assembly against the JAX package's numpy reference
# ---------------------------------------------------------------------------

def assert_assembly_matches_numpy(j, bj, t, bt):
    """Assemble the same planned step twice, each from zeroed staging: the
    JAX decoder through its numpy path (`_assemble_numpy` and the numpy
    offsets, taken when the buffer has no step planner), the port through
    its C `pack_offsets` and `assemble_shard`. Bases, totals, variant and
    staging bytes must be equal."""
    for b in (bj, bt):
        b["staging"]["u8"][:] = 0
        b["staging"]["u32"][:] = 0
        b["offs"][:] = 0
    sp = bj.pop("step_planner")
    try:
        j._assemble(bj)
    finally:
        bj["step_planner"] = sp
    t._assemble(bt)
    np.testing.assert_array_equal(bt["offs"], bj["offs"][0])
    assert bt["used"] == bj["used"]
    assert_same_payload(j.snapshot_step(bj), t.snapshot_step(bt))


def test_native_assembly_matches_numpy_every_variant():
    """I, P and B steps of 3 streams x K=2, the forced WIDE escape, every
    meta width, an all-I step and a step with a poisoned slot."""
    clips = [make_clip(CFG, ["IPBPB", "IPP"], seed=s) for s in range(3)]
    clips[2] = corrupt_second_block(make_clip(CFG, ["IPB", "IPB"], seed=9))
    j, t = decoders(CFG, clips, 2)
    seen, mv2_pooled, steps = set(), 0, 0
    while any(j.active):
        bj, _mj, _vj = j.plan_step()
        bt, _mt, _vt = t.plan_step()
        mv2_pooled += int(bt["slot_used"][:, 3].sum())
        forced = [None, "wide", *(widen_meta(b) for b in (4, 5, 6))]
        for f in forced if steps == 1 else [None]:
            for b in (bj, bt):
                if f == "wide":
                    b["mv_or"] |= 1
                    b["mv_fit"] = False
                elif f is not None:
                    f(b)
            assert_assembly_matches_numpy(j, bj, t, bt)
            seen.add(bt["variant"][2:])
        steps += 1
        j._cur ^= 1
    ji, ti = decoders(CFG, [make_clip(CFG, ["I"], seed=9)])
    bj, _m, _v = ji.plan_step()
    bt, _m, _v = ti.plan_step()
    assert_assembly_matches_numpy(ji, bj, ti, bt)
    seen.add(bt["variant"][2:])
    assert {v[0] for v in seen} == {tms._MV_NONE, tms._MV_PACKED8,
                                    tms._MV_WIDE}
    assert {v[2] for v in seen} >= {3, 4, 5, 6}
    assert any(v[1] for v in seen) and mv2_pooled > 0
    assert t.streams[2].failed and steps >= 4


def test_layout_and_tiers_match_jax():
    for cfg in (SeqConfig(64, 48), SeqConfig(640, 480), SeqConfig(48, 64, 1, 1)):
        jcfg = JaxSeqConfig(cfg.width, cfg.height, cfg.h_samp, cfg.v_samp)
        assert tms._pool_caps(cfg) == jms._pool_caps(jcfg)
        for args in ((3, 4096, 4096, 0, True, 3), (8, 9000, 7000, 1, False, 5),
                     (2, 4352, 5000, 3, True, 6), (5, 4096, 8000, 1, True, 4)):
            assert tms._layout(cfg, *args) == jms._layout(jcfg, *args)
    for full in (4096, 5000, 80000, 3_000_000):
        assert tms._packed_tiers(full) == jms._packed_tiers(full)
        for used in (0, 4097, full // 2, full):
            assert tms._pick_tier(used, full) == jms._pick_tier(used, full)


def test_prepared_planning_matches_jax():
    """`prepare` + `plan_frame_prepared` write the same views and return
    the same counts as the JAX package's, frame by frame (the views are
    reused, as the arena decoder reuses its scratch)."""
    from hvqm4_tpu import native as jnative
    from hvqm4_tpu_torch import native as tnative
    from hvqm4_tpu_torch.container import Demuxer

    clip = make_clip(CFG, ["IPBPB", "IPP"], seed=12, mv_extreme=True)
    total = sum(bh * bw for bh, bw in CFG.block_grids)
    out = []
    for mod, planner in ((jnative, jnative.NativePlanner(
            JaxSeqConfig(64, 48))), (tnative, tnative.NativePlanner(CFG))):
        planes = [mod.alloc_packed_plane(bh, bw) if mod is jnative
                  else tnative._alloc_packed_plane(bh, bw)
                  for bh, bw in CFG.block_grids]
        pools = mod.alloc_pools(total)
        frame = [np.zeros(CFG.nest_shape, np.uint8),
                 np.zeros(CFG.mb_grid, np.uint32),
                 np.zeros(CFG.mb_grid, np.uint32)]
        prep = planner.prepare(planes, mod.make_pool_struct(*pools), *frame)
        got = []
        for r in Demuxer(clip).video_records():
            counts = planner.plan_frame_prepared(r.frame_char, r.payload, prep)
            got.append((counts, [a.copy() for d in planes for a in d.values()]
                        + [a.copy() for a in (*pools, *frame)]))
        out.append(got)
    for (cj, aj), (ct, at) in zip(*out):
        assert cj == ct
        for a, b in zip(aj, at):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(tnative.PlannerError, match="bad frame type"):
        planner.plan_frame_prepared("X", b"", prep)


def test_trivial_filler_consumes_no_pools():
    long = make_clip(CFG, ["IPPPPP"], seed=1)
    short = make_clip(CFG, ["IPP"], seed=2)
    ms = tms.MultiStreamDecoder(CFG, [long, short], "cpu")
    dc_useds = []
    while any(ms.active):
        buf, _metas, valid = ms.plan_step()
        if not valid[1]:
            dc_useds.append(int(buf["slot_used"][ms._slot(1, 0)][2]))
    assert dc_useds and all(d == 0 for d in dc_useds)


def test_constructor_refusals():
    with pytest.raises(ValueError, match="share one SeqConfig"):
        tms.MultiStreamDecoder(CFG, [make_clip(SeqConfig(32, 16), ["I"])],
                               "cpu")
    with pytest.raises(ValueError, match="unsupported device 'meta'"):
        tms.MultiStreamDecoder(CFG, [make_clip(CFG, ["I"], seed=1)], "meta")


def test_constructor_refuses_cuda_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    clip = make_clip(CFG, ["I"], seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tms.MultiStreamDecoder(CFG, [clip])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tms.MultiStreamDecoder(CFG, [clip], "cuda")
