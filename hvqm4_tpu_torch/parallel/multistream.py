"""Multi-stream decode: N independent `.h4m` streams stepped in lock-step.

The port of `hvqm4_tpu/parallel/multistream.py`. Every kernel works on
(N, …) tensors; the decode state (nest, ref_prev, ref_last) lives on the
device as stacked tensors that each step updates in place, where the JAX
step donated them:

    (plans, nest, ref_prev, ref_last) → (frames, nest', ref_prev', ref_last')

Streams advance by decode index; per-stream frame types may differ. I
frames are all-intra plans whose nest slot is refreshed (`is_i`); the
reference rotation is masked per stream (`is_ref`). Finished or corrupt
streams decode a trivial plan and are reported invalid.

Two host loops share `multi_frame_step`:

- **The arena path, `MultiStreamDecoder`** (the main path). The host plans
  a step of every stream with one GIL-released C++ call into per-stream
  contiguous scratch, then packs it into two typed staging buffers (u8 and
  u32) in the JAX package's v6 variant layout (`_layout`, byte for byte):
  per-slot pool prefixes at bases that travel as data, meta as per-slot
  codebook indices of 3-6 bits, forward vectors s8-packed or wide, refsel-2
  vectors in a meta-derived pool, the nest only on I slots. A step is two
  host-to-device copies of the used prefixes. On the device,
  `_unpack_arena` and `_derive_slots` (plain PyTorch) rebuild the per-plane
  plan tensors of `convert.py`'s contract and `_run_steps` runs K fused
  lock-step decodes (`steps_per_dispatch`). `run_pipelined` plans and
  uploads the next `plan_ahead` steps on worker threads while the device
  runs the current one. On a CUDA device the staging ring is pinned and
  the C++ planner writes straight into it; each upload records an event
  that the next planning into that ring slot waits on.
- **The per-field lock-step path** (`plan_steps`, `decode_lockstep`): dense
  per-stream plans stacked with `convert.stack_plans`, 18 copies a step.

The sharded path, one process a rank (`parallel.dist`): with
`sharding=StreamShard(s, S)` (`shard_streams(mesh, "dp")`) a decoder takes
the whole list of streams, keeps streams [s*n/S, (s+1)*n/S) and yields that
rank's (n/S, …) frames, metas and valids. Decode has no collectives: the
JAX package's `_arena_step_sharded` is a `shard_map` of the same step with
none either. Each rank plans and packs its own staging row and picks its
own tiers; the JAX decoder picks one tier for every row, from the largest
shard total, only because `shard_map` needs equal shapes. Each rank also
walks the record cursors of every stream of the list (never planning
them), and steps as long as that walk has frames left, so all ranks step
alike without a collective and yield the JAX decoder's steps. A planner
cannot see another rank's streams, so a stream that fails in a planner
walks on as filler: where the JAX decoder would stop after such a stream,
the ranks yield trailing steps with every frame invalid.

Not ported: the JAX package's pure-Python planner fallback.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import dataclasses
import functools
import os
import time
from typing import Iterator

import numpy as np
import torch

from ..config import MAX_BASES, MEDIA_VIDEO, SeqConfig
from ..container import Demuxer
from ..convert import stack_plans
from ..native import (PLANE_KEYS, NativePlanner, StepPlanner, assemble_shard,
                      make_pool_struct, pack_offsets)
from ..ops import device_core

# Per-step encoding of the FIRST (forward) vector grid, part of the step
# variant. Second (refsel-2) vectors live in a meta-derived pool after each
# slot's desc prefix and cost nothing on steps without bi macroblocks.
#   NONE    no mv field uploaded: every forward vector of the step is zero
#   PACKED8 two MBs per u32 (x.s8, y.s8 each): every vector fits s8
#   WIDE    one u32 per MB (y16 << 16 | x16): the escape for larger vectors
# (the JAX package keeps value 2 for a retired encoding; the values match)
_MV_NONE, _MV_PACKED8, _MV_WIDE = 0, 1, 3


# ---------------------------------------------------------------------------
# Layer 1: per-field lock-step step (shared by both host loops)
# ---------------------------------------------------------------------------

def multi_frame_step(plane_plans: list, nest, new_nest, is_i, is_ref,
                     ref_prev: list, ref_last: list):
    """One lock-step decode of N streams (per-field inputs).

    plane_plans: [plan dict (N, …)] for Y, U, V    is_i/is_ref: (N,) bool
    nest/new_nest: (N, nh, nw) u8                  ref_*: [(N, ph, pw) u8] x3
    Returns (frames [3], nest, ref_prev, ref_last). The state tensors are
    updated in place and returned; ref_prev and ref_last must not share
    storage. The frames are fresh tensors, not views of the state.

    The JAX package splits this into `_step_body` and a jitted wrapper that
    donates the state; without jit or donation the port needs one function.
    """
    if new_nest is not None:  # None: no I frame in the step
        nest.copy_(torch.where(is_i[:, None, None], new_nest, nest))
    frames = [device_core.decode_plane_inter(plans, nest, ref_prev[pi],
                                             ref_last[pi])
              for pi, plans in enumerate(plane_plans)]
    m = is_ref[:, None, None]
    for pi in range(len(frames)):
        # ref_prev takes ref_last before ref_last takes the new frame
        ref_prev[pi].copy_(torch.where(m, ref_last[pi], ref_prev[pi]))
        ref_last[pi].copy_(torch.where(m, frames[pi], ref_last[pi]))
    return frames, nest, ref_prev, ref_last


def init_state(cfg: SeqConfig, n: int, device) -> tuple:
    """Zeroed decode state for n streams: (nest, ref_prev, ref_last)."""
    def planes():
        return [torch.zeros((n, h, w), dtype=torch.uint8, device=device)
                for h, w in cfg.plane_shapes]

    nest = torch.zeros((n, *cfg.nest_shape), dtype=torch.uint8, device=device)
    return nest, planes(), planes()


# ---------------------------------------------------------------------------
# The per-field lock-step loop
# ---------------------------------------------------------------------------

def plan_steps(cfg: SeqConfig, clips: list[bytes]) -> Iterator[list]:
    """Host side of lock-step decode: for each step, every stream's next
    planned frame in decode order, or None once a stream has ended."""
    demuxers = [Demuxer(c) for c in clips]
    for d in demuxers:
        if d.info.cfg != cfg:
            raise ValueError("clip parameters do not match the step config")
    planners = [NativePlanner(cfg) for _ in clips]
    records = [(r for r in d.records() if r.media_type == MEDIA_VIDEO)
               for d in demuxers]
    while True:
        recs = [next(it, None) for it in records]
        if all(r is None for r in recs):
            return
        yield [None if r is None else pl.plan_frame(r.frame_char, r.payload)
               for pl, r in zip(planners, recs)]


def decode_lockstep(cfg: SeqConfig, clips: list[bytes],
                    device) -> Iterator[tuple]:
    """Decode N clips in lock-step on `device`. Yields, per step,
    (frames [3 x (N, H, W) u8], valid [N] bool): valid[j] is False once
    stream j has ended."""
    nest, ref_prev, ref_last = init_state(cfg, len(clips), device)
    for plans in plan_steps(cfg, clips):
        plane_plans, new_nest, is_i, is_ref = stack_plans(cfg, plans, device)
        frames, *_ = multi_frame_step(plane_plans, nest, new_nest, is_i,
                                      is_ref, ref_prev, ref_last)
        yield frames, [p is not None for p in plans]


# ---------------------------------------------------------------------------
# Staging layout: two dtype-homogeneous upload buffers per step (u8 / u32)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pool_caps(cfg: SeqConfig):
    """(raw_cap_full, desc_cap_full, dc_cap_full): worst-case pool slots
    for one frame."""
    total_blocks = sum(bh * bw for bh, bw in cfg.block_grids)
    return total_blocks, MAX_BASES * total_blocks, total_blocks


@functools.lru_cache(maxsize=None)
def _layout(cfg: SeqConfig, n: int, p8_cap: int, p32_cap: int,
            mv_mode: int, has_nest: bool, meta_bits: int = 6):
    """Static element layout of the two staging uploads of one step variant
    (the JAX package's v6 layout, byte for byte).

    u8  = [packed pool region, p8_cap bytes: per-slot segments back-to-back
           (raw ru*16 B, 16-aligned | dc cu B | nest nh*nw B on I slots),
           quantized to a 17/16 ladder | is_i | is_ref | meta codebook
           (n, 1<<meta_bits) when meta_bits < 6]
    u32 = [packed region, p32_cap elems: per-slot prefixes back-to-back —
           desc entries then refsel-2 mv2 pool words (y16 << 16 | x16)
           | offs (n, 4): per-slot bases (raw B, dc B, nest B, u32 elem)
           | meta planes ×3: ⌊32/meta_bits⌋ codebook indices per u32
           (meta_bits == 6: raw meta values, 5 per u32, no codebook)
           | mv field (see _MV_*)]

    `has_nest` changes no offset (the nest rides inside the pool region);
    it is part of the variant all the same.

    Returns ({u8 field → (elem_off, shape)}, {u32 ...}, size8, size32).
    """
    u8: dict = {"is_i": (p8_cap, (n,)), "is_ref": (p8_cap + n, (n,))}
    size8 = p8_cap + 2 * n
    if meta_bits < 6:
        u8["metacb"] = (size8, (n, 1 << meta_bits))
        size8 += n * (1 << meta_bits)
    u32: dict = {"offs": (p32_cap, (n, 4))}
    off = p32_cap + 4 * n
    per_word = 32 // meta_bits      # 5 @6 bits, 6 @5, 8 @4, 10 @3
    for pi, (bh, bw) in enumerate(cfg.block_grids):
        nwm = (bh * bw + per_word - 1) // per_word
        u32[f"meta{pi}"] = (off, (n, nwm))
        off += n * nwm
    mh, mw = cfg.mb_grid
    if mv_mode == _MV_PACKED8:
        mwp = (mh * mw + 1) // 2    # two MBs per u32
        u32["mvp8"] = (off, (n, mwp))
        off += n * mwp
    elif mv_mode == _MV_WIDE:
        u32["mv"] = (off, (n, mh, mw))
        off += n * mh * mw
    size32 = off
    return u8, u32, size8, size32


@functools.lru_cache(maxsize=None)
def _packed_tiers(full: int):
    """Size ladder for a packed region: geometric 17/16 steps from a 4096
    floor up to the worst case, 33/32 above 64 Ki elements. A step's
    totals cluster within a few percent for same-type frames; the ladder
    keeps the sizes a clip produces few. Values are 16-multiples so the u8
    region keeps raw segments aligned at any tier."""
    ts, v = [], 4096
    while v < full:
        ts.append(v)
        num, den = (33, 32) if v >= 65536 else (17, 16)
        v = (v * num // den + 15) & ~15
    ts.append(full)
    return tuple(ts)


def _pick_tier(used: int, full: int) -> int:
    for t in _packed_tiers(full):
        if used <= t:
            return t
    return full


# ---------------------------------------------------------------------------
# Layer 2: the device half of a step (plain PyTorch)
# ---------------------------------------------------------------------------

def _sext16(w):
    """Sign-extend the low 16 bits of int32 words (JAX: (w << 16) >> 16)."""
    return ((w & 0xFFFF) ^ 0x8000) - 0x8000


def _unpack_arena(cfg: SeqConfig, n: int, arenas: dict,
                  p8_cap: int, p32_cap: int,
                  mv_mode: int, has_nest: bool, meta_bits: int = 6):
    """Staging tensors → (plane plan dicts, new_nest | None, is_i, is_ref).

    `arenas` holds the two uploads as 1-D tensors: "u8" uint8 and "u32" as
    the int32 view of its words (torch cannot shift or gather uint32), so
    every shift below is `>>` on int32, arithmetic as in JAX. The plans
    come out in `convert.py`'s contract: meta, dc (n, bh, bw) u8; raw
    (n, H, W) u8; desc (n, 4, bh, bw) int32; mv, mv2 (n, 2, mh, mw) int16
    at macroblock resolution (the inter kernel reads one vector a block).

    Every pool index is clamped into its region: filler slots and
    non-carrying blocks read outside what was packed by design and are
    masked downstream by meta and is_i, where torch would raise (CPU) or
    assert (CUDA) on an out-of-range gather that JAX fills.
    """
    u8l, u32l, _s8, _s32 = _layout(cfg, n, p8_cap, p32_cap,
                                   mv_mode, has_nest, meta_bits)
    dev = arenas["u8"].device

    def fld(group, lay, name):
        off, shape = lay[name]
        return arenas[group][off:off + int(np.prod(shape))].reshape(shape)

    planes = [dict() for _ in cfg.block_grids]
    per_word = 32 // meta_bits
    mmask = (1 << meta_bits) - 1
    if meta_bits < 6:
        cb = fld("u8", u8l, "metacb")  # (n, 1<<B) codebook bytes
    for pi, (bh, bw) in enumerate(cfg.block_grids):
        # per_word B-bit values per u32, block-scan order
        w = fld("u32", u32l, f"meta{pi}")
        parts = torch.stack([(w >> (meta_bits * j)) & mmask
                             for j in range(per_word)], -1).reshape(n, -1)
        vals = parts[:, :bh * bw]
        if meta_bits < 6:   # codebook indices → meta bytes (one gather)
            vals = torch.gather(cb, 1, vals.long())
        planes[pi]["meta"] = vals.reshape(n, bh, bw).to(torch.uint8)

    # forward motion vectors at MB resolution, (n, mh, mw) int32 each
    mh, mw = cfg.mb_grid
    if mv_mode == _MV_NONE:
        z = torch.zeros((n, mh, mw), dtype=torch.int32, device=dev)
        mvc = {"mv": (z, z)}
    elif mv_mode == _MV_PACKED8:
        w = fld("u32", u32l, "mvp8")

        def s8p(k):  # byte k of each word, sign-extended
            b = (w >> (8 * k)) & 0xFF
            return b - ((b & 0x80) << 1)

        def lanes(x0, x1):  # the two MBs of a word back into scan order
            v = torch.stack([x0, x1], -1).reshape(n, -1)
            return v[:, :mh * mw].reshape(n, mh, mw)

        mvc = {"mv": (lanes(s8p(0), s8p(2)), lanes(s8p(1), s8p(3)))}
    else:
        v = fld("u32", u32l, "mv")
        mvc = {"mv": (_sext16(v), v >> 16)}

    is_i = fld("u8", u8l, "is_i") != 0
    is_ref = fld("u8", u8l, "is_ref") != 0

    # packed pool regions + per-slot bases (offs columns: raw B, dc B,
    # nest B, desc elem)
    pool8 = arenas["u8"][:p8_cap]
    desc_flat = arenas["u32"][:p32_cap]
    offs = fld("u32", u32l, "offs").long()
    raw_b, dc_b, nest_b, desc_e = offs.unbind(1)

    def at(pool, idx, cap):
        return pool[idx.clamp(0, cap - 1)]

    nh, nw = cfg.nest_shape
    new_nest = None
    if has_nest:
        nidx = nest_b[:, None] + torch.arange(nh * nw, device=dev)[None]
        new_nest = at(pool8, nidx, p8_cap).reshape(n, nh, nw)

    slots, dc_slots, desc_tot = _derive_slots(
        cfg, n, [pp["meta"] for pp in planes])

    # refsel-2 (bi) second vectors: pool entries (y16 << 16 | x16) after
    # each slot's desc prefix; entry k = the k-th bi MB in row-major MB
    # scan. Carriers are read off the luma meta at each MB's top-left
    # block (cls==1 & refsel==2), so no index field is uploaded.
    m0 = planes[0]["meta"].int()
    mbm = m0[:, ::2, ::2].reshape(n, -1)           # (n, mh*mw)
    carrier = (((mbm >> 5) & 1) != 0) & (((mbm >> 3) & 3) == 2)
    ci = carrier.long()
    pos = ci.cumsum(1) - ci
    # desc base + meta-derived desc count = this slot's mv2 pool base
    mv2_base = desc_e + desc_tot
    w2 = torch.where(carrier, at(desc_flat, mv2_base[:, None] + pos,
                                 p32_cap), 0)
    mvc["mv2"] = (_sext16(w2).reshape(n, mh, mw), (w2 >> 16).reshape(n, mh, mw))

    for pi, pp in enumerate(planes):
        bh, bw = cfg.block_grids[pi]
        H, W = bh * 4, bw * 4
        y = torch.arange(H, device=dev)[:, None]
        x = torch.arange(W, device=dev)[None, :]
        blk = (y >> 2) * bw + (x >> 2)                   # (H, W)
        slot = slots[pi]
        # raw: one gather lands the pixels directly in plane layout
        slot_up = slot.reshape(n, -1)[:, blk]            # (n, H, W)
        k = (y & 3) * 4 + (x & 3)
        pp["raw"] = at(pool8, raw_b[:, None, None] + slot_up * 16 + k,
                       p8_cap)
        # desc: (n, 4, bh, bw) component-major
        pp["desc"] = at(desc_flat, desc_e[:, None, None, None] + slot[:, None]
                        + torch.arange(4, device=dev)[None, :, None, None],
                        p32_cap)
        # dc grid: pool bytes for DC-carrying blocks (intra, mode != 6),
        # 128 elsewhere: the planner's dense grid
        m = pp["meta"].int()
        is_dc = (((m >> 5) & 1) == 0) & ((m & 7) != 6)
        pp["dc"] = torch.where(
            is_dc, at(pool8, dc_b[:, None, None] + dc_slots[pi], p8_cap),
            128).to(torch.uint8)
        # chroma half-pel value shift on the shared MB-resolution vectors
        chroma_mb = pi > 0 and cfg.h_samp == 2
        for key in ("mv", "mv2"):
            mvx, mvy = mvc[key]
            if chroma_mb:
                mvx, mvy = mvx >> 1, mvy >> 1
            pp[key] = torch.stack([mvx, mvy], 1).to(torch.int16)
    return planes, new_nest, is_i, is_ref


def _derive_slots(cfg: SeqConfig, n: int, metas: list):
    """Recompute each block's pool slots from meta alone.

    The planner allocates raw/desc/dc pool slots in canonical order (plane
    major, row-major block scan), so a block's raw index is the exclusive
    cumsum of `is_raw`, its desc start the exclusive cumsum of the
    per-block descriptor count, and its dc slot the exclusive cumsum of
    `is_dc` (intra non-raw), all over the concatenated planes. A block is
    never both raw and descriptor-carrying, so those two share one field.

    Returns (per-plane unified raw/desc slots, per-plane dc slots, per-slot
    total desc count (n,), the mv2 pool's offset), all int64: torch's
    cumsum of int32 gives int64, and the gathers index with int64.
    """
    flat = torch.cat([m.reshape(n, -1).long() for m in metas], 1)
    cls_ = (flat >> 5) & 1
    mode = flat & 7
    counts = device_core.basis_count(cls_, mode)
    is_raw = ((cls_ == 0) & (mode == 6)).long()
    csum = counts.cumsum(1)
    slot_flat = torch.where(is_raw != 0, is_raw.cumsum(1) - is_raw,
                            csum - counts)
    is_dc = ((cls_ == 0) & (mode != 6)).long()
    dc_flat = is_dc.cumsum(1) - is_dc
    out, out_dc, off = [], [], 0
    for bh, bw in cfg.block_grids:
        out.append(slot_flat[:, off:off + bh * bw].reshape(n, bh, bw))
        out_dc.append(dc_flat[:, off:off + bh * bw].reshape(n, bh, bw))
        off += bh * bw
    return out, out_dc, csum[:, -1]


def _run_steps(cfg: SeqConfig, n: int, k_steps: int,
               p8_cap: int, p32_cap: int,
               mv_mode: int, has_nest: bool, meta_bits: int,
               arenas: dict, nest, ref_prev: list, ref_last: list) -> list:
    """One dispatch: the arenas of n*k_steps virtual slots → k_steps
    lock-step decodes of n streams, state updated in place.

    Virtual slot k*n + j is stream j's k-th frame ahead, so the host
    planner and `_derive_slots` are exactly the (n*K)-stream ones. With
    k_steps == 1 the frames are [3 x (n, H, W)]; with fused dispatch they
    are stacked per step, [3 x (K, n, H, W)] (the JAX package's
    `lax.scan`, written as a loop over the (K, n) split of the slots)."""
    plane_plans, new_nest, is_i, is_ref = _unpack_arena(
        cfg, n * k_steps, arenas, p8_cap, p32_cap, mv_mode, has_nest,
        meta_bits)
    out = []
    for k in range(k_steps):
        s = slice(k * n, (k + 1) * n)
        frames, *_ = multi_frame_step(
            [{key: t[s] for key, t in pp.items()} for pp in plane_plans],
            nest, None if new_nest is None else new_nest[s], is_i[s],
            is_ref[s], ref_prev, ref_last)
        out.append(frames)
    if k_steps == 1:
        return out[0]
    return [torch.stack([f[pi] for f in out]) for pi in range(3)]


# ---------------------------------------------------------------------------
# Layer 3: the host orchestration (planning ring, assembly, upload)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Stream:
    records: list
    pos: int = 0
    failed: bool = False
    anchors: int = 0       # I/P frames decoded in the current GOP block
    cur_block: int = -1

    @property
    def active(self) -> bool:
        return self.pos < len(self.records) and not self.failed

    def take(self):
        """The next record, the cursor moved on; None once the stream has
        ended or is poisoned (a B frame without two references, FORMAT.md
        §10: the stream is invalid, the batch goes on)."""
        if not self.active:
            return None
        bi, fchar, _payload = self.records[self.pos]
        if bi != self.cur_block:      # GOP block boundary: refs reset
            self.cur_block = bi
            self.anchors = 0
        if fchar == "B" and self.anchors < 2:
            self.failed = True
            return None
        if fchar in ("I", "P"):
            self.anchors += 1
        self.pos += 1
        return self.records[self.pos - 1]


@dataclasses.dataclass(frozen=True)
class StreamShard:
    """A rank's place on the stream axis: shard `index` of `count` along
    the mesh axis `axis`, owning streams [index*n/count,
    (index+1)*n/count)."""
    index: int
    count: int
    axis: str = "dp"


def shard_streams(mesh, axis: str = "dp") -> StreamShard:
    """This rank's `StreamShard` along `axis` of a `DeviceMesh` (the JAX
    package's `NamedSharding(mesh, P(axis))`; the other axes replicate)."""
    from .dist import axis_size

    return StreamShard(mesh.get_local_rank(axis), axis_size(mesh, axis), axis)


@dataclasses.dataclass
class FrameMeta:
    ftype: str
    display_id: int


def _staging(n: int, dtype, pinned: bool):
    """A zeroed (1, n) staging row as numpy, and the pinned tensor behind
    it when `pinned` (the C++ planner writes straight into pinned memory,
    the upload reads the tensor). u32 words live in an int32 tensor: the
    device reads their int32 view."""
    if not pinned:
        return np.zeros((1, n), dtype), None
    t = torch.zeros((1, n), dtype=torch.uint8 if dtype == np.uint8
                    else torch.int32, pin_memory=True)
    return t.numpy().view(dtype), t


class MultiStreamDecoder:
    """Host orchestration of the arena decode of N streams of one
    SeqConfig on `device` (CUDA unless the caller asks for the CPU).

    clips: `.h4m` files, or `record_lists` of (block, frame char, payload)
    per stream. `steps_per_dispatch` (K) fuses K lock-step frames of every
    stream into one dispatch; `plan_ahead` sizes the staging ring (the
    steps that may be planned or in flight ahead of the device).
    `sharding` (a `StreamShard`) keeps this rank's share of the streams
    (module docstring); `n` and `streams` are then that share's.
    """

    def __init__(self, cfg: SeqConfig, clips: list[bytes], device="cuda", *,
                 record_lists: list | None = None,
                 steps_per_dispatch: int = 1,
                 plan_ahead: int = 1,
                 sharding: StreamShard | None = None):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {str(device)!r} requested but CUDA "
                               f"is not available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {str(device)!r}")
        self.planner = NativePlanner(cfg)
        self._k = max(int(steps_per_dispatch), 1)
        self._depth = max(int(plan_ahead), 1)
        streams = []
        if record_lists is not None:
            for recs in record_lists:
                streams.append(_Stream(records=list(recs)))
        else:
            for clip in clips:
                d = Demuxer(clip)
                if d.info.cfg != cfg:
                    raise ValueError("all streams must share one SeqConfig")
                recs = [(r.block_index, r.frame_char, r.payload)
                        for r in d.video_records()]
                streams.append(_Stream(records=recs))
        shard = sharding or StreamShard(0, 1)
        if len(streams) % shard.count:
            raise ValueError(
                f"{len(streams)} streams not divisible by mesh axis "
                f"{shard.axis!r} size {shard.count}")
        lo = shard.index * len(streams) // shard.count
        hi = (shard.index + 1) * len(streams) // shard.count
        self.streams = streams[lo:hi]
        # sharded: every stream's record cursor, walked alike on every rank
        # and never planned (module docstring)
        self._walk = ([_Stream(records=s.records) for s in streams]
                      if shard.count > 1 else [])
        self.n = len(self.streams)
        self.nest, self.ref_prev, self.ref_last = init_state(cfg, self.n,
                                                             self.device)
        # n*K VIRTUAL slots a dispatch: step k's plans occupy slots
        # [k*n, (k+1)*n) (see `_slot`)
        nv = self.n * self._k
        self._nv = nv
        rcap, dcap, dccap = _pool_caps(cfg)
        self._raw_cap_full, self._desc_cap_full = rcap, dcap
        self._dc_cap_full = dccap
        # worst-case packed regions: every slot at full pools + a nest,
        # each slot segment padded to 16; the u32 region also holds each
        # slot's refsel-2 mv2 pool (worst case: every MB bi)
        nh, nw = cfg.nest_shape
        mh, mw = cfg.mb_grid
        self._p8_full = nv * ((rcap * 16 + dccap + nh * nw + 15) & ~15)
        self._p32_full = nv * (dcap + mh * mw)
        # the bases travel as u32 and index as int64 on the device, but
        # the layout keeps the JAX package's int32 bound
        if max(self._p8_full, self._p32_full) >= 2**31:
            raise ValueError(
                f"staging region too large for int32 offsets: "
                f"p8_full={self._p8_full} p32_full={self._p32_full} "
                f"(streams*K={nv} at {cfg.width}x{cfg.height}); reduce "
                f"streams or steps_per_dispatch")
        # staging covers every variant: the u32 side is largest at
        # meta_bits=6 (5 values a word), the u8 side at meta_bits=5 (a
        # 32-entry codebook per slot rides in u8)
        _u8l, _u32l, max8_6, max32 = _layout(cfg, nv, self._p8_full,
                                             self._p32_full, _MV_WIDE, True, 6)
        _u8l5, _u32l5, max8_5, _m32_5 = _layout(
            cfg, nv, self._p8_full, self._p32_full, _MV_WIDE, True, 5)
        max8 = max(max8_6, max8_5)
        pinned = self.device.type == "cuda"
        self._bufs = []
        for _ in range(self._depth + 1):
            st8, pin8 = _staging(max8, np.uint8, pinned)
            st32, pin32 = _staging(max32, np.uint32, pinned)
            planes = [{"meta": np.zeros((nv, bh, bw), np.uint8),
                       "dc": np.full((nv, bh, bw), 128, np.uint8),
                       "slot": np.zeros((nv, bh, bw), np.uint32),
                       "meta5": np.zeros((nv, (bh * bw + 4) // 5), np.uint32)}
                      for bh, bw in cfg.block_grids]
            # per-slot CONTIGUOUS pool scratch (planner stride 1);
            # `_assemble` copies each slot's exact used prefix
            pools = {"raw": np.zeros((nv, rcap, 16), np.uint8),
                     "desc": np.zeros((nv, dcap), np.uint32),
                     "dc": np.zeros((nv, dccap), np.uint8)}
            buf = {"staging": {"u8": st8, "u32": st32},
                   "planes": planes, "pools": pools,
                   "new_nest": np.zeros((nv, nh, nw), np.uint8),
                   "mv": np.zeros((nv, mh, mw), np.uint32),
                   "mv2": np.zeros((nv, mh, mw), np.uint32),
                   "is_i": np.zeros(nv, np.uint8),
                   "is_ref": np.zeros(nv, np.uint8),
                   "mv_or": 0, "mv_fit": True,
                   # per-slot used counts: raw slots, desc elems, dc
                   # bytes, refsel-2 mv2 pool entries
                   "slot_used": np.zeros((nv, 4), np.int64),
                   # per-slot OR of (1 << meta byte): the assembler
                   # derives each slot's codebook and the step's meta_bits
                   "meta_mask": np.zeros(nv, np.uint64),
                   "offs": np.zeros((nv, 4), np.uint32),
                   "variant": None, "sizes": None}
            if pinned:
                buf["pinned"] = {"u8": pin8, "u32": pin32}
            views = [([{k: pp[k][v] for k in PLANE_KEYS} for pp in planes],
                      buf["new_nest"][v], buf["mv"][v], buf["mv2"][v])
                     for v in range(nv)]
            pool_structs = [make_pool_struct(
                pools["raw"][v], pools["desc"][v], pools["dc"][v],
                raw_stride=16, desc_stride=1,
                raw_cap=rcap, desc_cap=dcap, dc_cap=dccap)
                for v in range(nv)]
            buf["step_planner"] = StepPlanner(self.planner, nv, views,
                                              pool_structs)
            self._bufs.append(buf)
        self._cur = 0
        # cumulative per-stage wall-clock seconds: plan/assemble/stage are
        # recorded per buffer by the planning thread and folded in by the
        # consumer; the rest accumulate on the calling thread
        self.stats: dict[str, float] = {}
        self.reset_stats()

    def reset_stats(self) -> None:
        for k in ("plan_s", "assemble_s", "stage_s", "dequeue_s", "wait_s",
                  "upload_s", "dispatch_s", "steps", "frames"):
            self.stats[k] = 0.0

    # -- (stream, step) ↔ virtual arena slot ----------------------------------

    def _slot(self, si: int, k: int = 0) -> int:
        """Virtual slot of stream si's k-th frame in this dispatch
        (step-major: matches `_run_steps`'s (K, n) split)."""
        return k * self.n + si

    def _slot_inv(self, v: int) -> tuple[int, int]:
        k, si = divmod(v, self.n)
        return si, k

    @property
    def active(self) -> list[bool]:
        return [s.active for s in self.streams]

    def _more(self) -> bool:
        """Whether to step on: while a stream is active, or, sharded, while
        the walk of the whole list has frames left (the same on every
        rank)."""
        if self._walk:
            return any(s.active for s in self._walk)
        return any(self.active)

    # -- host half -------------------------------------------------------------

    def _fill_trivial(self, buf, v: int) -> None:
        """Inactive-slot filler: all-copy inter blocks with zero vectors
        (consumes NO pool slots — an all-intra filler would claim a dc-pool
        byte per block and blow the step's dc tier; the output is a copy of
        ref_prev, and invalid slots' output is never read)."""
        for pp in buf["planes"]:
            pp["meta"][v] = 0x20   # cls=1 mode=0 refsel=0: copy, no payload
            # the same byte in the packed 5-per-u32 upload form
            pp["meta5"][v] = 0x20820820
            pp["dc"][v] = 128
        buf["meta_mask"][v] = np.uint64(1) << np.uint64(0x20)
        # stale vectors from the buffer's previous use must not force the
        # step into a wider mv variant (`_assemble` scans the values)
        buf["mv"][v] = 0
        buf["mv2"][v] = 0
        buf["is_i"][v] = 0
        buf["is_ref"][v] = 0

    def plan_step(self):
        """Plan the next frame of every stream into the current ring slot
        and move the ring cursor on.

        Returns (buf, metas, valid). `buf` stays valid until the ring comes
        round to it again (`plan_ahead` + 1 calls later): `snapshot_step`
        it to keep a step planned further ahead. With fused dispatch (K > 1)
        a call plans the next K lock-step frames of every stream and
        metas/valid are nested per step: metas[k][si]."""
        buf, metas, valid, _failures = self._plan_step_into(
            self._bufs[self._cur], self._dequeue_jobs()[0])
        self._cur = (self._cur + 1) % len(self._bufs)
        if self._k == 1:
            return buf, metas[0], valid[0]
        return buf, metas, valid

    def _dequeue_jobs(self) -> tuple[list, list]:
        """Serially advance every stream's cursor, assigning the next K
        lock-step records of this rank's streams to virtual slots. Stateful,
        so it runs in step order; the planning of the returned jobs may run
        on any thread. Returns (the slot jobs, per step k whether the walk
        of the whole list has a frame there; all False unsharded)."""
        n, K = self.n, self._k
        slot_jobs: list = [None] * (K * n)
        for si, s in enumerate(self.streams):
            for k in range(K):
                job = s.take()
                if job is None:
                    break
                slot_jobs[self._slot(si, k)] = job
        walked = [False] * K
        for s in self._walk:
            for k in range(K):
                if s.take() is None:
                    break
                walked[k] = True
        return slot_jobs, walked

    def _plan_step_into(self, buf, slot_jobs):
        """Plan pre-dequeued jobs into `buf` and assemble its staging
        variant. Safe across DISTINCT buffers on concurrent threads.
        Returns (buf, metas[k][si], valid[k][si], failures), failures
        listing the (si, k) streams newly poisoned by THIS step."""
        uploaded = buf.pop("uploaded", None)
        if uploaded is not None:
            # the ring slot's last upload may still be reading its pinned
            # staging: let it finish before planning overwrites it
            uploaded.synchronize()
        t0 = time.perf_counter()
        buf["mv_or"] = 0
        buf["mv_fit"] = True
        buf["slot_used"][:] = 0
        buf["meta_mask"][:] = 0
        metas, valid, failures = self._plan_super(buf, slot_jobs)
        t1 = time.perf_counter()
        self._assemble(buf)
        # stashed per buffer: workers run concurrently, the consumer folds
        # these into self.stats
        buf["t_split"] = (t1 - t0, time.perf_counter() - t1)
        return buf, metas, valid, failures

    def _plan_and_stage(self, buf, slot_jobs):
        """Worker-side plan + assemble + upload (`run_pipelined` only; the
        synchronous `plan_step` does not upload, so callers can plan every
        step ahead and upload later)."""
        out = self._plan_step_into(buf, slot_jobs)
        t0 = time.perf_counter()
        buf["arenas_staged"] = self._stage_arenas(buf)
        buf["t_stage"] = time.perf_counter() - t0
        return out

    def _plan_super(self, buf, slot_jobs):
        """Plan one step's dequeued jobs into one fused arena (virtual slot
        `_slot(si, k)` = stream si's k-th frame of this dispatch).

        One GIL-released C call plans every slot; a failing slot poisons
        its stream FROM THAT FRAME ON (frames planned before it stay
        valid) and the step is planned again without the dropped slots
        (rare; planning is deterministic). Returns (metas[k][si],
        valid[k][si], failures)."""
        n, K = self.n, self._k
        failures: list[tuple[int, int]] = []
        metas = [[None] * n for _ in range(K)]
        valid = [[False] * n for _ in range(K)]
        sp = buf["step_planner"]
        jobs = [(j[1], j[2]) if j is not None else None for j in slot_jobs]
        while True:
            rc = sp.plan(jobs)
            if rc == 0:
                break
            si, kf = self._slot_inv(rc - 1)
            self.streams[si].failed = True
            failures.append((si, kf))
            for k in range(kf, K):  # earlier frames stay valid
                jobs[self._slot(si, k)] = None
        for v, job in enumerate(jobs):
            si, k = self._slot_inv(v)
            if job is None:
                self._fill_trivial(buf, v)
                continue
            fchar = job[0]
            fout = sp.fouts[v]
            buf["is_i"][v] = fchar == "I"
            buf["is_ref"][v] = fchar in ("I", "P")
            buf["slot_used"][v] = (int(fout.raw_used), int(fout.desc_used),
                                   int(fout.dc_used), int(fout.mv2_carriers))
            buf["meta_mask"][v] = np.uint64(fout.meta_mask)
            flags = int(fout.mv_flags)
            buf["mv_or"] |= flags
            buf["mv_fit"] &= bool(flags & 2)
            metas[k][si] = FrameMeta(fchar, int(fout.display_id))
            valid[k][si] = True
        return metas, valid, failures

    # -- assembly --------------------------------------------------------------

    def _assemble(self, buf) -> None:
        """Post-planning: pick the step's variant (pool tiers, mv encoding,
        nest presence, meta width) and pack the scratch into the staging
        rows with the C `pack_offsets` and `assemble_shard` (the JAX
        package's `_assemble_numpy` is their readable reference)."""
        cfg, nv = self.cfg, self._nv
        has_nest = bool(buf["is_i"].any())
        nh, nw = cfg.nest_shape
        nest_e = (nh * nw) if has_nest else 0
        tot8, tot32 = pack_offsets(buf["slot_used"], buf["is_i"], nest_e,
                                   buf["offs"])
        p8_cap = _pick_tier(tot8, self._p8_full)
        p32_cap = _pick_tier(tot32, self._p32_full)
        buf["used"] = (tot8, tot32)  # pre-tier totals (byte attribution)
        # mv variant from the planner's per-frame flags (first grid only)
        if not (buf["mv_or"] & 1):
            mv_mode = _MV_NONE
        elif not buf["mv_fit"]:
            mv_mode = _MV_WIDE
        else:
            mv_mode = _MV_PACKED8  # two MBs per u32
        # meta width: the smallest B whose codebook holds the worst slot's
        # distinct count (6 = raw escape)
        maxpop = max(bin(int(m)).count("1") for m in buf["meta_mask"])
        meta_bits = 3 if maxpop <= 8 else 4 if maxpop <= 16 else \
            5 if maxpop <= 32 else 6
        u8l, u32l, size8, size32 = _layout(cfg, nv, p8_cap, p32_cap,
                                           mv_mode, has_nest, meta_bits)
        assemble_shard(
            buf["staging"]["u8"][0], buf["staging"]["u32"][0],
            raw=buf["pools"]["raw"], desc=buf["pools"]["desc"],
            dcp=buf["pools"]["dc"], slot_used=buf["slot_used"],
            offs=buf["offs"],
            raw_cap_full=self._raw_cap_full,
            desc_cap_full=self._desc_cap_full,
            dc_cap_full=self._dc_cap_full,
            u8l=u8l, u32l=u32l,
            new_nest=buf["new_nest"] if has_nest else None,
            is_i=buf["is_i"], is_ref=buf["is_ref"],
            metas=[pp["meta"] for pp in buf["planes"]],
            meta5s=[pp["meta5"] for pp in buf["planes"]],
            meta_mask=buf["meta_mask"], meta_bits=meta_bits,
            mv=buf["mv"], mv2=buf["mv2"], mv_mode=mv_mode)
        buf["variant"] = (p8_cap, p32_cap, mv_mode, has_nest, meta_bits)
        buf["sizes"] = (size8, size32)

    def snapshot_step(self, buf):
        """Minimal copyable upload payload of a planned step: what a replay
        needs to run `device_step` without live planning (only the
        transferred staging prefixes)."""
        size8, size32 = buf["sizes"]
        return {"staging": {"u8": buf["staging"]["u8"][:, :size8].copy(),
                            "u32": buf["staging"]["u32"][:, :size32].copy()},
                "variant": buf["variant"], "sizes": buf["sizes"]}

    # -- upload + device half --------------------------------------------------

    def stage_packed(self, bufs, packed=None):
        """Pre-stage a replay pass of `snapshot_step` payloads with ONE
        upload per dtype instead of two per step.

        Concatenates every step's staging prefixes into one u8 and one u32
        host buffer, uploads the pair, and hands each step its slices of
        the whole-pass tensors at host offsets (`arenas_staged`, which
        `device_step` consumes). Returns the packed host buffers; pass them
        back in to skip the concatenation on another pass over the same
        steps."""
        if packed is None:
            tot8 = sum(b["sizes"][0] for b in bufs)
            tot32 = sum(b["sizes"][1] for b in bufs)
            big8 = np.empty(tot8, np.uint8)
            big32 = np.empty(tot32, np.uint32)
            offs, o8, o32 = [], 0, 0
            for b in bufs:
                s8, s32 = b["sizes"]
                big8[o8:o8 + s8] = b["staging"]["u8"][0, :s8]
                big32[o32:o32 + s32] = b["staging"]["u32"][0, :s32]
                offs.append((o8, o32))
                o8 += s8
                o32 += s32
            packed = {"u8": big8, "u32": big32, "offs": offs}
        # read only by the steps: aliasing on the CPU is harmless
        d8 = torch.from_numpy(packed["u8"]).to(self.device)
        d32 = torch.from_numpy(packed["u32"].view(np.int32)).to(self.device)
        for b, (o8, o32) in zip(bufs, packed["offs"]):
            s8, s32 = b["sizes"]
            b["arenas_staged"] = {"u8": d8[o8:o8 + s8],
                                  "u32": d32[o32:o32 + s32]}
        return packed

    def _stage_arenas(self, buf) -> dict:
        """Staging prefixes → device tensors: the step's two uploads.
        Called by `device_step`, or ahead of it on the planning worker in
        `run_pipelined`.

        A live CUDA ring slot uploads from its pinned rows without
        blocking and records an event that the next planning into that
        slot waits on. Elsewhere the step gets private copies: on the CPU
        `torch.from_numpy` would alias the ring, which is rewritten while
        a later step may still read it."""
        size8, size32 = buf["sizes"]
        pinned = buf.get("pinned")
        if pinned is not None:
            arenas = {"u8": pinned["u8"][0, :size8].to(self.device,
                                                       non_blocking=True),
                      "u32": pinned["u32"][0, :size32].to(self.device,
                                                         non_blocking=True)}
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            buf["uploaded"] = done
            return arenas
        h8 = buf["staging"]["u8"][0, :size8]
        h32 = buf["staging"]["u32"][0, :size32].view(np.int32)
        return {"u8": torch.from_numpy(h8.copy()).to(self.device),
                "u32": torch.from_numpy(h32.copy()).to(self.device)}

    def device_step(self, buf):
        """Batched decode of one planned step + state rotation: the two
        typed uploads (unless `run_pipelined` or `stage_packed` staged them
        already), then `_run_steps`. Accepts a live ring slot or a
        `snapshot_step` payload.

        With fused dispatch (K > 1) the returned frames are stacked
        per step: [3 x (K, n, H, W)]."""
        t0 = time.perf_counter()
        arenas = buf.pop("arenas_staged", None)
        if arenas is None:
            arenas = self._stage_arenas(buf)
        t1 = time.perf_counter()
        frames = _run_steps(self.cfg, self.n, self._k, *buf["variant"],
                            arenas, self.nest, self.ref_prev, self.ref_last)
        t2 = time.perf_counter()
        self.stats["upload_s"] += t1 - t0
        self.stats["dispatch_s"] += t2 - t1
        return frames

    def step(self):
        """plan + decode; returns (frames, metas, valid) or None when done.

        With fused dispatch (K > 1): frames [3 x (K, n, H, W)], metas and
        valid nested per step (metas[k][si])."""
        if not self._more():
            return None
        buf, metas, valid = self.plan_step()
        return self.device_step(buf), metas, valid

    def run_pipelined(self):
        """Generator over steps with host/device overlap.

        While the device runs step t, worker threads plan and upload steps
        t+1..t+`plan_ahead` into the other slots of the staging ring (the
        C++ planner releases the GIL). Job dequeue stays serial here
        (stream cursors are stateful); only planning fans out, over
        min(plan_ahead, cores) threads.

        A stream that poisons at step t may already have frames dequeued
        into steps > t; those are masked invalid here, so the caller sees
        the same per-stream validity as the unpipelined path.

        Yields (frames, metas, valid) per SINGLE step whatever the fused
        dispatch factor (stacked frames are sliced: views, no copy)."""
        workers = min(self._depth, os.cpu_count() or 1)
        ring = len(self._bufs)
        pending: collections.deque = collections.deque()
        dead = [False] * self.n

        with cf.ThreadPoolExecutor(max_workers=workers) as ex:
            def submit() -> bool:
                # advance self._cur (not a local cursor) so a later step()
                # or plan_step() continues the ring where this run left off
                if not self._more():
                    return False
                t0 = time.perf_counter()
                jobs, walked = self._dequeue_jobs()  # serial, in step order
                self.stats["dequeue_s"] += time.perf_counter() - t0
                buf = self._bufs[self._cur]
                self._cur = (self._cur + 1) % ring
                pending.append((ex.submit(self._plan_and_stage, buf, jobs),
                                walked))
                return True

            for _ in range(self._depth):
                if not submit():
                    break
            while pending:
                t0 = time.perf_counter()
                job, walked = pending.popleft()
                buf, metas, valid, failures = job.result()
                self.stats["wait_s"] += time.perf_counter() - t0
                tp, ta = buf["t_split"]
                self.stats["plan_s"] += tp
                self.stats["assemble_s"] += ta
                self.stats["stage_s"] += buf.get("t_stage", 0.0)
                self.stats["steps"] += 1
                self.stats["frames"] += sum(
                    v for row in valid for v in row)
                submit()
                frames = self.device_step(buf)
                for si in range(self.n):
                    if dead[si]:    # poisoned at an earlier step: frames
                        for k in range(self._k):   # planned ahead are void
                            metas[k][si] = None
                            valid[k][si] = False
                for si, _kf in failures:
                    dead[si] = True
                if self._k == 1:
                    yield frames, metas[0], valid[0]
                else:
                    for k in range(self._k):
                        if k > 0 and not (any(valid[k]) or walked[k]):
                            continue  # trailing filler slots of a short clip
                        yield ([frames[pi][k] for pi in range(3)],
                               metas[k], valid[k])


def decode_clip_gop_parallel(clip: bytes, device="cuda",
                             max_streams: int = 8):
    """Decode ONE `.h4m` clip with its GOP blocks batched as parallel
    streams on `device`.

    GOP blocks are independent seek points (reference state resets at each,
    FORMAT.md §2): blocks are dealt round-robin onto up to `max_streams`
    lanes of a `MultiStreamDecoder`, and each lane's frames are put back
    into decode order.

    Yields (block_index, yuv_bytes) per frame, in the clip's decode order,
    streaming: a frame is yielded as soon as every earlier frame of the clip
    has been. A corrupt GOP block poisons only its lane; its frames (and
    that lane's later blocks) are skipped while every other lane's frames
    still arrive. Frames come back to the host here (the export path).
    """
    d = Demuxer(clip)
    cfg = d.info.cfg
    blocks: list[list] = [[] for _ in d.block_offsets]
    for r in d.video_records():
        blocks[r.block_index].append((r.block_index, r.frame_char, r.payload))
    n = min(max_streams, len(blocks)) or 1
    lanes: list[list] = [[] for _ in range(n)]
    order: list[tuple[int, int]] = []   # decode order: (block, lane)
    for bi, recs in enumerate(blocks):
        lanes[bi % n].extend(recs)
        order.extend((bi, bi % n) for _ in recs)
    ms = MultiStreamDecoder(cfg, [], device, record_lists=lanes)
    per_lane = [collections.deque() for _ in range(n)]
    pos = 0
    done = False

    def drain():
        nonlocal pos
        while pos < len(order):
            bi, lane = order[pos]
            if per_lane[lane]:
                yield bi, per_lane[lane].popleft()
                pos += 1
            elif done or ms.streams[lane].failed:
                pos += 1    # lost to poisoning/end: skip, keep lanes flowing
            else:
                return      # wait for the lane to catch up

    for frames, _metas, valid in ms.run_pipelined():
        fnp = None
        for si, ok in enumerate(valid):
            if ok:
                if fnp is None:
                    fnp = [p.cpu().numpy() for p in frames]
                per_lane[si].append(b"".join(
                    fnp[pi][si].tobytes() for pi in range(3)))
        yield from drain()
    done = True
    yield from drain()
