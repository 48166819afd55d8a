"""NumPy golden decoder: `FramePlan` → YUV frames (reference layers L6/L7).

The port's copy of `hvqm4_tpu/refdec.py`, plus `decode_clip`, the clip loop
of the JAX package's `DecoderSession(backend="numpy")`. It is the readable
executable model of docs/FORMAT.md §6–7 pixel semantics (`WeightImBlock`,
`IntraAotBlock`, `OrgBlock`, `PrediAotBlock`, `_MotionComp00/01/10/11`, B
blending — SURVEY.md §2.3), vectorized over the block grid, and the third
party of `cli verify` beside the port's device core and the C oracle.

All arithmetic is int32 with arithmetic shifts; output is u8 planes.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from .config import MAX_BASES, MEDIA_VIDEO, SeqConfig
from .container import Demuxer
from .native import NativePlanner
from .plans import CLS_INTRA, REF_LAST, FramePlan, PlanePlan

_W = np.array([4, 1, 0, 0], np.int32)  # up/left weights; reversed for down/right


def weight_blocks(dc_grid: np.ndarray) -> np.ndarray:
    """Mode-0 smoothing over the whole grid (FORMAT.md §6.3) → (bh,bw,4,4) i32."""
    dc = dc_grid.astype(np.int32)
    dcU = np.concatenate([dc[:1], dc[:-1]], axis=0)
    dcD = np.concatenate([dc[1:], dc[-1:]], axis=0)
    dcL = np.concatenate([dc[:, :1], dc[:, :-1]], axis=1)
    dcR = np.concatenate([dc[:, 1:], dc[:, -1:]], axis=1)
    c = dc[:, :, None, None]
    wi = _W[None, None, :, None]       # over rows i
    wj = _W[None, None, None, :]       # over cols j
    acc = ((dcU[:, :, None, None] - c) * wi
           + (dcD[:, :, None, None] - c) * wi[:, :, ::-1, :]
           + (dcL[:, :, None, None] - c) * wj
           + (dcR[:, :, None, None] - c) * wj[:, :, :, ::-1])
    return c + ((acc + 8) >> 4)


def aot_acc(p: PlanePlan, nest: np.ndarray, count: np.ndarray) -> np.ndarray:
    """AOT accumulator Σ (nest_sample − off)·scale (FORMAT.md §6.2) → (bh,bw,4,4)."""
    nh, nw = nest.shape
    i = np.arange(4, dtype=np.int32)
    # sample coords per (block, basis, i, j), modular
    ny = p.basis_ny.astype(np.int32)[:, :, :, None] + i[None, None, None, :] \
        * p.basis_sy.astype(np.int32)[:, :, :, None]          # (bh,bw,B,4) rows
    nx = p.basis_nx.astype(np.int32)[:, :, :, None] + i[None, None, None, :] \
        * p.basis_sx.astype(np.int32)[:, :, :, None]          # (bh,bw,B,4) cols
    samples = nest.astype(np.int32)[(ny % nh)[:, :, :, :, None],
                                    (nx % nw)[:, :, :, None, :]]  # (bh,bw,B,4,4)
    terms = (samples - p.basis_off.astype(np.int32)[:, :, :, None, None]) \
        * p.basis_scale.astype(np.int32)[:, :, :, None, None]
    mask = (np.arange(MAX_BASES)[None, None, :] < count[:, :, None])
    return (terms * mask[:, :, :, None, None]).sum(axis=2)


def mc_predict(ref: np.ndarray, mv: np.ndarray) -> np.ndarray:
    """Half-pel MC for every block (FORMAT.md §7.4) → (bh,bw,4,4) i32.

    `ref` is the (ph, pw) u8 reference plane; `mv` is (bh,bw,2) half-pel.
    Clamped addressing makes every MV valid.
    """
    ph, pw = ref.shape
    bh, bw = mv.shape[:2]
    r = ref.astype(np.int32)
    j = np.arange(4, dtype=np.int32)
    gx = (np.arange(bw, dtype=np.int32) * 4)[None, :, None, None] + j[None, None, None, :]
    gy = (np.arange(bh, dtype=np.int32) * 4)[:, None, None, None] + j[None, None, :, None]
    sx = 2 * gx + mv[:, :, 0].astype(np.int32)[:, :, None, None]
    sy = 2 * gy + mv[:, :, 1].astype(np.int32)[:, :, None, None]
    ix, hx = sx >> 1, sx & 1
    iy, hy = sy >> 1, sy & 1

    def at(y, x):
        return r[np.clip(y, 0, ph - 1), np.clip(x, 0, pw - 1)]

    a = at(iy, ix)
    b = at(iy, ix + 1)
    c = at(iy + 1, ix)
    d = at(iy + 1, ix + 1)
    return np.select(
        [(hx == 0) & (hy == 0), (hx == 1) & (hy == 0), (hx == 0) & (hy == 1)],
        [a, (a + b + 1) >> 1, (a + c + 1) >> 1],
        default=(a + b + c + d + 2) >> 2,
    )


def decode_plane(p: PlanePlan, nest: np.ndarray,
                 ref0: np.ndarray | None, ref1: np.ndarray | None) -> np.ndarray:
    """One plane from its plan (+ refs for P/B) → (ph, pw) u8."""
    bh, bw = p.mode.shape
    mode = p.mode.astype(np.int32)
    intra_count = np.where((p.cls == CLS_INTRA) & (mode >= 1) & (mode <= 4), mode, 0)
    inter_count = np.where(p.cls != CLS_INTRA, mode, 0)
    acc = aot_acc(p, nest, (intra_count + inter_count).astype(np.int32))

    dc = p.dc.astype(np.int32)[:, :, None, None]
    wpx = weight_blocks(p.dc)
    apx = dc + (acc >> 4)
    rpx = p.raw.astype(np.int32).reshape(bh, bw, 4, 4)
    intra_px = np.select(
        [mode[:, :, None, None] == 0, mode[:, :, None, None] == 6],
        [wpx, rpx], default=apx)

    if ref0 is not None or ref1 is not None:
        z = np.zeros((p.mode.shape[0] * 4, p.mode.shape[1] * 4), np.uint8)
        r0 = ref0 if ref0 is not None else z
        r1 = ref1 if ref1 is not None else z
        pf = mc_predict(r0, p.mv)           # forward / past
        pl_ = mc_predict(r1, p.mv)          # ref_last with the same (fwd) mv
        pb = mc_predict(r1, p.mv2)          # backward mv into ref_last
        sel = p.refsel[:, :, None, None]
        pred = np.select([sel == 0, sel == REF_LAST],
                         [pf, pl_], default=(pf + pb + 1) >> 1)
        inter_px = pred + (acc >> 4)
    else:
        inter_px = intra_px

    px = np.where((p.cls == CLS_INTRA)[:, :, None, None], intra_px, inter_px)
    px = np.clip(px, 0, 255).astype(np.uint8)
    return px.transpose(0, 2, 1, 3).reshape(bh * 4, bw * 4)


class GoldenDecoder:
    """Sequence-level golden decode: plans in decode order → u8 frames."""

    def __init__(self, cfg: SeqConfig):
        self.cfg = cfg
        self.reset()

    def reset(self) -> None:
        """Reset reference state (GOP/block seek point, SURVEY.md §5)."""
        self.ref_prev: list[np.ndarray] | None = None
        self.ref_last: list[np.ndarray] | None = None
        self.nest = np.zeros(self.cfg.nest_shape, np.uint8)

    def decode(self, plan: FramePlan) -> list[np.ndarray]:
        """Decode one frame → [Y, U, V] u8 planes; updates reference state."""
        if plan.ftype == "I":
            assert plan.nest is not None
            self.nest = plan.nest
        refs0 = self.ref_prev
        refs1 = self.ref_last
        if plan.ftype in ("P", "B") and refs1 is None:
            raise ValueError("P/B frame without reference")
        if plan.ftype == "B" and refs0 is None:
            raise ValueError("B frame without two references")
        planes = []
        for pi, p in enumerate(plan.planes):
            if plan.ftype == "I":
                planes.append(decode_plane(p, self.nest, None, None))
            else:
                # P: both ref slots resolve to ref_last (planner sets REF_LAST);
                # B: ref0 = past (ref_prev), ref1 = future (ref_last).
                r1 = refs1[pi]
                r0 = refs0[pi] if plan.ftype == "B" else r1
                planes.append(decode_plane(p, self.nest, r0, r1))
        if plan.ftype in ("I", "P"):
            self.ref_prev = self.ref_last
            self.ref_last = planes
        return planes


def decode_clip(cfg: SeqConfig, data: bytes) -> Iterator[list[np.ndarray]]:
    """Golden decode of a whole `.h4m` file: [Y, U, V] u8 planes per frame,
    in decode order (as the C oracle writes them), with the reference state
    reset at every GOP block (FORMAT.md §2)."""
    demux = Demuxer(data)
    if demux.info.cfg != cfg:
        raise ValueError("clip parameters do not match the config")
    planner = NativePlanner(cfg)
    dec = GoldenDecoder(cfg)
    for b in range(len(demux.block_offsets)):
        dec.reset()
        for rec in demux.block_records(b):
            if rec.media_type == MEDIA_VIDEO:
                yield dec.decode(planner.plan_frame(rec.frame_char,
                                                    rec.payload))
