"""Content-aware HVQM4 encoder: YUV frames → `.h4m`.

The port's copy of `hvqm4_tpu/encode.py`, line for line where the stream's
bits are decided, and held byte-equal to it by `tests/test_torch_encode.py`.
Two things differ: the closed loop plans with the C++ `NativePlanner` (the
port has no Python planner), and the full-nest search of
`use_tpu_search=True` (`encode_tpu.NestSearch`) runs in PyTorch on `device`.

The reference is decode-only; this encoder completes the toolkit so real
content can round-trip through the decode pipeline. It is a *host-side* tool
(numpy) with classic mode decision:

- per 4×4 block: weighted-DC vs greedy nest-basis AOT (matching pursuit over
  a sampled candidate set) vs raw escape, chosen by SSE + λ·bits;
- per 8×8 MB (P/B): copy vs full-pel motion search (±range, SAD) with
  half-pel refinement vs intra, with forward/backward/bidirectional
  selection for B frames;
- closed loop: after serializing each frame the encoder *decodes it with the
  framework's own planner + golden decoder*, so its reference frames are
  exactly the decoder's — no drift, by construction.

Quality knobs are deliberately simple (this is a corpus/round-trip tool, not
a rate-distortion contest); `lambda_bits` trades size vs PSNR.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from .bitio import BitWriter, HuffWriter
from .config import (FRAME_B, FRAME_I, FRAME_P, HEADER_SIZE, MEDIA_AUDIO,
                     MEDIA_VIDEO, N_STREAMS, SeqConfig)
from .native import NativePlanner
from .plans import build_nest
from .refdec import GoldenDecoder, weight_blocks


@dataclasses.dataclass
class _BlockDecision:
    mode: int                 # 0 weight | 1..4 aot | 6 raw
    dc_target: int = 128      # effective DC (modes 0..4)
    bases: list = dataclasses.field(default_factory=list)  # (nx,ny,sxb,syb,off,scale)
    raw: np.ndarray | None = None


def _blockify(plane: np.ndarray) -> np.ndarray:
    h, w = plane.shape
    return plane.reshape(h // 4, 4, w // 4, 4).transpose(0, 2, 1, 3)


class _CandidateSet:
    """Sampled nest basis candidates for greedy matching pursuit."""

    def __init__(self, nest: np.ndarray, rng, k: int = 384):
        nh, nw = nest.shape
        self.desc = []
        vecs = []
        for _ in range(k):
            nx = int(rng.integers(0, 128))
            ny = int(rng.integers(0, 128))
            sxb = int(rng.integers(0, 2))
            syb = int(rng.integers(0, 2))
            i = np.arange(4)
            rows = (ny + i * (syb + 1)) % nh
            cols = (nx + i * (sxb + 1)) % nw
            v = nest[np.ix_(rows, cols)].astype(np.int32).reshape(16)
            off = int(np.clip(round(v.mean()), 0, 255))
            c = v - off
            if not c.any():
                continue
            self.desc.append((nx, ny, sxb, syb, off))
            vecs.append(c)
        # a constant nest (e.g. after an all-raw I frame) yields no usable
        # candidates; callers receive None from best() and skip AOT
        self.C = (np.array(vecs, np.float32) if vecs
                  else np.zeros((0, 16), np.float32))
        self.cc = (self.C * self.C).sum(1) + 1e-9        # (K,)

    def best(self, residual: np.ndarray):
        """Greedy step: best candidate + integer scale for one residual,
        or None when the candidate set is empty. The returned term is the
        UNSHIFTED (sample − off)·scale vector: the decoder shifts the SUM
        over a block's bases once (FORMAT.md §6.2), so callers accumulate
        terms and apply a single >> 4."""
        if not len(self.C):
            return None
        r = residual.astype(np.float32)
        dots = self.C @ r                                # (K,)
        gains = dots * dots / self.cc
        k = int(np.argmax(gains))
        scale = int(np.clip(round(16.0 * dots[k] / self.cc[k]), -128, 127))
        nx, ny, sxb, syb, off = self.desc[k]
        return (nx, ny, sxb, syb, off, scale), self.C[k].astype(np.int32) * scale


class VideoEncoder:
    def __init__(self, cfg: SeqConfig, lambda_bits: float = 4.0,
                 mv_range: int = 7, aot_bases: int = 2, seed: int = 0,
                 use_tpu_search: bool = False, nest_mu: float = 0.25,
                 slices: int = 1, dc_shift: int = 0, psy: float = 0.0,
                 device="cuda"):
        """`use_tpu_search` scores every nest candidate on `device`
        (`encode_tpu.NestSearch`) instead of sampling a few hundred on the
        host; with it on and no card the constructor raises unless the
        caller asks for `device="cpu"`. With it off no device is used."""
        self.cfg = cfg
        if not (0 <= dc_shift <= 7):
            raise ValueError("dc_shift must be in [0, 7]")
        self.dc_shift = dc_shift
        self.lam = lambda_bits
        # psychovisual strength: 0 = plain SSE RD; 1 = full TM5-style
        # activity masking (textured blocks tolerate more error than flat
        # ones, so their effective lambda rises and bits flow to flat areas)
        self.psy = float(psy)
        self.mv_range = mv_range
        self.aot_bases = aot_bases
        self.rng = np.random.default_rng(seed)
        self.planner = NativePlanner(cfg)
        self.dec = GoldenDecoder(cfg)
        self.use_tpu_search = use_tpu_search
        self.device = None
        if use_tpu_search:
            from .encode_tpu import search_device

            self.device = search_device(device)
        self.nest_mu = nest_mu
        mh, _mw = cfg.mb_grid
        if not (1 <= slices <= mh):
            raise ValueError(f"slice count must be in [1, {mh}]")
        self.slices = slices

    # -- psychovisual weighting -------------------------------------------------

    def _psy_weights(self, plane: np.ndarray, grid: int = 4) -> np.ndarray | None:
        """Per-block lambda multipliers from local activity (texture
        masking). TM5-style normalized activity N = (2a + a̅)/(a + 2a̅)
        ∈ [0.5, 2] — busy blocks (high variance) mask coding error, flat
        blocks reveal it — raised to `psy` so 0 disables smoothly. Returns
        None when psy == 0 (scalar-lambda fast paths stay untouched)."""
        if not self.psy:
            return None
        h, w = plane.shape
        gh, gw = h // grid, w // grid
        cells = (plane.astype(np.float64)
                 .reshape(gh, grid, gw, grid).transpose(0, 2, 1, 3)
                 .reshape(gh, gw, grid * grid))
        act = cells.var(axis=2) + 1.0
        avg = float(act.mean())
        n = (2.0 * act + avg) / (act + 2.0 * avg)
        return n ** self.psy

    # -- per-plane intra decision ---------------------------------------------

    def _intra_plane(self, plane: np.ndarray, cand: _CandidateSet,
                     raw_penalty: np.ndarray | None = None,
                     raw_frozen: np.ndarray | None = None):
        """Per-block mode decision (weight / AOT / raw) for one plane.

        raw_penalty: extra DISTORTION charged to the raw escape per block
        (the nest-poisoning term, see `_nest_penalty`). raw_frozen: when
        given, each block's raw decision is fixed (True → raw, False → raw
        banned) — used by the second I-frame pass so the nest the bases were
        chosen against is exactly the decoder's.
        """
        bh, bw = plane.shape[0] // 4, plane.shape[1] // 4
        blocks = _blockify(plane).astype(np.int32)       # (bh,bw,4,4)
        dcg = np.clip(np.round(blocks.reshape(bh, bw, 16).mean(2)),
                      0, 255).astype(np.uint8)
        # vectorized weight-mode reconstruction for every block
        wrec = np.clip(weight_blocks(dcg), 0, 255)
        wsse = ((wrec - blocks) ** 2).reshape(bh, bw, 16).sum(2)

        out = [[None] * bw for _ in range(bh)]
        psy_w = self._psy_weights(plane)
        for by in range(bh):
            for bx in range(bw):
                lam = self.lam if psy_w is None else \
                    self.lam * float(psy_w[by, bx])
                target = blocks[by, bx].reshape(16)
                if raw_frozen is not None and raw_frozen[by, bx]:
                    out[by][bx] = _BlockDecision(
                        mode=6, raw=target.astype(np.uint8).copy())
                    continue
                dc = int(dcg[by, bx])
                best_cost = wsse[by, bx] + lam * 10
                best = _BlockDecision(mode=0, dc_target=dc)
                # greedy AOT (acc holds UNSHIFTED terms; decoder semantics
                # apply one >> 4 to the sum)
                resid = target - dc
                bases, acc = [], np.zeros(16, np.int32)
                for _k in range(self.aot_bases):
                    hit = cand.best(resid - (acc >> 4))
                    if hit is None:
                        break
                    b, term = hit
                    if b[5] == 0:
                        break
                    bases.append(b)
                    acc = acc + term
                    rec = np.clip(dc + (acc >> 4), 0, 255)
                    sse = int(((rec - target) ** 2).sum())
                    cost = sse + lam * (10 + 34 * len(bases))
                    if cost < best_cost:
                        best_cost = cost
                        best = _BlockDecision(mode=len(bases), dc_target=dc,
                                              bases=list(bases))
                if raw_frozen is None:
                    raw_cost = lam * 132
                    if raw_penalty is not None:
                        raw_cost += float(raw_penalty[by, bx])
                    if raw_cost < best_cost:
                        best = _BlockDecision(
                            mode=6, raw=target.astype(np.uint8).copy())
                out[by][bx] = best
        return out, dcg

    def _intra_plane_batched(self, plane: np.ndarray, search,
                             raw_penalty: np.ndarray | None = None,
                             raw_frozen: np.ndarray | None = None):
        """Vectorized mode decision using the full-nest device search
        (encode_tpu.NestSearch): one tiled product per matching-pursuit
        round instead of per-block scans. raw_penalty / raw_frozen as in
        `_intra_plane`."""
        bh, bw = plane.shape[0] // 4, plane.shape[1] // 4
        blocks = _blockify(plane).astype(np.int32).reshape(bh, bw, 16)
        dcg = np.clip(np.round(blocks.mean(2)), 0, 255).astype(np.uint8)
        wrec = np.clip(weight_blocks(dcg), 0, 255).reshape(bh, bw, 16)
        wsse = ((wrec - blocks) ** 2).sum(2)

        flat = blocks.reshape(-1, 16)
        dcs = dcg.reshape(-1).astype(np.int32)
        resid0 = flat - dcs[:, None]
        # terms are UNSHIFTED; the decoder applies one >> 4 to the SUM
        d1, t1, s1 = search.best(resid0)
        rec1 = np.clip(dcs[:, None] + (t1 >> 4), 0, 255)
        sse1 = ((rec1 - flat) ** 2).sum(1)
        d2, t2, s2 = search.best(resid0 - (t1 >> 4))
        rec2 = np.clip(dcs[:, None] + ((t1 + t2) >> 4), 0, 255)
        sse2 = ((rec2 - flat) ** 2).sum(1)

        psy_w = self._psy_weights(plane)
        lam = (self.lam if psy_w is None
               else self.lam * psy_w.reshape(-1))   # scalar or (nb,)
        raw_cost = np.broadcast_to(np.asarray(lam * 132, np.float64),
                                   (len(flat),)).copy()
        if raw_penalty is not None:
            raw_cost = raw_cost + raw_penalty.reshape(-1)
        if raw_frozen is not None:
            raw_cost = np.where(raw_frozen.reshape(-1), -np.inf, np.inf)
        costs = np.stack([
            wsse.reshape(-1) + lam * 10,                 # mode 0
            sse1 + lam * 44,                             # aot-1
            np.where(s2 != 0, sse2 + lam * 78, np.inf),  # aot-2
            raw_cost,                                    # raw escape
        ])
        costs[1] = np.where(s1 != 0, costs[1], np.inf)
        choice = np.argmin(costs, axis=0)

        out = [[None] * bw for _ in range(bh)]
        for bi in range(len(flat)):
            by, bx = divmod(bi, bw)
            c = choice[bi]
            if c == 0:
                out[by][bx] = _BlockDecision(mode=0, dc_target=int(dcs[bi]))
            elif c == 3:
                out[by][bx] = _BlockDecision(
                    mode=6, raw=flat[bi].astype(np.uint8))
            else:
                bases = [(int(d1[bi][0]), int(d1[bi][1]), int(d1[bi][2]),
                          int(d1[bi][3]), int(d1[bi][4]), int(s1[bi]))]
                if c == 2:
                    bases.append((int(d2[bi][0]), int(d2[bi][1]),
                                  int(d2[bi][2]), int(d2[bi][3]),
                                  int(d2[bi][4]), int(s2[bi])))
                out[by][bx] = _BlockDecision(mode=len(bases),
                                             dc_target=int(dcs[bi]),
                                             bases=bases)
        return out, dcg

    # -- decision plumbing ------------------------------------------------------

    def _make_search(self, nest: np.ndarray):
        """(search, cand) for a nest: the full-nest device search when
        enabled and usable, else the sampled host candidate set."""
        if self.use_tpu_search:
            from .encode_tpu import NestSearch

            search = NestSearch(nest, self.device)
            if search.ok:
                return search, None
        return None, _CandidateSet(nest, self.rng)

    def _decide_plane(self, plane, search, cand,
                      raw_penalty=None, raw_frozen=None):
        if search is not None:
            return self._intra_plane_batched(plane, search,
                                             raw_penalty, raw_frozen)
        return self._intra_plane(plane, cand, raw_penalty, raw_frozen)

    def _effective_dcg(self, dec_y: list, bh: int, bw: int) -> np.ndarray:
        """The DECODER's effective luma DC grid for these decisions.

        Simulates the serializer's per-slice prediction chain including the
        dc_shift quantization, so the nest the bases are selected against is
        exactly the one the decoder will build (FORMAT.md §5.4/§6.1). With
        dc_shift == 0 this reduces to target DCs with raw blocks at 128."""
        sh = self.dc_shift
        mh, _mw = self.cfg.mb_grid
        S = self.slices
        ed = np.full((bh, bw), 128, np.int32)
        for sl in range(S):
            row0 = (sl * mh // S) * 2       # luma: 2 block rows per MB row
            row1 = ((sl + 1) * mh // S) * 2
            for by in range(row0, row1):
                for bx in range(bw):
                    d = dec_y[by][bx]
                    if d.mode == 6:
                        ed[by, bx] = 128
                        continue
                    pred = (int(ed[by, bx - 1]) if bx > 0
                            else int(ed[by - 1, bx]) if by > row0 else 128)
                    delta = (d.dc_target - pred) % 256
                    if delta > 127:
                        delta -= 256
                    v = int(round(delta / (1 << sh))) if sh else delta
                    ed[by, bx] = (pred + (v << sh)) & 0xFF
        return ed.astype(np.uint8)

    def _pick_nest_origin(self, eff: np.ndarray) -> tuple[int, int]:
        """Choose (nest_x, nest_y) maximizing dictionary diversity.

        The nest window is a free parameter of the bitstream (FORMAT.md
        §6.1); a window over a flat or raw-pinned region yields near-
        constant atoms that matching pursuit can't use. Sample variance of
        the candidate window is the proxy: raw cells (pinned to 128) and
        flat areas depress it, structured areas raise it. A coarse 8x8
        origin grid is enough — the modular wrap makes nearby origins
        nearly equivalent."""
        bh, bw = eff.shape
        nh, nw = self.cfg.nest_shape
        best, best_score = (0, 0), -1.0
        for ny in range(0, bh, max(bh // 8, 1)):
            for nx in range(0, bw, max(bw // 8, 1)):
                ys = (ny + np.arange(nh)) % bh
                xs = (nx + np.arange(nw)) % bw
                score = float(eff[np.ix_(ys, xs)].astype(np.float64).var())
                if score > best_score:
                    best_score, best = score, (nx, ny)
        return best

    def _nest_penalty(self, dcg_y: np.ndarray) -> np.ndarray:
        """Distortion the GOP inherits when a luma block goes raw.

        A raw block's effective DC is pinned to 128, so every nest cell
        sampled from it (FORMAT.md §6.1; the modular wrap may sample a cell
        more than once) carries (dc-128)^2 error into the basis dictionary
        that intra-AOT and inter-residual coding draw from for the whole
        GOP. `nest_mu` is the empirical reuse weight (how many future basis
        samples a poisoned cell is expected to serve), tuned on
        tools/rd_sweep.py for a lambda-monotone RD curve.
        """
        bh, bw = dcg_y.shape
        nh, nw = self.cfg.nest_shape
        cnt = np.zeros((bh, bw), np.int64)
        ys = np.arange(nh) % bh
        xs = np.arange(nw) % bw
        np.add.at(cnt, (ys[:, None], xs[None, :]), 1)
        dc = dcg_y.astype(np.int64)
        return self.nest_mu * cnt * (dc - 128) ** 2

    # -- motion search --------------------------------------------------------

    def _mb_search(self, cur: np.ndarray, ref: np.ndarray, my: int, mx: int):
        """Full-pel SAD search ±range + half-pel refine; returns (mv, sse)."""
        h, w = ref.shape
        y0, x0 = my * 8, mx * 8
        tgt = cur[y0:y0 + 8, x0:x0 + 8].astype(np.int32)
        best = (0, 0, 1 << 30)
        R = self.mv_range
        refi = ref.astype(np.int32)
        for dy in range(-R, R + 1):
            sy = y0 + dy
            if sy < 0 or sy + 8 > h:
                continue
            for dx in range(-R, R + 1):
                sx = x0 + dx
                if sx < 0 or sx + 8 > w:
                    continue
                sse = int(((refi[sy:sy + 8, sx:sx + 8] - tgt) ** 2).sum())
                if sse < best[2]:
                    best = (dx, dy, sse)
        # half-pel refine around the best full-pel vector
        bx2, by2, bsse = 2 * best[0], 2 * best[1], best[2]
        for hy in (-1, 0, 1):
            for hx in (-1, 0, 1):
                mv = (2 * best[0] + hx, 2 * best[1] + hy)
                rec = self._mc_block(ref, y0, x0, mv)
                sse = int(((rec - tgt) ** 2).sum())
                if sse < bsse:
                    bx2, by2, bsse = mv[0], mv[1], sse
        return (bx2, by2), bsse

    @staticmethod
    def _mc_block(ref: np.ndarray, y0: int, x0: int, mv, size: int = 8):
        """size×size half-pel MC identical to FORMAT.md §7.4 (clamped)."""
        h, w = ref.shape
        r = ref.astype(np.int32)
        ys = 2 * (y0 + np.arange(size))[:, None] + mv[1]
        xs = 2 * (x0 + np.arange(size))[None, :] + mv[0]
        iy, hy = ys >> 1, ys & 1
        ix, hx = xs >> 1, xs & 1

        def at(y, x):
            return r[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)]

        a = at(iy, ix)
        b = at(iy, ix + 1)
        c = at(iy + 1, ix)
        d = at(iy + 1, ix + 1)
        return np.select(
            [(hx == 0) & (hy == 0), (hx == 1) & (hy == 0), (hx == 0) & (hy == 1)],
            [a, (a + b + 1) >> 1, (a + c + 1) >> 1],
            default=(a + b + c + d + 2) >> 2)

    # -- frame encoders -------------------------------------------------------

    def _encode_frame(self, ftype: str, display_id: int, frame, refs):
        """Decide + serialize one frame; returns payload bytes."""
        cfg = self.cfg
        y = frame[0]
        mb_map = None
        mv_map = {}
        ref_map = {}
        intra_mbs = set()
        if ftype in ("P", "B"):
            mh, mw = cfg.mb_grid
            mb_map = np.zeros((mh, mw), np.uint8)
            past = refs[0][0] if ftype == "B" else refs[1][0]
            futu = refs[1][0]
            psy_mb = self._psy_weights(y, grid=8)
            for my in range(mh):
                for mx in range(mw):
                    lam = self.lam if psy_mb is None else \
                        self.lam * float(psy_mb[my, mx])
                    y0, x0 = my * 8, mx * 8
                    tgt = y[y0:y0 + 8, x0:x0 + 8].astype(np.int32)
                    sse_copy = int(((past[y0:y0 + 8, x0:x0 + 8].astype(np.int32)
                                     - tgt) ** 2).sum())
                    mv_f, sse_f = self._mb_search(y, past, my, mx)
                    cands = [("copy", sse_copy + lam * 2, None, 0),
                             ("fwd", sse_f + lam * 30, mv_f, 0)]
                    if ftype == "B":
                        mv_b, sse_b = self._mb_search(y, futu, my, mx)
                        recf = self._mc_block(past, y0, x0, mv_f)
                        recb = self._mc_block(futu, y0, x0, mv_b)
                        sse_bi = int(((((recf + recb + 1) >> 1) - tgt) ** 2).sum())
                        cands += [("bwd", sse_b + lam * 30, mv_b, 1),
                                  ("bi", sse_bi + lam * 58, (mv_f, mv_b), 2)]
                    kind, cost, mv, rs = min(cands, key=lambda c: c[1])
                    # crude intra estimate: block variance
                    intra_est = int(((tgt - tgt.mean()) ** 2).sum()) + lam * 60
                    if intra_est < cost:
                        mb_map[my, mx] = 1
                        intra_mbs.add((my, mx))
                    elif kind == "copy":
                        mb_map[my, mx] = 0
                    else:
                        mb_map[my, mx] = 2
                        mv_map[(my, mx)] = mv
                        ref_map[(my, mx)] = rs

        # intra decisions per plane (full grids; non-intra entries unused)
        plane_decisions = []
        nest_x = nest_y = 0
        if ftype == "I":
            # Two-pass I-frame intra decision. The decoder's nest is built
            # from the EFFECTIVE luma DC grid, in which raw blocks are pinned
            # to 128 (FORMAT.md §6.6): deciding against the target-DC nest
            # would select AOT bases the decoder's dictionary can't
            # reproduce, and letting cheap raw escapes pin cells to 128
            # flattens the dictionary every AOT / inter-residual block of
            # the GOP draws from (at low lambda this collapsed P/B quality —
            # tools/rd_sweep.py regression). Pass 1 charges raw its nest
            # distortion; pass 2 freezes the raw set (making the effective
            # DC grid — hence the nest — exact) and re-selects every basis
            # against the decoder's true nest.
            blocks = _blockify(y).astype(np.int32)
            bh, bw = blocks.shape[:2]
            dcg_y_targets = np.clip(
                np.round(blocks.reshape(bh, bw, 16).mean(2)), 0, 255
            ).astype(np.uint8)
            nest0 = build_nest(cfg, dcg_y_targets, 0, 0)
            search, cand = self._make_search(nest0)
            dec_y, _ = self._decide_plane(
                y, search, cand,
                raw_penalty=self._nest_penalty(dcg_y_targets))
            raw_y = np.array([[d.mode == 6 for d in row] for row in dec_y])
            eff = self._effective_dcg(dec_y, bh, bw)
            nest_x, nest_y = self._pick_nest_origin(eff)
            nest = build_nest(cfg, eff, nest_x, nest_y)  # the decoder's nest
            search, cand = self._make_search(nest)
            dec_y, _ = self._decide_plane(y, search, cand, raw_frozen=raw_y)
            plane_decisions.append(dec_y)
            for plane in frame[1:]:
                d, _ = self._decide_plane(plane, search, cand)
                plane_decisions.append(d)
        else:
            nest = self.dec.nest
            search, cand = self._make_search(nest)
            for plane in frame:
                d, _ = self._decide_plane(plane, search, cand)
                plane_decisions.append(d)

        inter_bases = self._inter_residuals(
            ftype, frame, refs, mb_map, mv_map, ref_map, search, cand, nest)

        return self._serialize(ftype, display_id, mb_map, mv_map, ref_map,
                               plane_decisions, inter_bases,
                               nest_x=nest_x, nest_y=nest_y)

    def _inter_residuals(self, ftype, frame, refs, mb_map, mv_map, ref_map,
                         search, cand, nest):
        """AOT residual coding for inter MBs (FORMAT.md §7.4-§7.5).

        For every 4×4 block of a motion-compensated MB, reconstruct the
        decoder's exact prediction (closed loop: `refs` are decoded planes),
        then greedily fit up to `aot_bases` nest bases to the residual,
        keeping k bases only when SSE + λ·bits beats fewer. Returns
        per-plane dicts {(by, bx): [desc, ...]} ({} entries mean k = 0).
        """
        if mb_map is None or not (mb_map == 2).any():
            return None
        if search is None and cand is None:
            cand = _CandidateSet(nest, self.rng)
        cfg = self.cfg
        out = []
        for pi, plane in enumerate(frame):
            psy_w = self._psy_weights(plane)
            bh, bw = cfg.block_grids[pi]
            chroma_mb = pi > 0 and cfg.h_samp == 2
            shift_idx = 0 if chroma_mb else 1
            mv_shift = 1 if chroma_mb else 0
            blocks = _blockify(plane).astype(np.int32).reshape(bh, bw, 16)
            # reference planes as the DECODER selects them (refsel 0 = past /
            # ref_prev, 1 = ref_last, 2 = blend; P always predicts ref_last)
            r0 = (refs[0][pi] if ftype == "B" else refs[1][pi])
            r1 = refs[1][pi]
            # phase 1: the decoder's exact predictions for every inter block
            coords, preds = [], []
            for by in range(bh):
                my = by >> shift_idx
                for bx in range(bw):
                    mx = bx >> shift_idx
                    if mb_map[my, mx] != 2:
                        continue
                    rs = ref_map[(my, mx)]
                    mv = mv_map[(my, mx)]
                    y0, x0 = by * 4, bx * 4
                    if rs == 2:
                        mvf = (mv[0][0] >> mv_shift, mv[0][1] >> mv_shift)
                        mvb = (mv[1][0] >> mv_shift, mv[1][1] >> mv_shift)
                        pf = self._mc_block(r0, y0, x0, mvf, 4)
                        pb = self._mc_block(r1, y0, x0, mvb, 4)
                        pred = (pf + pb + 1) >> 1
                    else:
                        ref = r1 if (rs == 1 or ftype == "P") else r0
                        mvp = (mv[0] >> mv_shift, mv[1] >> mv_shift)
                        pred = self._mc_block(ref, y0, x0, mvp, 4)
                    coords.append((by, bx))
                    preds.append(pred.reshape(16))
            if not coords:
                out.append({})
                continue
            preds = np.stack(preds)                          # (B, 16)
            targets = np.stack([blocks[by, bx] for by, bx in coords])
            resid = targets - preds
            base_sse = ((np.clip(preds, 0, 255) - targets) ** 2).sum(1)

            # phase 2: matching-pursuit rounds, batched when the device
            # search is available (one tiled product per round, as in intra)
            nblk = len(coords)
            round_bases: list[list] = [[] for _ in range(nblk)]
            best_k = np.zeros(nblk, np.int32)
            best_cost = base_sse.astype(np.float64).copy()
            acc = np.zeros((nblk, 16), np.int32)
            for rnd in range(self.aot_bases):
                if search is not None:
                    d, terms, s = search.best(resid - (acc >> 4))
                    hits = [(None if int(s[i]) == 0 else
                             ((int(d[i][0]), int(d[i][1]), int(d[i][2]),
                               int(d[i][3]), int(d[i][4]), int(s[i])),
                              terms[i])) for i in range(nblk)]
                else:
                    hits = []
                    for i in range(nblk):
                        h = cand.best(resid[i] - (acc[i] >> 4))
                        hits.append(None if (h is None or h[0][5] == 0)
                                    else h)
                for i, hit in enumerate(hits):
                    if hit is None or len(round_bases[i]) < rnd:
                        continue  # this block stopped in an earlier round
                    b, term = hit
                    round_bases[i].append(b)
                    acc[i] += term  # UNSHIFTED terms; decoder shifts the sum
                    rec = np.clip(preds[i] + (acc[i] >> 4), 0, 255)
                    sse = int(((rec - targets[i]) ** 2).sum())
                    by, bx = coords[i]
                    lam = self.lam if psy_w is None else \
                        self.lam * float(psy_w[by, bx])
                    cost = sse + lam * (3 + 34 * len(round_bases[i]))
                    if cost < best_cost[i]:
                        best_cost[i] = cost
                        best_k[i] = len(round_bases[i])
            dec_p = {coords[i]: round_bases[i][:int(best_k[i])]
                     for i in range(nblk) if best_k[i] > 0}
            out.append(dec_p)
        return out

    # -- serialization (FORMAT.md §3-§7; §9 sliced layout when slices >= 2) ----

    @staticmethod
    def _encode_basisnum(bn_syms: list[int]) -> bytes:
        """Run-length code the basisnum zero runs, then Huffman."""
        hw = HuffWriter()
        i = 0
        while i < len(bn_syms):
            if bn_syms[i] == 0:
                j = i
                while j < len(bn_syms) and bn_syms[j] == 0 and j - i < 256:
                    j += 1
                if j - i >= 3:
                    hw.put_symbol(7)
                    hw.put_raw(j - i - 1, 8)
                else:
                    for _ in range(j - i):
                        hw.put_symbol(0)
                i = j
            else:
                hw.put_symbol(bn_syms[i])
                i += 1
        return hw.encode()

    def _serialize(self, ftype, display_id, mb_map, mv_map, ref_map,
                   plane_decisions, inter_bases=None,
                   nest_x: int = 0, nest_y: int = 0) -> bytes:
        cfg = self.cfg
        S = self.slices
        mh, mw = cfg.mb_grid

        def put_delta(hw, v):
            if -127 <= v <= 127:
                hw.put_symbol(v + 127)
            else:
                hw.put_symbol(255)
                hw.put_raw(v & 0xFFFF, 16)

        # effective-DC grids persist across slices (values are per block),
        # but the *prediction chain* resets at each slice (FORMAT.md §9):
        # left, else up-within-slice, else 128
        eff_dc = [np.full((bh, bw), 128, np.int32)
                  for bh, bw in cfg.block_grids]
        segs: list[list[bytes]] = []  # segs[slice][stream]
        for s in range(S):
            ms0, ms1 = s * mh // S, (s + 1) * mh // S
            bn_syms: list[int] = []
            dch = HuffWriter()
            aux = BitWriter()
            mbt = BitWriter()
            mvh = HuffWriter()

            if mb_map is not None:
                pred = [0, 0]  # MV chain resets at slice start
                for my in range(ms0, ms1):
                    for mx in range(mw):
                        t = int(mb_map[my, mx])
                        mbt.write_bits(t, 2)
                        if t == 2:
                            rs = ref_map[(my, mx)]
                            if ftype == "B":
                                mbt.write_bits(rs, 2)
                            mv = mv_map[(my, mx)]
                            vecs = [mv] if rs != 2 else [mv[0], mv[1]]
                            for v in vecs:
                                put_delta(mvh, v[0] - pred[0])
                                put_delta(mvh, v[1] - pred[1])
                                pred = [v[0], v[1]]

            for pi, (bh, bw) in enumerate(cfg.block_grids):
                chroma = pi > 0
                shift = 0 if (chroma and cfg.h_samp == 2) else 1
                rpm = 1 if (chroma and cfg.h_samp == 2) else 2
                row0, row1 = ms0 * rpm, ms1 * rpm
                decisions = plane_decisions[pi]
                ed = eff_dc[pi]
                for by in range(row0, row1):
                    for bx in range(bw):
                        if mb_map is not None:
                            t = mb_map[by >> shift, bx >> shift]
                            if t == 0:
                                continue
                            if t == 2:  # MC block: k residual bases (maybe 0)
                                bases = (inter_bases[pi].get((by, bx), ())
                                         if inter_bases is not None else ())
                                bn_syms.append(len(bases))
                                for (nx, ny, sxb, syb, off, scale) in bases:
                                    v = ((nx << 25) | (ny << 18) | (sxb << 17)
                                         | (syb << 16) | (off << 8)
                                         | (scale & 0xFF))
                                    aux.write_bits(v, 32)
                                continue
                        d = decisions[by][bx]
                        bn_syms.append(d.mode)
                        if d.mode == 6:
                            for v in d.raw:
                                aux.write_bits(int(v), 8)
                            continue
                        pred_dc = (int(ed[by, bx - 1]) if bx > 0
                                   else int(ed[by - 1, bx]) if by > row0
                                   else 128)
                        delta = (d.dc_target - pred_dc) % 256
                        if delta > 127:
                            delta -= 256  # shortest signed representative
                        sh = self.dc_shift
                        v = int(round(delta / (1 << sh))) if sh else delta
                        put_delta(dch, v)
                        # track the DECODER's dc: quantized by the shift
                        ed[by, bx] = (pred_dc + (v << sh)) & 0xFF
                        for (nx, ny, sxb, syb, off, scale) in d.bases:
                            v = (nx << 25) | (ny << 18) | (sxb << 17) \
                                | (syb << 16) | (off << 8) | (scale & 0xFF)
                            aux.write_bits(v, 32)

            segs.append([self._encode_basisnum(bn_syms), dch.encode(),
                         aux.getvalue(), mbt.getvalue(), mvh.encode(), b""])

        streams = [b"".join(segs[s][k] for s in range(S))
                   for k in range(N_STREAMS)]
        head = struct.pack(">IHHBBH", display_id, nest_x, nest_y,
                           self.dc_shift, S if S >= 2 else 0, 0)
        head += struct.pack(f">{N_STREAMS}I", *[len(st) for st in streams])
        if S >= 2:
            head += b"".join(
                struct.pack(f">{S}I", *[len(segs[s][k]) for s in range(S)])
                for k in range(N_STREAMS))
        return head + b"".join(streams)

    # -- top level ------------------------------------------------------------

    def encode(self, frames: list, gops: list[str],
               usec_per_frame: int = 33366,
               audio: np.ndarray | None = None,
               audio_rate: int = 32000,
               target_bytes: int | None = None,
               rc_strength: float = 0.7,
               rc_lam_bounds: tuple = (0.25, 64.0)) -> bytes:
        """frames: display-ordered [ [Y,U,V] u8 planes ]; gops: display-order
        patterns whose lengths sum to len(frames). `audio` is optional
        (n_samples, channels) i16 PCM encoded as IMA-ADPCM, one record per
        GOP block covering that block's display duration. Returns a `.h4m`
        file.

        With `target_bytes`, SINGLE-PASS per-GOP adaptive rate control:
        after each GOP block, lambda is scaled by (spent/budget)^rc_strength
        against the proportional running budget — the classic closed-loop
        buffer model, converging on multi-GOP clips without the re-encode
        passes `encode_to_size` spends (use that for exact targets on short
        clips). Mutates self.lam."""
        from .audio import encode_record
        from .gop import reorder_display_to_decode

        cfg = self.cfg
        if sum(len(g) for g in gops) != len(frames):
            raise ValueError("gop pattern length != frame count")
        if audio is not None and audio.ndim != 2:
            raise ValueError("audio must be (n_samples, channels) i16")
        blocks = []
        disp_base = 0
        n_video = n_audio = 0
        max_frame = max_audio = 0
        audio_pos = 0
        total_frames = len(frames)
        spent = 0
        for gi, gop in enumerate(gops):
            self.dec.reset()
            recs = []
            if audio is not None:
                # this block's share of samples = its display duration
                end = (min(round((disp_base + len(gop)) * usec_per_frame
                                 * 1e-6 * audio_rate), len(audio))
                       if gi < len(gops) - 1 else len(audio))
                chunk = audio[audio_pos:end]
                audio_pos = end
                if len(chunk):
                    payload = encode_record(np.ascontiguousarray(chunk))
                    recs.append((MEDIA_AUDIO, 0, payload))
                    max_audio = max(max_audio, len(payload))
                    n_audio += 1
            for ftype, disp in reorder_display_to_decode(gop):
                frame = frames[disp_base + disp]
                refs = (self.dec.ref_prev, self.dec.ref_last)
                payload = self._encode_frame(ftype, disp_base + disp,
                                             frame, refs)
                # closed loop: adopt the decoder's own reconstruction
                plan = self.planner.plan_frame(ftype, payload)
                self.dec.decode(plan)
                subtype = {"I": FRAME_I, "P": FRAME_P, "B": FRAME_B}[ftype]
                recs.append((MEDIA_VIDEO, subtype, payload))
                max_frame = max(max_frame, len(payload))
                n_video += 1
            disp_base += len(gop)
            body = b"".join(struct.pack(">HHI", m, s, len(p)) + p
                            for m, s, p in recs)
            na = sum(1 for m, _s, _p in recs if m == MEDIA_AUDIO)
            blocks.append(struct.pack(">IHH", len(body), na,
                                      len(recs) - na) + body)
            if target_bytes is not None:
                spent += len(blocks[-1])
                budget = target_bytes * disp_base / total_frames
                ratio = spent / max(budget, 1.0)
                lo, hi = rc_lam_bounds
                self.lam = float(np.clip(self.lam * ratio ** rc_strength,
                                         lo, hi))

        channels = audio.shape[1] if audio is not None else 0
        body = b"".join(blocks)
        header = struct.pack(
            ">16sIIIIIIIIIHHBBBBBBHI",
            cfg.magic, HEADER_SIZE, len(body), len(blocks), n_video, n_audio,
            usec_per_frame, max_frame, 0, max_audio,
            cfg.width, cfg.height, cfg.h_samp, cfg.v_samp, 0, 0,
            channels, 4 if channels else 0, 0,
            audio_rate if channels else 0)
        return header + body


def encode_to_size(cfg: SeqConfig, frames: list, gops: list[str],
                   target_bytes: int, tolerance: float = 0.05,
                   iters: int = 6, lam_lo: float = 0.25,
                   lam_hi: float = 64.0, usec_per_frame: int = 33366,
                   **enc_kwargs):
    """Rate control: encode to a target clip size by bisecting lambda.

    Clip size is monotone decreasing in lambda (tools/rd_sweep.py), so a
    log-scale bisection converges in a handful of re-encodes — the classic
    two-pass structure (probe passes establish the rate curve, the final
    pass emits the clip). Returns (clip_bytes, lambda_used). If the target
    lies outside [size(lam_hi), size(lam_lo)], the closest endpoint is
    returned (the encoder cannot spend bits it has no tools for, nor go
    below the format's fixed per-block floor).
    """
    import math

    if iters < 1:
        raise ValueError("iters must be >= 1")

    def enc_at(lam: float) -> bytes:
        return VideoEncoder(cfg, lambda_bits=lam, **enc_kwargs).encode(
            frames, gops, usec_per_frame=usec_per_frame)

    lo, hi = math.log(lam_lo), math.log(lam_hi)
    best = None

    def consider(lam: float):
        nonlocal best
        clip = enc_at(lam)
        if best is None or (abs(len(clip) - target_bytes)
                            < abs(len(best[0]) - target_bytes)):
            best = (clip, lam)
        return clip

    for _ in range(iters):
        lam = math.exp((lo + hi) / 2)
        clip = consider(lam)
        if abs(len(clip) - target_bytes) <= tolerance * target_bytes:
            return clip, lam
        if len(clip) > target_bytes:
            lo = math.log(lam)   # too big → raise lambda
        else:
            hi = math.log(lam)
    # out of iterations: the target may lie outside the bisected interior,
    # so evaluate the endpoint the search was converging toward
    consider(lam_hi if len(best[0]) > target_bytes else lam_lo)
    return best
