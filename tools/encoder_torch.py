"""Synthetic `.h4m` clip generator of the PyTorch port (SURVEY.md §4.2).

The counterpart of `tools/encoder.py`, on the port's own host modules: it
imports `hvqm4_tpu_torch` and numpy, never `jax`, the JAX package or
`tools/encoder.py`, and for the same arguments it writes the same bytes.

Conformance streams are generated here: the generator emits valid
bitstreams per docs/FORMAT.md exercising every decode path
deterministically (seeded). It optimizes nothing — Huffman trees are built
from actual symbol stats, choices are random — because its only job is
coverage: every block mode, run escapes, DC/MV escapes, all half-pel phases,
B refsel variants, portrait/landscape nests, 4:2:0 and 4:4:4, audio records.

Expected output is *defined* by decode: planner+refdec (and the C oracle)
agree on these streams; the generator itself never computes pixels.

    python tools/encoder_torch.py OUT.h4m [--width W --height H]
        [--sampling 420|444] [--gops IPBPB,IPPP] [--seed S] [--dc-shift D]
        [--audio-channels C] [--slices N] [--version 1.3|1.5]
"""

from __future__ import annotations

import argparse
import struct
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from hvqm4_tpu_torch.audio import encode_record  # noqa: E402
from hvqm4_tpu_torch.bitio import BitWriter, HuffWriter  # noqa: E402
from hvqm4_tpu_torch.config import (  # noqa: E402
    FRAME_B, FRAME_I, FRAME_P, HEADER_SIZE, MEDIA_AUDIO, MEDIA_VIDEO,
    N_STREAMS, SeqConfig,
)
from hvqm4_tpu_torch.gop import reorder_display_to_decode  # noqa: E402

MB_COPY, MB_INTRA, MB_INTER = 0, 1, 2


class _SliceWriters:
    """One slice's independent stream writers (FORMAT.md §9)."""

    def __init__(self):
        self.bn_syms: list[int] = []          # basisnum, pre run-coding
        self.dc = HuffWriter()
        self.aux = BitWriter()
        self.mbt = BitWriter()
        self.mv = HuffWriter()


class FrameEncoder:
    """Encodes one video frame payload from random-but-valid choices.

    `slices` >= 2 emits the sliced layout of FORMAT.md §9 (per-slice
    segments with independent trees and prediction chains); 1 emits the
    classic layout — both go through the same slice loop, since a single
    slice's decode order equals the unsliced order.
    """

    def __init__(self, cfg: SeqConfig, rng: np.random.Generator,
                 dc_shift: int, slices: int = 1, mv_extreme: bool = False):
        self.cfg = cfg
        self.rng = rng
        self.dc_shift = dc_shift
        mh, _mw = cfg.mb_grid
        if not (1 <= slices <= mh):
            raise ValueError(f"slice count must be in [1, {mh}]")
        self.slices = slices
        self.mv_extreme = mv_extreme   # drive the s16 chain-wrap edge
        self.sw: _SliceWriters | None = None   # current slice's writers

    # -- stream helpers -------------------------------------------------------

    def _put_delta(self, hw: HuffWriter, v: int) -> None:
        """Delta as symbol or escape (FORMAT.md §5.4); sometimes force escape."""
        if -127 <= v <= 127 and self.rng.random() > 0.05:
            hw.put_symbol(v + 127)
        else:
            hw.put_symbol(255)
            hw.put_raw(v & 0xFFFF, 16)

    def _put_basis(self) -> None:
        v = (int(self.rng.integers(0, 128)) << 25
             | int(self.rng.integers(0, 128)) << 18
             | int(self.rng.integers(0, 2)) << 17
             | int(self.rng.integers(0, 2)) << 16
             | int(self.rng.integers(0, 256)) << 8
             | int(self.rng.integers(0, 256)))
        self.sw.aux.write_bits(v, 32)

    def _intra_block(self) -> None:
        mode = int(self.rng.choice([0, 0, 0, 1, 2, 3, 4, 6],
                                   p=[.3, .2, .1, .1, .1, .08, .07, .05]))
        self.sw.bn_syms.append(mode)
        if mode == 6:
            for _ in range(16):
                self.sw.aux.write_bits(int(self.rng.integers(0, 256)), 8)
            return
        v = int(self.rng.integers(-140, 141))  # occasionally escapes
        self._put_delta(self.sw.dc, v)
        for _ in range(mode):
            self._put_basis()

    # -- frame ----------------------------------------------------------------

    def encode(self, ftype: str, display_id: int) -> bytes:
        cfg = self.cfg
        S = self.slices
        mh, _mw = cfg.mb_grid
        nest_x = nest_y = 0
        if ftype == "I":
            bh, bw = cfg.block_grids[0]
            nest_x = int(self.rng.integers(0, 2 * bw))   # tests modular wrap
            nest_y = int(self.rng.integers(0, 2 * bh))

        mb_map = (np.zeros(cfg.mb_grid, np.uint8)
                  if ftype in ("P", "B") else None)
        slice_writers = []
        for s in range(S):
            self.sw = sw = _SliceWriters()
            ms0, ms1 = s * mh // S, (s + 1) * mh // S  # [ms0, ms1)
            if mb_map is not None:
                self._mb_rows(ftype, mb_map, ms0, ms1)
            for pi, (bh, bw) in enumerate(cfg.block_grids):
                chroma = pi > 0
                shift = 0 if (chroma and cfg.h_samp == 2) else 1
                rows_per_mb = 1 if (chroma and cfg.h_samp == 2) else 2
                for by in range(ms0 * rows_per_mb, ms1 * rows_per_mb):
                    for bx in range(bw):
                        if ftype == "I":
                            self._intra_block()
                            continue
                        t = mb_map[by >> shift, bx >> shift]
                        if t == MB_INTRA:
                            self._intra_block()
                        elif t == MB_INTER:
                            k = int(self.rng.choice([0, 0, 0, 1, 2, 3, 4]))
                            self.sw.bn_syms.append(k)
                            for _ in range(k):
                                self._put_basis()
                        # copy: nothing
            slice_writers.append(sw)

        segs = []  # segs[stream][slice] bytes
        for sw in slice_writers:
            sw_streams = [self._encode_basisnum(sw.bn_syms), sw.dc.encode(),
                          sw.aux.getvalue(), sw.mbt.getvalue(),
                          sw.mv.encode(), b""]
            segs.append(sw_streams)
        streams = [b"".join(segs[s][k] for s in range(S))
                   for k in range(N_STREAMS)]

        head = struct.pack(">IHHBBH", display_id, nest_x, nest_y,
                           self.dc_shift, S if S >= 2 else 0, 0)
        head += struct.pack(f">{N_STREAMS}I", *[len(st) for st in streams])
        if S >= 2:
            sub = b"".join(
                struct.pack(f">{S}I", *[len(segs[s][k]) for s in range(S)])
                for k in range(N_STREAMS))
            return head + sub + b"".join(streams)
        return head + b"".join(streams)

    def _mb_rows(self, ftype: str, mb_map: np.ndarray,
                 ms0: int, ms1: int) -> None:
        _mh, mw = self.cfg.mb_grid
        pred = [0, 0]  # MV chain resets at slice start (FORMAT.md §9)

        def wrap16(v: int) -> int:
            return ((v + 0x8000) & 0xFFFF) - 0x8000

        def put_mv() -> None:
            # bounded targets so cumulative deltas stay small; decoder clamps
            # out-of-bounds reads anyway (FORMAT.md §7.4). mv_extreme drives
            # huge targets through 16-bit escapes so the decoder's s16
            # prediction-chain wrap (§7.2) is exercised — the chain value
            # after applying a delta is wrap16(target)
            if self.mv_extreme and self.rng.random() < 0.5:
                tx = int(self.rng.integers(-40000, 40001))
                ty = int(self.rng.integers(-40000, 40001))
            else:
                tx = int(self.rng.integers(-24, 25))
                ty = int(self.rng.integers(-24, 25))
            self._put_delta(self.sw.mv, tx - pred[0])
            self._put_delta(self.sw.mv, ty - pred[1])
            pred[0], pred[1] = wrap16(tx), wrap16(ty)

        for my in range(ms0, ms1):
            for mx in range(mw):
                t = int(self.rng.choice([MB_COPY, MB_INTRA, MB_INTER],
                                        p=[.25, .25, .5]))
                mb_map[my, mx] = t
                self.sw.mbt.write_bits(t, 2)
                if t == MB_INTER:
                    if ftype == "B":
                        rs = int(self.rng.choice([0, 1, 2]))
                        self.sw.mbt.write_bits(rs, 2)
                    else:
                        rs = 1
                    put_mv()
                    if ftype == "B" and rs == 2:
                        put_mv()

    def _encode_basisnum(self, syms: list[int]) -> bytes:
        """Run-code zero runs (symbol 7 + 8-bit n ⇒ n+1 zeros), then Huffman."""
        hw = HuffWriter()
        i = 0
        while i < len(syms):
            if syms[i] == 0:
                j = i
                while j < len(syms) and syms[j] == 0 and j - i < 256:
                    j += 1
                run = j - i
                if run >= 3 and self.rng.random() < 0.8:
                    hw.put_symbol(7)
                    hw.put_raw(run - 1, 8)
                else:
                    for _ in range(run):
                        hw.put_symbol(0)
                i = j
            else:
                hw.put_symbol(syms[i])
                i += 1
        return hw.encode()


# ---------------------------------------------------------------------------
# Clip assembly
# ---------------------------------------------------------------------------

def make_clip(cfg: SeqConfig, gops: list[str], seed: int = 0,
              dc_shift: int | None = None, audio_channels: int = 0,
              audio_rate: int = 32000, audio_samples_per_record: int = 1024,
              usec_per_frame: int = 33366, slices: int = 1,
              mv_extreme: bool = False) -> bytes:
    """Build a complete `.h4m` file; `gops` are display-order patterns, each
    starting with 'I' (one GOP block per pattern)."""
    rng = np.random.default_rng(seed)
    blocks = []
    n_video = 0
    n_audio = 0
    max_frame = 0
    max_audio = 0
    display_base = 0
    for gop in gops:
        if not gop.startswith("I"):
            raise ValueError("every GOP must start with an I frame")
        recs = []
        if audio_channels:
            t = np.arange(audio_samples_per_record)[:, None]
            ch = np.arange(audio_channels)[None, :]
            wave = (6000 * np.sin(0.03 * t + ch)
                    + rng.integers(-300, 300, size=(audio_samples_per_record,
                                                    audio_channels)))
            payload = encode_record(wave.astype(np.int16))
            recs.append((MEDIA_AUDIO, 0, payload))
            max_audio = max(max_audio, len(payload))
            n_audio += 1
        for ftype, disp in reorder_display_to_decode(gop):
            shift = dc_shift if dc_shift is not None else int(rng.integers(0, 3))
            fe = FrameEncoder(cfg, rng, shift, slices=slices,
                              mv_extreme=mv_extreme)
            payload = fe.encode(ftype, display_base + disp)
            subtype = {"I": FRAME_I, "P": FRAME_P, "B": FRAME_B}[ftype]
            recs.append((MEDIA_VIDEO, subtype, payload))
            max_frame = max(max_frame, len(payload))
            n_video += 1
        display_base += len(gop)
        body = b"".join(struct.pack(">HHI", m, s, len(p)) + p for m, s, p in recs)
        na = sum(1 for m, _, _ in recs if m == MEDIA_AUDIO)
        nv = len(recs) - na
        blocks.append(struct.pack(">IHH", len(body), na, nv) + body)

    body = b"".join(blocks)
    header = struct.pack(
        ">16sIIIIIIIIIHHBBBBBBHI",
        cfg.magic, HEADER_SIZE, len(body), len(blocks), n_video, n_audio,
        usec_per_frame, max_frame, 0, max_audio,
        cfg.width, cfg.height, cfg.h_samp, cfg.v_samp, 0, 0,
        audio_channels, 4 if audio_channels else 0, 0,
        audio_rate if audio_channels else 0)
    return header + body


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Generate a synthetic .h4m clip (the port's generator)")
    ap.add_argument("output")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--sampling", choices=["420", "444"], default="420")
    ap.add_argument("--gops", default="IPBPB,IPPP",
                    help="comma-separated display-order GOP patterns")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dc-shift", type=int, default=None)
    ap.add_argument("--audio-channels", type=int, default=0)
    ap.add_argument("--slices", type=int, default=1,
                    help="entropy slices per frame (FORMAT.md §9)")
    ap.add_argument("--version", choices=["1.3", "1.5"], default="1.3")
    args = ap.parse_args()
    samp = 2 if args.sampling == "420" else 1
    cfg = SeqConfig(width=args.width, height=args.height, h_samp=samp,
                    v_samp=samp, version=args.version)
    data = make_clip(cfg, args.gops.split(","), seed=args.seed,
                     dc_shift=args.dc_shift, audio_channels=args.audio_channels,
                     slices=args.slices)
    Path(args.output).write_bytes(data)
    print(f"wrote {args.output}: {len(data)} bytes")


if __name__ == "__main__":
    main()
