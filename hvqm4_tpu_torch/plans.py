"""Plan tensor schema — the host→device interface (SURVEY.md §7 "Plan tensor
design"): the port's copy of `hvqm4_tpu/plans.py`, held against it by
`tests/test_torch_host.py`.

The host planner resolves every serial dependency (Huffman, DC prediction
chains, MV prediction chains, MB-type spreading — reference layers L4/L5) and
emits *dense, fixed-shape* per-plane tensors. The device core is then a pure
batched function of (plan, reference frames): no data-dependent shapes.

Conventions (docs/FORMAT.md):
- `cls`:  0 = intra, 1 = inter.  Copy/skip MBs are lowered to inter with
  mv = (0,0) and zero residual bases (bit-identical per FORMAT.md §7.6 vs §7.4
  with clamped addressing at mv 0 — integer copy phase).
- `mode`: intra → 0 weight | 1..4 AOT-k | 6 raw;  inter → residual count 0..4.
- `dc`:   the *effective* DC grid (prediction fully resolved; raw/inter = 128).
- `refsel`: 0 = ref0 (past / ref_prev), 1 = ref1 (last / ref_last), 2 = bidir.
  P frames use ref1; B copy uses ref0.
- `mv` is per-block, already at plane resolution (chroma shift applied);
  `mv2` is the backward vector of bidirectional blocks (else 0).
- `basis_*[..., MAX_BASES]` padded with zeros beyond `mode`'s basis count.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import MAX_BASES, SeqConfig

CLS_INTRA = 0  # `cls` of an intra block
REF_LAST = 1   # `refsel` of a block predicted from ref_last


@dataclasses.dataclass
class PlanePlan:
    """Dense per-4x4-block tensors for one plane (grid bh x bw)."""

    cls: np.ndarray        # u8 [bh, bw]
    mode: np.ndarray       # u8 [bh, bw]
    dc: np.ndarray         # u8 [bh, bw] effective DC grid
    raw: np.ndarray        # u8 [bh, bw, 16]
    basis_nx: np.ndarray   # u8 [bh, bw, MAX_BASES]
    basis_ny: np.ndarray   # u8 [bh, bw, MAX_BASES]
    basis_sx: np.ndarray   # u8 [bh, bw, MAX_BASES]  stride 1 or 2 (0 when unused)
    basis_sy: np.ndarray   # u8 [bh, bw, MAX_BASES]
    basis_off: np.ndarray  # i16 [bh, bw, MAX_BASES]
    basis_scale: np.ndarray  # i16 [bh, bw, MAX_BASES] (signed, -128..127)
    mv: np.ndarray         # i16 [bh, bw, 2] (x, y) half-pel plane units
    mv2: np.ndarray        # i16 [bh, bw, 2] backward MV for bidir blocks
    refsel: np.ndarray     # u8 [bh, bw]

    @classmethod
    def zeros(cls, bh: int, bw: int) -> "PlanePlan":
        return cls(
            cls=np.zeros((bh, bw), np.uint8),
            mode=np.zeros((bh, bw), np.uint8),
            dc=np.full((bh, bw), 128, np.uint8),
            raw=np.zeros((bh, bw, 16), np.uint8),
            basis_nx=np.zeros((bh, bw, MAX_BASES), np.uint8),
            basis_ny=np.zeros((bh, bw, MAX_BASES), np.uint8),
            basis_sx=np.zeros((bh, bw, MAX_BASES), np.uint8),
            basis_sy=np.zeros((bh, bw, MAX_BASES), np.uint8),
            basis_off=np.zeros((bh, bw, MAX_BASES), np.int16),
            basis_scale=np.zeros((bh, bw, MAX_BASES), np.int16),
            mv=np.zeros((bh, bw, 2), np.int16),
            mv2=np.zeros((bh, bw, 2), np.int16),
            refsel=np.zeros((bh, bw), np.uint8),
        )

    def __eq__(self, other: object) -> bool:  # exact tensor equality
        if not isinstance(other, PlanePlan):
            return NotImplemented
        return all(
            np.array_equal(getattr(self, f.name), getattr(other, f.name))
            for f in dataclasses.fields(self)
        )


@dataclasses.dataclass
class FramePlan:
    """One frame's fully resolved decode plan."""

    ftype: str                 # 'I' | 'P' | 'B'
    display_id: int
    dc_shift: int
    nest_x: int
    nest_y: int
    planes: list               # [PlanePlan] for Y, U, V
    nest: np.ndarray | None    # u8 [nest_h, nest_w]; set for I frames (from own
                               # luma DC grid, FORMAT.md §6.1), None for P/B

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, FramePlan):
            return NotImplemented
        if (self.ftype, self.display_id, self.dc_shift, self.nest_x, self.nest_y) != (
            other.ftype, other.display_id, other.dc_shift, other.nest_x, other.nest_y
        ):
            return False
        if (self.nest is None) != (other.nest is None):
            return False
        if self.nest is not None and not np.array_equal(self.nest, other.nest):
            return False
        return self.planes == other.planes


def build_nest(cfg: SeqConfig, dcg_y: np.ndarray, nest_x: int, nest_y: int) -> np.ndarray:
    """Nest from the luma effective-DC grid (FORMAT.md §6.1), modular wrap."""
    nh, nw = cfg.nest_shape
    bh, bw = dcg_y.shape
    ys = (nest_y + np.arange(nh)) % bh
    xs = (nest_x + np.arange(nw)) % bw
    return dcg_y[np.ix_(ys, xs)].astype(np.uint8)
