"""Typed configuration for a decode session: the port's copy of
`hvqm4_tpu/config.py`.

The reference carries sequence parameters in its file header and `SeqObj`
(SURVEY.md §2.1 `HVQM4InitSeqObj`); here they are an immutable dataclass that
also derives every static shape the device pipeline needs (plane shapes,
block and macroblock grids, the nest). `tests/test_torch_host.py` holds the
copy against the original.
"""

from __future__ import annotations

import dataclasses

HEADER_SIZE = 0x44
MAGIC_13 = b"HVQM4 1.3"
MAGIC_15 = b"HVQM4 1.5"

# Video record subtypes (docs/FORMAT.md §2).
FRAME_I = 0x10
FRAME_P = 0x20
FRAME_B = 0x30

MEDIA_AUDIO = 0
MEDIA_VIDEO = 1

N_STREAMS = 6  # substreams of a frame payload (docs/FORMAT.md §3)

MAX_BASES = 4


@dataclasses.dataclass(frozen=True)
class SeqConfig:
    """Static sequence parameters; the reference's `SeqObj`."""

    width: int
    height: int
    h_samp: int = 2
    v_samp: int = 2
    version: str = "1.3"

    def __post_init__(self) -> None:
        if self.width % 8 or self.height % 8:
            raise ValueError("width/height must be multiples of 8")
        if (self.h_samp, self.v_samp) not in ((2, 2), (1, 1)):
            raise ValueError("supported sampling: (2,2) 4:2:0 or (1,1) 4:4:4")
        if self.version not in ("1.3", "1.5"):
            raise ValueError("version must be '1.3' or '1.5'")

    # ---- derived static shapes ------------------------------------------------

    @property
    def plane_shapes(self) -> tuple[tuple[int, int], ...]:
        """(height, width) for planes Y, U, V."""
        ch = self.height // self.v_samp
        cw = self.width // self.h_samp
        return ((self.height, self.width), (ch, cw), (ch, cw))

    @property
    def block_grids(self) -> tuple[tuple[int, int], ...]:
        """4x4-block grid (bh, bw) per plane."""
        return tuple((h // 4, w // 4) for h, w in self.plane_shapes)

    @property
    def mb_grid(self) -> tuple[int, int]:
        """8x8 macroblock grid over luma: (mh, mw)."""
        return (self.height // 8, self.width // 8)

    @property
    def nest_shape(self) -> tuple[int, int]:
        """(nest_h, nest_w): 38x70 landscape, 70x38 portrait (FORMAT.md §6.1)."""
        return (38, 70) if self.width >= self.height else (70, 38)

    @property
    def frame_bytes(self) -> int:
        """Bytes of one planar YUV frame."""
        return sum(h * w for h, w in self.plane_shapes)

    @property
    def magic(self) -> bytes:
        return (MAGIC_13 if self.version == "1.3" else MAGIC_15).ljust(16, b"\0")
