"""`.h4m` container demux (reference layer L1, SURVEY.md §2.1): the port's
copy of `hvqm4_tpu/container.py`, held against it by
`tests/test_torch_host.py`.

Parses the 0x44-byte big-endian file header, walks GOP blocks and their
audio/video records, and yields them in decode order. GOP blocks are the
format's seek points (SURVEY.md §5 "Checkpoint / resume"): `block_offsets`
lets a session restart decode at any block with fresh reference state.

Validation philosophy (SURVEY.md §5 "Failure detection"): every size and
offset is bounds-checked here so downstream layers never index out of range;
corrupt files raise `ContainerError`, they never crash.
"""

from __future__ import annotations

import dataclasses
import struct

from .config import (
    FRAME_B, FRAME_I, FRAME_P, HEADER_SIZE, MAGIC_13, MAGIC_15,
    MEDIA_AUDIO, MEDIA_VIDEO, SeqConfig,
)


class ContainerError(ValueError):
    """Raised for any malformed container structure."""


@dataclasses.dataclass(frozen=True)
class FileInfo:
    cfg: SeqConfig
    body_size: int
    block_count: int
    video_frames: int
    audio_frames: int
    usec_per_frame: int
    max_frame_size: int
    max_audio_record_size: int
    audio_channels: int
    audio_bitdepth: int
    audio_sample_rate: int


@dataclasses.dataclass(frozen=True)
class Record:
    media_type: int   # MEDIA_AUDIO | MEDIA_VIDEO
    subtype: int      # FRAME_I/P/B or 0 for audio
    payload: bytes
    block_index: int

    @property
    def frame_char(self) -> str:
        ch = {FRAME_I: "I", FRAME_P: "P", FRAME_B: "B"}.get(self.subtype)
        if ch is None:
            raise ContainerError(
                f"frame_char on non-video record (subtype {self.subtype})")
        return ch


_HDR = struct.Struct(">16sIIIIIIIIIHHBBBBBBHI")


def parse_header(data: bytes) -> FileInfo:
    if len(data) < HEADER_SIZE:
        raise ContainerError("file shorter than header")
    (magic, header_size, body_size, block_count, video_frames, audio_frames,
     usec_per_frame, max_frame_size, _res0, max_audio, width, height,
     h_samp, v_samp, _vflags, _res1, audio_ch, audio_bits, _res2,
     audio_rate) = _HDR.unpack_from(data, 0)
    magic = magic.rstrip(b"\0")
    if magic == MAGIC_13:
        version = "1.3"
    elif magic == MAGIC_15:
        version = "1.5"
    else:
        raise ContainerError(f"bad magic {magic!r}")
    if header_size != HEADER_SIZE:
        raise ContainerError(f"bad header_size {header_size:#x}")
    if body_size != len(data) - HEADER_SIZE:
        raise ContainerError("body_size does not match file size")
    try:
        cfg = SeqConfig(width=width, height=height, h_samp=h_samp,
                        v_samp=v_samp, version=version)
    except ValueError as e:
        raise ContainerError(str(e)) from None
    return FileInfo(
        cfg=cfg, body_size=body_size, block_count=block_count,
        video_frames=video_frames, audio_frames=audio_frames,
        usec_per_frame=usec_per_frame, max_frame_size=max_frame_size,
        max_audio_record_size=max_audio, audio_channels=audio_ch,
        audio_bitdepth=audio_bits, audio_sample_rate=audio_rate,
    )


class Demuxer:
    """Random-access demuxer over an in-memory `.h4m` file."""

    def __init__(self, data: bytes):
        self.data = data
        self.info = parse_header(data)
        self.block_offsets: list[int] = []
        self._index_blocks()

    def _index_blocks(self) -> None:
        off = HEADER_SIZE
        n = len(self.data)
        for _ in range(self.info.block_count):
            if off + 8 > n:
                raise ContainerError("truncated block header")
            (size,) = struct.unpack_from(">I", self.data, off)
            if off + 8 + size > n:
                raise ContainerError("block overruns file")
            self.block_offsets.append(off)
            off += 8 + size
        if off != n:
            raise ContainerError("trailing bytes after last block")

    def block_records(self, block_index: int):
        """Yield `Record`s of one block: audio records first, then video."""
        off = self.block_offsets[block_index]
        size, n_audio, n_video = struct.unpack_from(">IHH", self.data, off)
        end = off + 8 + size
        off += 8
        for i in range(n_audio + n_video):
            if off + 8 > end:
                raise ContainerError("truncated record header")
            mtype, subtype, psize = struct.unpack_from(">HHI", self.data, off)
            off += 8
            if off + psize > end:
                raise ContainerError("record overruns block")
            expected_media = MEDIA_AUDIO if i < n_audio else MEDIA_VIDEO
            if mtype != expected_media:
                raise ContainerError("record media type out of order")
            if mtype == MEDIA_VIDEO and subtype not in (FRAME_I, FRAME_P, FRAME_B):
                raise ContainerError(f"bad video subtype {subtype:#x}")
            yield Record(mtype, subtype, self.data[off:off + psize], block_index)
            off += psize
        if off != end:
            raise ContainerError("trailing bytes in block")

    def block_video_counts(self) -> list[int]:
        """Video frames per block, read from the block headers alone."""
        return [struct.unpack_from(">IHH", self.data, off)[2]
                for off in self.block_offsets]

    def block_for_time(self, seconds: float) -> int:
        """Index of the GOP block whose display span contains `seconds`.

        Frames are displayed every `usec_per_frame` and each block's frames
        are display-contiguous (a GOP), so the mapping is a cumulative-count
        walk over the block headers. Clamped to the last block; negative
        times are rejected.
        """
        if seconds < 0:
            raise ContainerError("seek time must be non-negative")
        if not self.info.usec_per_frame:
            raise ContainerError("clip has no frame period")
        target = int(seconds * 1_000_000) // self.info.usec_per_frame
        seen = 0
        for b, count in enumerate(self.block_video_counts()):
            seen += count
            if target < seen:
                return b
        return len(self.block_offsets) - 1

    def records(self):
        """All records of the file in decode order."""
        for b in range(len(self.block_offsets)):
            yield from self.block_records(b)

    def video_records(self):
        for r in self.records():
            if r.media_type == MEDIA_VIDEO:
                yield r

    def audio_records(self):
        for r in self.records():
            if r.media_type == MEDIA_AUDIO:
                yield r
