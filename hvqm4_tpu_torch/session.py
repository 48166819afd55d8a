"""Decode session: the frame-at-a-time API over the PyTorch device core.

The port of `hvqm4_tpu/session.py`. A `DecoderSession` owns the decode
state on an explicit device (the nest, preallocated and overwritten in
place on every I frame, and the two reference frames) and decodes one
planned frame at a time:

  host: payload → planner (C++ `NativePlanner`) → FramePlan
  device: plan tensors → decode_plane_{intra,inter} → u8 planes

On a CUDA device the planes go through the hand-written kernels; on the CPU
through their plain PyTorch versions. The SDK-shaped shims at the bottom
mirror the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from .config import MEDIA_VIDEO, SeqConfig
from .container import Demuxer, Record
from .convert import frame_plan_to_torch
from .native import NativePlanner
from .ops import device_core
from .plans import FramePlan
from .utils.profiling import StageTimer


@dataclasses.dataclass
class DecodedFrame:
    display_id: int
    ftype: str
    planes: list  # [Y, U, V] (H, W) u8 tensors on the session's device

    def to_numpy(self) -> list:
        """[Y, U, V] as numpy arrays on the host."""
        return [p.cpu().numpy() for p in self.planes]

    def yuv_bytes(self) -> bytes:
        return b"".join(p.tobytes() for p in self.to_numpy())


class DecoderSession:
    """One decode session for one sequence configuration on one device."""

    def __init__(self, cfg: SeqConfig, device, planner=None,
                 profile: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        self.planner = planner if planner is not None else NativePlanner(cfg)
        self.timer = StageTimer(enabled=profile)
        self.nest = torch.zeros(cfg.nest_shape, dtype=torch.uint8,
                                device=self.device)
        self.reset()

    # -- state -----------------------------------------------------------------

    def reset(self) -> None:
        """Reset reference state — GOP block boundary / seek (FORMAT.md §2)."""
        self.ref_prev = None
        self.ref_last = None
        self.nest.zero_()

    # -- frame decode ----------------------------------------------------------

    def decode_plan(self, plan: FramePlan) -> DecodedFrame:
        if plan.ftype != "I" and self.ref_last is None:
            raise ValueError("P/B frame without reference")
        if plan.ftype == "B" and self.ref_prev is None:
            raise ValueError("B frame without two references")
        with self.timer.stage("upload"):
            plane_plans = frame_plan_to_torch(plan, self.device)
            if plan.ftype == "I":
                self.nest.copy_(torch.from_numpy(plan.nest))
        with self.timer.stage("device"):
            planes = []
            for pi, arrs in enumerate(plane_plans):
                if plan.ftype == "I":
                    planes.append(device_core.decode_plane_intra(arrs,
                                                                 self.nest))
                else:
                    r1 = self.ref_last[pi]
                    r0 = self.ref_prev[pi] if plan.ftype == "B" else r1
                    planes.append(device_core.decode_plane_inter(
                        arrs, self.nest, r0, r1))
        if plan.ftype in ("I", "P"):
            self.ref_prev = self.ref_last
            self.ref_last = planes
        return DecodedFrame(plan.display_id, plan.ftype, planes)

    # -- record / clip level ---------------------------------------------------

    def decode_record(self, rec: Record) -> DecodedFrame:
        if rec.media_type != MEDIA_VIDEO:
            raise ValueError("not a video record")
        with self.timer.stage("plan"):
            plan = self.planner.plan_frame(rec.frame_char, rec.payload)
        return self.decode_plan(plan)

    def decode_clip(self, data: bytes,
                    start_block: int = 0) -> Iterator[DecodedFrame]:
        """Decode a whole `.h4m` file (optionally seeking to a GOP block),
        yielding frames in decode order, as the C oracle writes them."""
        demux = Demuxer(data)
        if demux.info.cfg != self.cfg:
            raise ValueError("clip parameters do not match session config")
        for b in range(start_block, len(demux.block_offsets)):
            self.reset()  # each block is a seek point
            for rec in demux.block_records(b):
                if rec.media_type == MEDIA_VIDEO:
                    yield self.decode_record(rec)

    def decode_clip_display_order(self, data: bytes,
                                  start_block: int = 0) -> Iterator[DecodedFrame]:
        """Decode and yield frames in display order: a small pending map
        holds each anchor until the B frames shown before it have decoded."""
        pending: dict[int, DecodedFrame] = {}
        next_disp: int | None = None
        for frame in self.decode_clip(data, start_block=start_block):
            if next_disp is None:
                next_disp = frame.display_id  # seek: start at first decoded id
            pending[frame.display_id] = frame
            while next_disp in pending:
                yield pending.pop(next_disp)
                next_disp += 1
        for disp in sorted(pending):  # trailing anchors
            yield pending.pop(disp)


# ---------------------------------------------------------------------------
# SDK-shaped functional shims (API parity with hvqm4_tpu.session).
# ---------------------------------------------------------------------------

def HVQM4InitDecoder() -> None:
    """Global init; a no-op kept for API parity (the reference builds lookup
    tables here, which the kernels compute inline)."""


def HVQM4InitSeqObj(width: int, height: int, h_samp: int = 2,
                    v_samp: int = 2) -> SeqConfig:
    return SeqConfig(width=width, height=height, h_samp=h_samp, v_samp=v_samp)


def HVQM4BuffSize(seq: SeqConfig) -> int:
    """Workspace bytes the reference would require: 4 frame buffers (3 I/P
    ring + 1 B output) + nest. Informational: torch allocates itself."""
    nh, nw = seq.nest_shape
    return 4 * seq.frame_bytes + nh * nw


def HVQM4SetBuffer(seq: SeqConfig, device, _workspace=None,
                   **kwargs) -> DecoderSession:
    """Create the decode session on `device` (the reference carves caller
    memory here; the session allocates device state instead)."""
    return DecoderSession(seq, device, **kwargs)


def HVQM4DecodeIpic(session: DecoderSession, payload: bytes) -> DecodedFrame:
    return session.decode_plan(session.planner.plan_frame("I", payload))


def HVQM4DecodePpic(session: DecoderSession, payload: bytes) -> DecodedFrame:
    return session.decode_plan(session.planner.plan_frame("P", payload))


def HVQM4DecodeBpic(session: DecoderSession, payload: bytes) -> DecodedFrame:
    return session.decode_plan(session.planner.plan_frame("B", payload))
