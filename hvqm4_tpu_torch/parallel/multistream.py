"""Multi-stream decode: N independent `.h4m` streams stepped in lock-step.

The port of `hvqm4_tpu/parallel/multistream.py`'s per-field step
(`_step_body` and `multi_frame_step`, one function here). Every kernel works on (N, …) tensors;
the decode state (nest, ref_prev, ref_last) lives on the device as stacked
tensors that the step updates in place, where the JAX step donated them:

    (plans, nest, ref_prev, ref_last) → (frames, nest', ref_prev', ref_last')

Streams advance by decode index; per-stream frame types may differ. I
frames are all-intra plans whose nest slot is refreshed (`is_i`); the
reference rotation is masked per stream (`is_ref`).

`plan_steps` and `decode_lockstep` are the host side around the step: plan
each stream's next frame and stack the N plans with `convert.stack_plans`.
The JAX package's arena path (packed staging buffers, per-MB vector pools,
fused K-step dispatch) is not ported yet.
"""

from __future__ import annotations

from typing import Iterator

import torch

from ..config import MEDIA_VIDEO, SeqConfig
from ..container import Demuxer
from ..convert import stack_plans
from ..native import NativePlanner
from ..ops import device_core


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


def plan_steps(cfg: SeqConfig, clips: list[bytes],
               planner_factory=None) -> Iterator[list]:
    """Host side of lock-step decode: for each step, every stream's next
    planned frame in decode order, or None once a stream has ended."""
    demuxers = [Demuxer(c) for c in clips]
    for d in demuxers:
        if d.info.cfg != cfg:
            raise ValueError("clip parameters do not match the step config")
    planners = [(planner_factory or NativePlanner)(cfg) for _ in clips]
    records = [(r for r in d.records() if r.media_type == MEDIA_VIDEO)
               for d in demuxers]
    while True:
        recs = [next(it, None) for it in records]
        if all(r is None for r in recs):
            return
        yield [None if r is None else pl.plan_frame(r.frame_char, r.payload)
               for pl, r in zip(planners, recs)]


def decode_lockstep(cfg: SeqConfig, clips: list[bytes], device,
                    planner_factory=None) -> Iterator[tuple]:
    """Decode N clips in lock-step on `device`. Yields, per step,
    (frames [3 x (N, H, W) u8], valid [N] bool): valid[j] is False once
    stream j has ended."""
    nest, ref_prev, ref_last = init_state(cfg, len(clips), device)
    for plans in plan_steps(cfg, clips, planner_factory):
        plane_plans, new_nest, is_i, is_ref = stack_plans(cfg, plans, device)
        frames, *_ = multi_frame_step(plane_plans, nest, new_nest, is_i,
                                      is_ref, ref_prev, ref_last)
        yield frames, [p is not None for p in plans]
