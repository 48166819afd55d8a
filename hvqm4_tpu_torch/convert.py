"""Host plan arrays → device tensors: the port's "weights carried across".

The codec has no weights; its parameters are per-frame plans and the
reference state (nest, previous and last decoded frames). This module turns
the JAX package's plan contract (`hvqm4_tpu/ops/device_core.py`, module
docstring) into tensors on an explicit device:

    meta (…, bh, bw) u8          dc (…, bh, bw) u8
    desc (…, 4, bh, bw) i32      the wire u32 words, viewed as int32
    raw  (…, H, W) u8            mv, mv2 (…, 2, gh, gw) i16

A leading stream axis N is kept where the arrays have one.

The one model on the decode path, the ViT, does have weights:
`vit_params_to_torch` carries the JAX parameter pytree across, and
`probe_params_to_torch` the training example's ViT and head.

`pack_meta`, `pack_desc` and `plane_plan_arrays` are the port's copies of
the numpy helpers in `hvqm4_tpu/ops/device_core.py`; the tests hold the
plain device core that reads their output against the JAX one.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import SeqConfig
from .plans import FramePlan, PlanePlan

PLAN_KEYS = ("meta", "dc", "raw", "desc", "mv", "mv2")


# --- copied from hvqm4_tpu/ops/device_core.py (JAX-free numpy) -------------

def pack_meta(p: PlanePlan) -> np.ndarray:
    """PlanePlan → the packed per-block meta byte (mode | refsel | cls)."""
    return (p.mode | (p.refsel << 3) | (p.cls << 5)).astype(np.uint8)


def pack_desc(p: PlanePlan) -> np.ndarray:
    """PlanePlan → basis descriptors in wire u32 form, block-major
    (bh, bw, MAX_BASES) — the exact 32-bit layout of FORMAT.md §6.5."""
    return ((p.basis_nx.astype(np.uint32) << 25)
            | (p.basis_ny.astype(np.uint32) << 18)
            | ((np.maximum(p.basis_sx.astype(np.uint32), 1) - 1) << 17)
            | ((np.maximum(p.basis_sy.astype(np.uint32), 1) - 1) << 16)
            | ((p.basis_off.astype(np.int64) & 0xFF).astype(np.uint32) << 8)
            | (p.basis_scale.astype(np.int64) & 0xFF).astype(np.uint32))


def plane_plan_arrays(p: PlanePlan) -> dict[str, np.ndarray]:
    """PlanePlan → the dense per-plane plan arrays (host-side, numpy)."""
    bh, bw = p.mode.shape
    raw_plane = (p.raw.reshape(bh, bw, 4, 4).transpose(0, 2, 1, 3)
                 .reshape(bh * 4, bw * 4))
    return {
        "meta": pack_meta(p),
        "dc": p.dc,
        "raw": np.ascontiguousarray(raw_plane),
        "desc": np.ascontiguousarray(pack_desc(p).transpose(2, 0, 1)),
        "mv": np.ascontiguousarray(p.mv.transpose(2, 0, 1)),
        "mv2": np.ascontiguousarray(p.mv2.transpose(2, 0, 1)),
    }


# --- numpy → torch ---------------------------------------------------------

def _to(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def plan_to_torch(plan_np: dict[str, np.ndarray], device) -> dict:
    """One plane's plan arrays (with or without a leading stream axis) →
    tensors on `device`. The u32 descriptors travel as their int32 view:
    torch has no shifts on uint32, and the kernels read int32."""
    out = {}
    for k in PLAN_KEYS:
        a = np.asarray(plan_np[k])
        if k == "desc":
            a = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
        elif k in ("mv", "mv2"):
            a = a.astype(np.int16, copy=False)
        else:
            a = a.astype(np.uint8, copy=False)
        out[k] = _to(a, device)
    return out


def state_to_torch(nest: np.ndarray, ref_prev: list, ref_last: list,
                   device) -> tuple:
    """Decode state (nest u8, reference planes u8 ×3 each) → tensors that
    own their memory: the step updates state in place, which must never
    write through to the caller's arrays (on the CPU, `.to` would alias)."""
    def own(a):
        return torch.from_numpy(np.asarray(a, np.uint8)).to(device, copy=True)

    return own(nest), [own(r) for r in ref_prev], [own(r) for r in ref_last]


def frame_plan_to_torch(plan: FramePlan, device) -> list[dict]:
    """A planned frame → one tensor plan dict per plane (Y, U, V)."""
    return [plan_to_torch(plane_plan_arrays(p), device) for p in plan.planes]


def stack_plans(cfg: SeqConfig, plans: list, device) -> tuple:
    """One lock-step step of N streams: N planned frames (None for a stream
    that has ended) → (plane_plans, new_nest, is_i, is_ref), the per-field
    inputs of `parallel.multistream.multi_frame_step`.

    An ended stream decodes an all-zero plan that is neither an I frame nor
    a reference, so it leaves its state as it was."""
    planes = []
    for pi, (bh, bw) in enumerate(cfg.block_grids):
        arrs = [plane_plan_arrays(p.planes[pi] if p is not None
                                  else PlanePlan.zeros(bh, bw))
                for p in plans]
        planes.append(plan_to_torch(
            {k: np.stack([a[k] for a in arrs]) for k in PLAN_KEYS}, device))
    empty = np.zeros(cfg.nest_shape, np.uint8)
    new_nest = np.stack([p.nest if p is not None and p.ftype == "I"
                         else empty for p in plans])
    is_i = [p is not None and p.ftype == "I" for p in plans]
    is_ref = [p is not None and p.ftype in ("I", "P") for p in plans]
    return (planes, _to(new_nest, device),
            torch.tensor(is_i, device=device),
            torch.tensor(is_ref, device=device))


def _leaf_to_torch(a, device) -> torch.Tensor:
    """A numpy leaf → a tensor of the same dtype that owns its memory. bf16
    (numpy's extension dtype, as `np.asarray` of a JAX bf16 array gives)
    crosses as its 16-bit pattern."""
    a = np.array(a)  # a writable copy: JAX hands out read-only arrays
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def vit_params_to_torch(params_np: dict, device) -> dict:
    """The JAX ViT pytree (`hvqm4_tpu.models.vit.init_vit`, leaves as numpy
    f32 or bf16) → the state dict of `models.vit.ViT`, each leaf in the
    dtype it came in. `wq`, `wk`, `wv` (d, nh, hd) become (d, nh·hd) and
    `wo` (nh, hd, d) becomes (nh·hd, d)."""
    def flat(prefix: str, tree: dict) -> dict:
        out = {}
        for k, a in tree.items():
            if isinstance(a, dict):
                out.update(flat(f"{prefix}{k}.", a))
                continue
            a = np.asarray(a)
            if k in ("wq", "wk", "wv"):
                a = a.reshape(a.shape[0], -1)
            elif k == "wo":
                a = a.reshape(-1, a.shape[-1])
            out[prefix + k] = _leaf_to_torch(a, device)
        return out

    sd = flat("", {k: v for k, v in params_np.items() if k != "blocks"})
    for i, blk in enumerate(params_np["blocks"]):
        sd.update(flat(f"blocks.{i}.", blk))
    return sd


def probe_params_to_torch(params_np: dict, device) -> tuple:
    """The mean-RGB probe's pytree of `examples/train_vit.py`, `{"vit": …,
    "head": {"w", "b"}}` with numpy leaves → (the ViT's state dict, the
    head's `w` (dim, 3) f32, its `b` (3,) f32)."""
    head = params_np["head"]
    w, b = (_leaf_to_torch(np.asarray(head[k], np.float32), device)
            for k in ("w", "b"))
    return vit_params_to_torch(params_np["vit"], device), w, b
