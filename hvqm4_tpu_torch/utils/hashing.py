"""On-device `oracle --csum`: the position-weighted u32 frame checksum.

The port of `hvqm4_tpu/utils/hashing.py::frame_csum`. Four bytes per frame
leave the device instead of the frame. The host digests (`wsum32`, `fnv1a`,
`oracle_csums`) are shared from `hvqm4_tpu.utils.hashing` through
`hvqm4_tpu_torch.host`.

torch's uint32 sums do not wrap (they promote to int64), so the sum is
taken in int64 and masked: each term (p+1)·w is below 2^40 and a frame has
fewer than 2^19 bytes at 640x480, so the sum stays below 2^59.
"""

from __future__ import annotations

import torch

from ..host import _K


def frame_csum(planes):
    """wsum32 of one frame's YUV bytes (planes concatenated in Y, U, V
    order, row-major). planes: [(…, H, W) u8 tensors] with the same leading
    axes. Returns (…) int64 in [0, 2^32), equal to `oracle --csum`."""
    total = None
    off = 0
    for p in planes:
        n = p.shape[-2] * p.shape[-1]
        flat = p.reshape(*p.shape[:-2], n).long() + 1
        i = torch.arange(off, off + n, dtype=torch.int64, device=p.device)
        w = (i * _K + 1) & 0xFFFFFFFF
        s = (flat * w).sum(-1)
        total = s if total is None else total + s
        off += n
    return total & 0xFFFFFFFF


def batch_csum(y, u, v):
    """(N, H, W) planes of N streams' frames → (N,) checksums."""
    return frame_csum([y, u, v])
