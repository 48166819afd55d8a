"""Oracle-compatible frame digests: the port of `hvqm4_tpu/utils/hashing.py`.

- FNV-1a (`oracle --hash`): byte-serial, so it needs the frame on the host;
  `fnv1a` runs it in C (the planner library's `hvqm4_fnv1a`).
- wsum32 (`oracle --csum`): a position-weighted u32 sum, a commutative
  reduction, so `frame_csum` computes it on the device and four bytes per
  frame leave it instead of the frame. `oracle_csums` reads the oracle's.

torch's uint32 sums do not wrap (they promote to int64), so the sum is
taken in int64 and masked: each term (p+1)·w is below 2^40 and a frame has
fewer than 2^19 bytes at 640x480, so the sum stays below 2^59.
"""

from __future__ import annotations

import subprocess

import torch

from ..native import native_fnv1a

_K = 2654435761  # Knuth multiplicative constant; weight_i = i*K + 1 (mod 2^32)


def fnv1a(data: bytes) -> int:
    """FNV-1a of `data`, as `oracle --hash` prints it per frame."""
    return native_fnv1a(data)


def oracle_csums(oracle_path, clip_path) -> list[str]:
    """Per-frame `csum=%08x` digests from `oracle --csum`."""
    res = subprocess.run([str(oracle_path), "--csum", str(clip_path),
                          "/dev/null"],
                         check=True, capture_output=True, text=True)
    return [line.split("csum=")[1] for line in res.stdout.splitlines()
            if "csum=" in line]


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
