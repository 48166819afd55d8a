"""Inter combine: the CUDA kernel `csrc/inter.cu` and its plain version.

Replaces `hvqm4_tpu/kernels/inter.py::_kernel`. The kernel reads its own
vectors and reference windows, so the JAX package's corner-gather prologue
and lane-major layout disappear. It runs one thread per 4x4 block and
reads one vector per block, so the vector grid may be per block or coarser
(per macroblock), never finer: the JAX reference repeats one vector per
block too (`_mv_blocks`). The wrapper refuses a finer grid on every device.

    inter_combine(plan, intra, acc, ref0, ref1) → (…, H, W) u8
"""

from __future__ import annotations

import torch

from ..ops.device_core import (_i32, _mc_plane, _mv_pixels, _pixel_maps,
                               _sra, _up)
from ._build import Kernel, require, stream_ptr

INTER_COMBINE = Kernel("hvqm4_inter_combine", "ppppppppiiiiiiip",
                       "hvqm4_tpu/kernels/inter.py:47")


def _grid_shift(plane: int, grid: int) -> int:
    """log2 of the block to vector-grid ratio: the plane-pixel to grid
    ratio must be a power of two of at least 4 (a 4x4 block)."""
    ratio = plane // grid if grid else 0
    if grid <= 0 or plane % grid or ratio & (ratio - 1):
        raise ValueError(f"vector grid {grid} does not divide plane extent "
                         f"{plane} by a power of two")
    if ratio < 4:
        raise ValueError(f"vector grid {grid} is finer than the 4x4 blocks "
                         f"of plane extent {plane}")
    return (ratio - 1).bit_length() - 2


def inter_combine_plain(plan, intra, acc, ref0, ref1):
    """Plain PyTorch inter combine on any device: three half-pel
    predictions, refsel select, `+ (acc >> 4)`, clip, merge by cls."""
    bh, bw = plan["meta"].shape[-2:]
    y, x, by, bx, _iw, _jw = _pixel_maps(bh, bw, intra.device)
    meta_up = _up(plan["meta"], by * bw + bx)
    cls_u = _sra(meta_up, 5) & 1
    sel = _sra(meta_up, 3) & 3
    mvx, mvy = _mv_pixels(plan, "mv", y, x)
    mv2x, mv2y = _mv_pixels(plan, "mv2", y, x)
    pf = _mc_plane(ref0, y, x, mvx, mvy)
    pl_ = _mc_plane(ref1, y, x, mvx, mvy)
    pb = _mc_plane(ref1, y, x, mv2x, mv2y)
    pred = torch.where(sel == 0, pf,
                       torch.where(sel == 1, pl_, _sra(pf + pb + 1, 1)))
    inter = (pred + _sra(acc, 4)).clamp(0, 255)
    return torch.where(cls_u == 0, _i32(intra), inter).to(torch.uint8)


def inter_combine(plan, intra, acc, ref0, ref1):
    """The P/B plane of one or N streams from intra synthesis's outputs and
    the reference planes.

    The vector grid is checked on every device (`_grid_shift`). A CPU
    `intra` then takes `inter_combine_plain`; a CUDA `intra` launches the
    kernel, after checking every input's device, dtype, shape, contiguity
    and alignment, or raises."""
    bh, bw = plan["meta"].shape[-2:]
    gh, gw = plan["mv"].shape[-2:]
    gsh_y, gsh_x = _grid_shift(bh * 4, gh), _grid_shift(bw * 4, gw)
    dev = intra.device
    if dev.type == "cpu":
        return inter_combine_plain(plan, intra, acc, ref0, ref1)
    if dev.type != "cuda":
        raise ValueError(f"inter_combine: no kernel for device {dev}")
    single = plan["meta"].dim() == 2
    fields = [plan["meta"], plan["mv"], plan["mv2"], intra, acc, ref0, ref1]
    if single:
        fields = [t.unsqueeze(0) for t in fields]
    meta, mv, mv2, intra, acc, ref0, ref1 = fields
    n = meta.shape[0]
    H, W = bh * 4, bw * 4
    require(meta, "meta", torch.uint8, (n, bh, bw), dev)
    require(mv, "mv", torch.int16, (n, 2, gh, gw), dev)
    require(mv2, "mv2", torch.int16, (n, 2, gh, gw), dev)
    require(intra, "intra", torch.uint8, (n, H, W), dev, align=4)
    require(acc, "acc", torch.int32, (n, H, W), dev, align=16)
    require(ref0, "ref0", torch.uint8, (n, H, W), dev, align=4)
    require(ref1, "ref1", torch.uint8, (n, H, W), dev, align=4)

    out = torch.empty((n, H, W), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        INTER_COMBINE(*(t.data_ptr() for t in
                        (meta, mv, mv2, intra, acc, ref0, ref1, out)),
                      n, bh, bw, gh, gw, gsh_y, gsh_x, stream_ptr(dev))
    return out[0] if single else out
