"""PyTorch device core: plan tensors → pixels, batched over the whole plane.

The port of `hvqm4_tpu/ops/device_core.py`. Every pixel of a plane is
computed at once in plane layout (H, W): block modes become masked selects,
nest lookups and motion compensation become gathers, and all arithmetic is
int32 with arithmetic shifts, so the output is bit-identical to the C oracle.

Tensors follow the plan contract of `hvqm4_tpu_torch.convert` and may carry
leading stream axes (…, H, W): the JAX package's `vmap`, written out. Shifts
are `>>` on signed int32, which is arithmetic in torch as in JAX; `//` and
`/` would round negatives differently and never appear.

Entry points route by device: a CPU tensor takes the plain PyTorch path
below, a CUDA tensor takes the hand-written kernels (`kernels/`), which
launch or raise.

    decode_plane_intra(plan, nest)               I frames
    decode_plane_inter(plan, nest, ref0, ref1)   P/B frames
"""

from __future__ import annotations

import torch

from ..config import MAX_BASES


def _sra(x, n: int):
    """Arithmetic shift right: `>>` on a signed tensor propagates the sign."""
    return x >> n


def _i32(x):
    return x.to(torch.int32)


def basis_count(cls_, mode):
    """Per-block AOT basis count from (cls, mode): intra modes 1..4 carry
    `mode` bases, every inter block carries `mode` residual bases, all
    other blocks none (FORMAT.md §5.3)."""
    return torch.where((cls_ != 0) | ((mode >= 1) & (mode <= 4)), mode,
                       torch.zeros_like(mode))


def unpack_meta(meta):
    """meta u8 → (cls, refsel, mode) i32."""
    m = _i32(meta)
    return _sra(m, 5) & 1, _sra(m, 3) & 3, m & 7


def unpack_desc(desc):
    """Wire-format basis descriptors (FORMAT.md §6.5), as the int32 view of
    the u32 words → i32 fields. torch cannot shift uint32, so the fields
    are cut from the int32 view with an arithmetic shift and a mask."""
    d = desc.view(torch.int32) if desc.dtype == torch.uint32 else _i32(desc)
    nx = _sra(d, 25) & 0x7F
    ny = _sra(d, 18) & 0x7F
    sx = (_sra(d, 17) & 1) + 1
    sy = (_sra(d, 16) & 1) + 1
    off = _sra(d, 8) & 0xFF
    scale8 = d & 0xFF
    scale = scale8 - ((scale8 & 0x80) << 1)  # sign-extend 8-bit
    return nx, ny, sx, sy, off, scale


# ---------------------------------------------------------------------------
# Plane-layout helpers
# ---------------------------------------------------------------------------

def _pixel_maps(bh: int, bw: int, device):
    """Shared per-pixel index maps for a (bh, bw) block grid.

    Returns (y, x, by, bx, iw, jw) as (H, W) i32: pixel coords, owning
    block coords, and within-block coords.
    """
    H, W = bh * 4, bw * 4
    y = torch.arange(H, dtype=torch.int32, device=device)[:, None].expand(H, W)
    x = torch.arange(W, dtype=torch.int32, device=device)[None, :].expand(H, W)
    return y, x, _sra(y, 2), _sra(x, 2), y & 3, x & 3


def _take(flat, idx):
    """`jnp.take` along the last axis, per stream: flat (…, M) with index
    idx (…, H, W) or (H, W) → (…, H, W) i32. Every caller clamps or wraps
    idx into range first: torch raises (CPU) or device-asserts (CUDA) on an
    out-of-range gather where JAX would fill."""
    lead = flat.shape[:-1]
    h, w = idx.shape[-2:]
    i = idx.long().expand(*lead, h, w).reshape(*lead, h * w)
    return torch.gather(flat, -1, i).reshape(*lead, h, w)


def _up(grid2d, blk):
    """Per-block value grid (…, bh, bw) → per-pixel (…, H, W) i32, gathered
    with the (H, W) block-index map `blk`."""
    return _i32(grid2d).flatten(-2)[..., blk.long()]


def _wsel(idx):
    """The smoothing weight table W = [4, 1, 0, 0] as arithmetic on the
    (H, W) within-block index (FORMAT.md §6.3)."""
    return _i32(idx == 0) * 4 + _i32(idx == 1)


# ---------------------------------------------------------------------------
# Intra synthesis (WeightImBlock + IntraAotBlock + OrgBlock, per pixel)
# ---------------------------------------------------------------------------

def _intra_pixels_plane(plan, nest):
    """All intra math in plane layout.

    Returns (intra (…,H,W) i32 unclipped, acc (…,H,W) i32 AOT accumulator,
    meta_up (…,H,W) i32 per-pixel meta) — inter blocks reuse acc as their
    residual and meta_up for cls/refsel.
    """
    bh, bw = plan["meta"].shape[-2:]
    _y, _x, by, bx, iw, jw = _pixel_maps(bh, bw, plan["meta"].device)
    blk = by * bw + bx

    meta_up = _up(plan["meta"], blk)
    cls_u = _sra(meta_up, 5) & 1
    mode_u = meta_up & 7
    count_u = basis_count(cls_u, mode_u)

    # WeightImBlock: DC smoothing against the 4 edge-replicated neighbours
    dc = plan["dc"]
    dc_c = _up(dc, blk)
    dcU = _up(dc, (by - 1).clamp(min=0) * bw + bx)
    dcD = _up(dc, (by + 1).clamp(max=bh - 1) * bw + bx)
    dcL = _up(dc, by * bw + (bx - 1).clamp(min=0))
    dcR = _up(dc, by * bw + (bx + 1).clamp(max=bw - 1))
    wacc = ((dcU - dc_c) * _wsel(iw) + (dcD - dc_c) * _wsel(3 - iw)
            + (dcL - dc_c) * _wsel(jw) + (dcR - dc_c) * _wsel(3 - jw))
    wpx = dc_c + _sra(wacc + 8, 4)

    # AOT accumulator: Σ scaled nest samples, modular nest addressing
    nh, nw = nest.shape[-2:]
    nestf = _i32(nest).flatten(-2)
    acc = torch.zeros_like(meta_up)
    for b in range(MAX_BASES):
        nx, ny, sx, sy, off, scale = unpack_desc(
            _up(plan["desc"][..., b, :, :], blk))
        yy = (ny + iw * sy) % nh
        xx = (nx + jw * sx) % nw
        s = _take(nestf, yy * nw + xx)
        acc = acc + (s - off) * scale * (count_u > b)
    apx = dc_c + _sra(acc, 4)

    rpx = _i32(plan["raw"])
    intra = torch.where(mode_u == 0, wpx, torch.where(mode_u == 6, rpx, apx))
    return intra, acc, meta_up


# ---------------------------------------------------------------------------
# Motion compensation (FORMAT.md §7.4)
# ---------------------------------------------------------------------------

def _mv_pixels(plan, key, y, x):
    """Upsample a (…, 2, gh, gw) vector grid to per-pixel (mvx, mvy)
    (…, H, W) i32. The grid may be per-block or per-macroblock; the
    pixel→grid shift is the exact log2 of the resolution ratio."""
    mv = plan[key]
    gh, gw = mv.shape[-2:]
    H, W = y.shape
    sh_y = (H // gh - 1).bit_length()
    sh_x = (W // gw - 1).bit_length()
    mblk = (_sra(y, sh_y) * gw + _sra(x, sh_x)).long()
    m = _i32(mv).flatten(-2)
    return m[..., 0, :][..., mblk], m[..., 1, :][..., mblk]


def _mc_plane(ref, y, x, mvx, mvy):
    """Half-pel MC for every pixel → (…, H, W) i32; clamped addressing."""
    ph, pw = ref.shape[-2:]
    r = _i32(ref).flatten(-2)
    sx = 2 * x + mvx
    sy = 2 * y + mvy
    ix, hx = _sra(sx, 1), sx & 1
    iy, hy = _sra(sy, 1), sy & 1

    def at(yy, xx):
        return _take(r, yy.clamp(0, ph - 1) * pw + xx.clamp(0, pw - 1))

    a = at(iy, ix)
    b = at(iy, ix + 1)
    c = at(iy + 1, ix)
    d = at(iy + 1, ix + 1)
    return torch.where(
        (hx == 0) & (hy == 0), a,
        torch.where((hx == 1) & (hy == 0), _sra(a + b + 1, 1),
                    torch.where((hx == 0) & (hy == 1), _sra(a + c + 1, 1),
                                _sra(a + b + c + d + 2, 2))))


# ---------------------------------------------------------------------------
# Plane entry points
# ---------------------------------------------------------------------------

def decode_plane_intra(plan, nest):
    """I-frame plane: all blocks intra → (…, H, W) u8."""
    from ..kernels.intra import intra_synth

    intra, _ = intra_synth(plan, nest, want_acc=False)
    return intra


def decode_plane_inter(plan, nest, ref0, ref1):
    """P/B plane: masked mix of intra blocks and MC(+residual) blocks
    → (…, H, W) u8.

    ref0 = past (ref_prev for B; ref_last for P), ref1 = ref_last. The
    bidirectional blend is (fwd + bwd + 1) >> 1 before the residual
    (FORMAT.md §7.5).
    """
    from ..kernels.inter import inter_combine
    from ..kernels.intra import intra_synth

    intra, acc = intra_synth(plan, nest, want_acc=True)
    return inter_combine(plan, intra, acc, ref0, ref1)
