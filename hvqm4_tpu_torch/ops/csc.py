"""Colour-space conversion and resize: decoded planes → RGB → model input.

The port of `hvqm4_tpu/ops/csc.py`. The YUV→RGB formula is the JAX
package's normative fixed-point BT.601 full range, integer-exact:

    R = clip_u8( Y + (91881·(V−128) + 32768 >> 16) )
    G = clip_u8( Y − (22554·(U−128) + 46802·(V−128) + 32768 >> 16) )
    B = clip_u8( Y + (116130·(U−128) + 32768 >> 16) )

with 4:2:0 chroma upsampled by sample replication (nearest). Planes may
carry leading stream axes (…, H, W).

`frame_to_rgb` routes by device: a CPU tensor takes the plain formula, a
CUDA tensor the hand-written kernel (`kernels/csc.py`), for 2-D and
batched planes alike.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .device_core import _i32, _sra


def upsample_chroma(c: torch.Tensor, h_samp: int, v_samp: int):
    """Native-size chroma (…, h, w) → full size by replication, like
    `jnp.repeat`."""
    if v_samp == 2:
        c = c.repeat_interleave(2, dim=-2)
    if h_samp == 2:
        c = c.repeat_interleave(2, dim=-1)
    return c


def yuv_to_rgb(y, u, v):
    """Full-resolution planes (chroma already upsampled) → (…, H, W, 3) u8."""
    yi = _i32(y)
    ui = _i32(u) - 128
    vi = _i32(v) - 128
    r = yi + _sra(91881 * vi + 32768, 16)
    g = yi - _sra(22554 * ui + 46802 * vi + 32768, 16)
    b = yi + _sra(116130 * ui + 32768, 16)
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)


def frame_to_rgb(planes, h_samp: int, v_samp: int):
    """[Y, U, V] planes, chroma at its native size, (H, W) or (N, H, W) →
    (…, H, W, 3) u8 on the planes' device."""
    from ..kernels.csc import yuv_to_rgb as yuv_to_rgb_kernel

    y, u, v = planes
    return yuv_to_rgb_kernel(y, u, v, h_samp, v_samp)


def resize_bilinear(img, out_h: int, out_w: int):
    """u8 (…, H, W, C) → f32 (…, out_h, out_w, C) in [0, 1].

    `jax.image.resize(method="bilinear")` antialiases when it downsamples,
    so this does too: without it, 480x640 → 224x224 differs by up to 0.56.
    The filter's weights sum to 1 within float rounding, so a saturated
    patch may come out a few 1e-7 above 1, there as here."""
    *lead, h, w, c = img.shape
    f = img.to(torch.float32) / 255.0
    x = f.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c).contiguous()
