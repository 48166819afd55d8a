"""YUV→RGB: the CUDA kernel `csrc/csc.cu` and its plain version.

Replaces `hvqm4_tpu/kernels/csc.py::_kernel`. The kernel reads chroma at
its native size and upsamples as it goes, so the JAX package's `jnp.repeat`
prologue, its 64-row tile padding and the final `jnp.stack` disappear.

    yuv_to_rgb(y, u, v, h_samp, v_samp) → (…, H, W, 3) u8

Planes are (H, W) or (N, H, W) u8, chroma at its native size. The kernel
has two variants: a vector one (a thread per 16 pixels of a row, two rows
in 4:2:0, 16-byte loads and stores) where `_vector_ok` allows it, and a
general one (byte accesses, a thread per pixel, two rows in 4:2:0) for
every other width and plane base; both are exact.
"""

from __future__ import annotations

import torch

from ..ops.csc import upsample_chroma
from ..ops.csc import yuv_to_rgb as yuv_to_rgb_full
from ._build import Kernel, require, stream_ptr

YUV_TO_RGB = Kernel("hvqm4_yuv_to_rgb", "ppppiiiiiip",
                    "hvqm4_tpu/kernels/csc.py:22")

_SAMPLINGS = ((2, 2), (1, 1))  # 4:2:0 and 4:4:4, as SeqConfig allows


def yuv_to_rgb_plain(y, u, v, h_samp: int, v_samp: int):
    """Plain PyTorch YUV→RGB on any device: replicate chroma, then the
    integer formula."""
    return yuv_to_rgb_full(y, upsample_chroma(u, h_samp, v_samp),
                           upsample_chroma(v, h_samp, v_samp))


def _vector_ok(w: int, h_samp: int, y_ptr: int, u_ptr: int, v_ptr: int,
               out_ptr: int) -> bool:
    """Whether the kernel's vector variant may run: every row a whole
    number of 16-pixel groups, the luma and RGB bases 16-byte aligned and
    the chroma bases 8-byte (4:2:0) or 16-byte (4:4:4) aligned. Each
    stream's planes then start aligned too, as n·h·w and n·(h/2)·(w/2) are
    multiples of 16 and 8."""
    chroma = 16 // h_samp
    return (w % 16 == 0 and y_ptr % 16 == 0 and out_ptr % 16 == 0
            and u_ptr % chroma == 0 and v_ptr % chroma == 0)


def _check_sampling(y, u, v, h_samp: int, v_samp: int) -> None:
    if (h_samp, v_samp) not in _SAMPLINGS:
        raise ValueError(f"yuv_to_rgb: sampling ({h_samp}, {v_samp}) is not "
                         f"one of {_SAMPLINGS}")
    *lead, h, w = y.shape
    want = (*lead, h // v_samp, w // h_samp)
    if h % v_samp or w % h_samp or any(tuple(c.shape) != want for c in (u, v)):
        raise ValueError(
            f"yuv_to_rgb: luma {tuple(y.shape)} is not chroma "
            f"{tuple(u.shape)}, {tuple(v.shape)} times ({v_samp}, {h_samp})")


def yuv_to_rgb(y, u, v, h_samp: int, v_samp: int):
    """RGB of one frame (H, W) or N frames (N, H, W).

    The sampling and the plane shapes are checked on every device. A CPU
    `y` then takes `yuv_to_rgb_plain`; a CUDA `y` launches the kernel, after
    checking every plane's device, dtype and contiguity, or raises. The
    kernel runs its vector variant where `_vector_ok` allows, else its
    general one."""
    _check_sampling(y, u, v, h_samp, v_samp)
    dev = y.device
    if dev.type == "cpu":
        return yuv_to_rgb_plain(y, u, v, h_samp, v_samp)
    if dev.type != "cuda":
        raise ValueError(f"yuv_to_rgb: no kernel for device {dev}")
    single = y.dim() == 2
    if single:
        y, u, v = (t.unsqueeze(0) for t in (y, u, v))
    n, h, w = y.shape
    for t, name in ((y, "y"), (u, "u"), (v, "v")):  # shapes checked above
        require(t, name, torch.uint8, tuple(t.shape), dev)

    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=dev)
    ptrs = (y.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr())
    with torch.cuda.device(dev):
        YUV_TO_RGB(*ptrs, n, h, w, h_samp - 1, v_samp - 1,
                   int(_vector_ok(w, h_samp, *ptrs)), stream_ptr(dev))
    return out[0] if single else out
