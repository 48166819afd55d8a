"""Intra synthesis: the CUDA kernel `csrc/intra.cu` and its plain version.

Replaces `hvqm4_tpu/kernels/intra.py` (`_kernel`, `_kernel_noacc`). Input
and output stay in plane layout with a leading stream axis: no lane-major
relayout, no tile padding, no gather prologue (the kernel owns its gathers).
The kernel runs one thread per 4x4 block and reads and writes a block row
as one word (u32 pixels, int4 accumulators), so pixel planes start on 4
bytes and the accumulator on 16.

    intra_synth(plan, nest, want_acc) → (intra (…,H,W) u8 clipped,
                                         acc (…,H,W) i32 or None)
"""

from __future__ import annotations

import torch

from ..ops import device_core
from ._build import MAX_NEST, Kernel, require, stream_ptr

INTRA_SYNTH_ACC = Kernel("hvqm4_intra_synth_acc", "pppppppiiiiip",
                         "hvqm4_tpu/kernels/intra.py:76")
INTRA_SYNTH_NOACC = Kernel("hvqm4_intra_synth_noacc", "ppppppiiiiip",
                           "hvqm4_tpu/kernels/intra.py:84")


def intra_synth_plain(plan, nest, want_acc: bool = True):
    """Plain PyTorch intra synthesis on any device: the clipped u8 intra
    pixels and, with want_acc, the unshifted i32 AOT accumulator."""
    intra, acc, _meta = device_core._intra_pixels_plane(plan, nest)
    return (intra.clamp(0, 255).to(torch.uint8),
            acc if want_acc else None)


def intra_synth(plan, nest, want_acc: bool = True):
    """Intra pixels (and accumulator) for a plane of one or N streams.

    A CPU `nest` takes `intra_synth_plain`; a CUDA `nest` launches the
    kernel, after checking every input's device, dtype, shape, contiguity
    and alignment, or raises."""
    dev = nest.device
    if dev.type == "cpu":
        return intra_synth_plain(plan, nest, want_acc)
    if dev.type != "cuda":
        raise ValueError(f"intra_synth: no kernel for device {dev}")
    single = plan["meta"].dim() == 2
    fields = [plan[k] for k in ("meta", "dc", "desc", "raw")] + [nest]
    if single:
        fields = [t.unsqueeze(0) for t in fields]
    meta, dc, desc, raw, nest = fields
    n, bh, bw = meta.shape
    nh, nw = nest.shape[-2:]
    # the kernel stages the nest in 4-byte words and wraps its rows and
    # columns with one subtract after a step of at most 2
    if nh * nw > MAX_NEST or nh * nw % 4 or min(nh, nw) < 2:
        raise ValueError(f"intra_synth: nest {nh}x{nw} must have sides of "
                         f"at least 2 and a multiple of 4 bytes up to "
                         f"{MAX_NEST}")
    require(meta, "meta", torch.uint8, (n, bh, bw), dev)
    require(dc, "dc", torch.uint8, (n, bh, bw), dev)
    require(desc, "desc", torch.int32, (n, 4, bh, bw), dev)
    require(raw, "raw", torch.uint8, (n, bh * 4, bw * 4), dev, align=4)
    require(nest, "nest", torch.uint8, (n, nh, nw), dev, align=4)

    out = torch.empty((n, bh * 4, bw * 4), dtype=torch.uint8, device=dev)
    ptrs = [t.data_ptr() for t in (meta, dc, desc, raw, nest, out)]
    with torch.cuda.device(dev):
        if want_acc:
            acc = torch.empty(out.shape, dtype=torch.int32, device=dev)
            INTRA_SYNTH_ACC(*ptrs, acc.data_ptr(), n, bh, bw, nh, nw,
                            stream_ptr(dev))
        else:
            acc = None
            INTRA_SYNTH_NOACC(*ptrs, n, bh, bw, nh, nw, stream_ptr(dev))
    if single:
        out = out[0]
        acc = acc[0] if acc is not None else None
    return out, acc
