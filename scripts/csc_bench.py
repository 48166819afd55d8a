#!/usr/bin/env python3
"""Time the YUV→RGB kernel (`hvqm4_tpu_torch/kernels/csrc/csc.cu`) on one
CUDA card: its vector and general variants, and another checkout's kernel,
on the same inputs.

    python3 scripts/csc_bench.py [--parent DIR] [--iters N]

`csc.cu` (and, with `--parent`, the other checkout's `csc.cu`) is built
alone by nvcc with the flags of `kernels/_build.py` into build/csc_bench/,
both at once, and nvcc's `-Xptxas -v` lines are printed. `vector` and
`general` call this checkout's kernel with the variant argument set (the
vector variant only where `_vector_ok` allows it); `parent` calls the
other one with the earlier interface (no variant argument).

Points: H = 480 at W = 640 (both variants) and 632 (8 mod 16: the general
variant only), 4:2:0 and 4:4:4. At each point every call must equal the
plain PyTorch formula; each is then timed by the profiler's device time
per call (`chip_smoke.device_us_per_call`) twice, the calls in order and
then in reverse; the lower is the figure, both are printed. The bound is
the call's bytes (Y, U and V read once, RGB written once) over 3.35 TB/s;
at N = 1 and 8 the inputs and outputs fit in the 50 MB L2, and
back-to-back calls find them there. Exits 1 if a build fails or a call
disagrees. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# (N, W, sampling) at H = 480
POINTS = ((1, 640, 2), (8, 640, 2), (64, 640, 2), (8, 640, 1),
          (1, 632, 2), (8, 632, 2), (64, 632, 2), (8, 632, 1), (64, 632, 1))
OUT = REPO / "build" / "csc_bench"
CSC = Path("hvqm4_tpu_torch") / "kernels" / "csrc" / "csc.cu"


def compile_all(sources: dict) -> dict:
    """Start one nvcc per source, all at once; name -> loaded library."""
    from hvqm4_tpu_torch.kernels._build import NVCC_FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = OUT / f"lib_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"csc_bench: nvcc failed on {name} "
                             f"({proc.returncode})\n{log}")
        for ln in log.splitlines():
            if re.search(r"Compiling entry|Used \d+ registers|spill", ln):
                print(f"build {name}: {ln.strip()}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def caller(lib, name: str, y, u, v, out, samp: int):
    """A no-argument launch of one call on these planes."""
    import torch

    fn = lib.hvqm4_yuv_to_rgb
    fn.restype = ctypes.c_int
    n, h, w = y.shape
    stream = torch.cuda.current_stream().cuda_stream
    args = [y.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(), n, h,
            w, samp - 1, samp - 1]
    if name != "parent":
        args.append(int(name == "vector"))
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (len(args) - 4) + [
        ctypes.c_void_p]

    def call():
        rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}")
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose csc.cu has the earlier interface")
    args = ap.parse_args()

    import numpy as np
    import torch

    from chip_smoke import HBM_BYTES_PER_S, card_line, device_us_per_call
    from hvqm4_tpu_torch.kernels.csc import _vector_ok, yuv_to_rgb_plain

    if not torch.cuda.is_available():
        print("csc_bench: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    sources = {"this": REPO / CSC}
    if args.parent is not None:
        sources["parent"] = args.parent / CSC
    libs = compile_all(sources)
    rng = np.random.default_rng(4)
    bad = []
    for n, w, samp in POINTS:
        h = 480
        y, u, v = (torch.from_numpy(rng.integers(
            0, 256, (n, hh, ww), dtype=np.uint8)).cuda()
            for hh, ww in ((h, w), (h // samp, w // samp),
                           (h // samp, w // samp)))
        want = yuv_to_rgb_plain(y, u, v, samp, samp)
        out = torch.empty_like(want)
        names = [*(["vector"] if _vector_ok(
            w, samp, y.data_ptr(), u.data_ptr(), v.data_ptr(),
            out.data_ptr()) else []), "general", *libs.keys() - {"this"}]
        calls = {k: caller(libs.get(k, libs["this"]), k, y, u, v, out, samp)
                 for k in names}
        what = f"480x{w} {'4:2:0' if samp == 2 else '4:4:4'} N={n}"
        ok = []
        for k in names:
            out.fill_(0)
            calls[k]()
            torch.cuda.synchronize()
            if torch.equal(out, want):
                ok.append(k)
            else:
                bad.append((k, what))
                print(f"csc_bench: {k} differs from the plain formula at "
                      f"{what}")
        nbytes = 4 * y.numel() + u.numel() + v.numel()
        bound = nbytes / HBM_BYTES_PER_S * 1e6
        where = "in L2" if nbytes < 50e6 else "past L2"
        print(f"point {what}: {nbytes / 1e6:.3f} MB ({where}), bound "
              f"{bound:.2f} us [{card}]")
        dev = {k: [] for k in ok}
        for k in ok + ok[::-1]:
            dev[k].append(device_us_per_call(calls[k]))
        for k in ok:
            got = [d for d in dev[k] if d is not None]
            best = (f"{min(got):.2f} us ({100 * bound / min(got):.1f}% of "
                    f"bound)" if got else "not measured")
            runs = ", ".join("n/m" if d is None else f"{d:.2f}"
                             for d in dev[k])
            print(f"  {k:8s} device {best} ({runs})")
        del y, u, v, want, out, calls
        torch.cuda.empty_cache()
    print(card)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
