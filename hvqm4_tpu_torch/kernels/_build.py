"""Build and bind the CUDA kernels: nvcc → one shared library → ctypes.

The sources in `csrc/` have a plain `extern "C"` interface and include no
PyTorch header, so one nvcc call builds them in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/hvqm4_tpu_torch/libhvqm4_kernels_<sha>.so
         csrc/intra.cu csrc/inter.cu csrc/csc.cu

The library is built at first use, into `build/` beside the package (a
directory git ignores), and named by the sha256 of its sources and flags, so
an edited source is never served a stale library. Pointers and the CUDA
stream cross ctypes as `c_void_p`, sizes as `c_int`. Every entry point
returns `cudaGetLastError()` after its launch; `Kernel.__call__` raises on
anything but 0.

Nothing here runs at import: the modules are imported on hosts without
nvcc or a card, and the build runs only when a CUDA tensor first reaches a
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_HEADERS = ("common.cuh",)
_SOURCES = ("intra.cu", "inter.cu", "csc.cu")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "hvqm4_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_ARG = {"p": ctypes.c_void_p, "i": ctypes.c_int}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return path


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _HEADERS + _SOURCES:
        h.update(name.encode() + b"\0" + (_CSRC / name).read_bytes())
    return BUILD_DIR / f"libhvqm4_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernel library unless a build of these sources exists.
    nvcc's `-Xptxas -v` report (registers, shared memory, spills per
    kernel) is kept beside the library as `<name>.log`."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(_CSRC / s) for s in _SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    lib.with_suffix(".log").write_text(" ".join(cmd) + "\n" + res.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


class _Library:
    """The loaded kernel library (loaded once per process, on first use)."""

    handle: ctypes.CDLL | None = None

    @classmethod
    def get(cls) -> ctypes.CDLL:
        if cls.handle is None:
            lib = ctypes.CDLL(str(build()))
            lib.hvqm4_error_string.restype = ctypes.c_char_p
            lib.hvqm4_error_string.argtypes = [ctypes.c_int]
            cls.handle = lib
        return cls.handle


class Kernel:
    """One C entry point of the kernel library, with its launch count.

    `signature` spells the C arguments: "p" for a pointer (or the stream),
    "i" for an int. `launches` counts successful launches only; nothing else
    adds to it."""

    def __init__(self, symbol: str, signature: str, replaces: str):
        self.symbol = symbol
        self.argtypes = [_ARG[c] for c in signature]
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(_Library.get(), self.symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = self.argtypes
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            msg = _Library.get().hvqm4_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} ({msg})")
        self.launches += 1


MAX_NEST = 4096  # bytes of nest a thread block stages (csrc/common.cuh)
MAX_STREAMS = 65535  # the grid's y extent: one stream per grid row


def require(t, name: str, dtype, shape: tuple, device, align: int = 1) -> None:
    """Raise unless `t` is a contiguous tensor of this dtype and shape on
    this device, starting on a multiple of `align` bytes: the kernels take
    raw pointers and trust all five."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: expected {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data must start on a multiple of {align} "
                         f"bytes (the kernel reads it in {align}-byte words)")
    if t.dim() == 3 and t.shape[0] > MAX_STREAMS:
        raise ValueError(f"{name}: {t.shape[0]} streams exceed one launch's "
                         f"{MAX_STREAMS}")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name}: {t.numel()} elements overflow the "
                         f"kernels' int32 pixel indexing")


def stream_ptr(device) -> int:
    """The current CUDA stream of `device`, as the pointer the kernels take."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def kernels() -> list[Kernel]:
    """Every kernel entry point of the port."""
    from .csc import YUV_TO_RGB
    from .inter import INTER_COMBINE
    from .intra import INTRA_SYNTH_ACC, INTRA_SYNTH_NOACC

    return [INTRA_SYNTH_NOACC, INTRA_SYNTH_ACC, INTER_COMBINE, YUV_TO_RGB]
