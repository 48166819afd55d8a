"""The C++ entropy planner, bound with ctypes: the port's copy of
`hvqm4_tpu/native/__init__.py` over a byte-for-byte copy of its
`_entropy.cc`.

The planner turns a frame payload into the packed device plan layout (dense
meta/dc/slot per plane, per-MB motion vectors, sparse raw/descriptor pools);
`NativePlanner.plan_frame` unpacks that into a `FramePlan`. There is no
Python planner behind it: a failed build raises with the compiler's message.

The shared library is built on first use with g++ (plain `extern "C"` and
ctypes, no pybind11) into `build/hvqm4_tpu_torch/` beside the package (a
directory git ignores), named by the sha256 of the source, the flags and
the host: `-march=native` binds the binary to this CPU, so a library built
on another machine or with other flags is never loaded.

Errors in a payload raise `PlannerError` carrying the C++ message.
`tests/test_torch_host.py` holds the plans against the JAX package's
planner on every test clip.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import subprocess

import numpy as np

from ..config import MAX_BASES, SeqConfig
from ..plans import FramePlan, PlanePlan

_SRC = pathlib.Path(__file__).resolve().parent / "_entropy.cc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "hvqm4_tpu_torch"
CXX = "g++"
CXXFLAGS = ("-std=c++17", "-O3", "-march=native", "-fPIC", "-shared", "-Wall",
            "-Wextra", "-pthread")


class PlannerError(ValueError):
    """Malformed frame payload (invalid symbol, truncated stream, ...)."""


def _host() -> str:
    """The CPU model and feature flags that `-march=native` compiles for."""
    cpu = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name") or line.startswith("flags"):
                    cpu = line
                    if line.startswith("flags"):
                        break
    except OSError:
        pass
    return "|".join([platform.machine(), platform.system(), cpu])


def library_path() -> pathlib.Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update("\0".join([CXX, *CXXFLAGS, _host()]).encode())
    return BUILD_DIR / f"libhvqm4_entropy_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the planner library unless a build of this source, these
    flags and this host exists. Raises RuntimeError with the compiler's
    message when the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        res = subprocess.run([CXX, *CXXFLAGS, "-o", str(tmp), str(_SRC)],
                             capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"planner build: cannot run {CXX}: {e}") from None
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"planner build: {CXX} failed ({res.returncode}):"
                           f"\n{res.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


_FTYPE_CODE = {"I": 0, "P": 1, "B": 2}

# order must match the C PlaneOut struct. `slot` is the unified sparse-payload
# index: a raw-pool slot for raw blocks (cls 0 mode 6) or a desc-pool start
# otherwise (meta disambiguates). Motion vectors are per macroblock and live
# at frame level (`_FrameOut`).
PLANE_KEYS = ("meta", "dc", "slot", "meta5")


class _PlaneOut(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in PLANE_KEYS]


class _PoolOut(ctypes.Structure):
    _fields_ = [("raw_pool", ctypes.c_void_p),
                ("raw_stride", ctypes.c_size_t),
                ("raw_cap", ctypes.c_size_t),
                ("desc_pool", ctypes.c_void_p),
                ("desc_stride", ctypes.c_size_t),
                ("desc_cap", ctypes.c_size_t),
                ("dc_pool", ctypes.c_void_p),
                ("dc_stride", ctypes.c_size_t),
                ("dc_cap", ctypes.c_size_t)]


class _FrameOut(ctypes.Structure):
    _fields_ = [("display_id", ctypes.c_uint32),
                ("dc_shift", ctypes.c_uint32),
                ("nest_x", ctypes.c_uint32),
                ("nest_y", ctypes.c_uint32),
                ("raw_used", ctypes.c_uint32),
                ("desc_used", ctypes.c_uint32),
                ("dc_used", ctypes.c_uint32),
                ("mv_flags", ctypes.c_uint32),
                ("mv2_carriers", ctypes.c_uint32),
                ("pad_", ctypes.c_uint32),
                ("meta_mask", ctypes.c_uint64),
                ("nest", ctypes.c_void_p),
                ("mv", ctypes.c_void_p),
                ("mv2", ctypes.c_void_p)]


class _Library:
    """The loaded planner library (built and loaded once per process)."""

    handle: ctypes.CDLL | None = None

    @classmethod
    def get(cls) -> ctypes.CDLL:
        if cls.handle is None:
            lib = ctypes.CDLL(str(build()))
            lib.hvqm4_plan_frame.restype = ctypes.c_int
            lib.hvqm4_plan_frame.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(_PlaneOut), ctypes.POINTER(_PoolOut),
                ctypes.POINTER(_FrameOut),
                ctypes.c_char_p, ctypes.c_size_t,
            ]
            lib.hvqm4_fnv1a.restype = ctypes.c_uint32
            lib.hvqm4_fnv1a.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]
            cls.handle = lib
        return cls.handle


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def native_fnv1a(data: bytes, h: int = 2166136261) -> int:
    """FNV-1a in C (the digest of `oracle --hash`)."""
    return int(_Library.get().hvqm4_fnv1a(data, len(data), h))


def _alloc_packed_plane(bh: int, bw: int) -> dict[str, np.ndarray]:
    """One plane's packed (sparse) plan arrays."""
    return {
        "meta": np.zeros((bh, bw), np.uint8),
        "dc": np.full((bh, bw), 128, np.uint8),
        "slot": np.zeros((bh, bw), np.uint32),
        "meta5": np.zeros((bh * bw + 4) // 5, np.uint32),
    }


def expand_mb_mv(mv_mb: np.ndarray, bh: int, bw: int, h_samp: int,
                 plane_index: int) -> np.ndarray:
    """Per-MB packed (mh, mw) u32 vector grid (y16 << 16 | x16) → per-block
    (bh, bw, 2) i16 at plane resolution: unpack, repeat over the blocks of
    each MB and arithmetic-shift for 4:2:0 chroma."""
    v = mv_mb.astype(np.int32)
    grid = np.stack([(v << 16) >> 16, v >> 16], axis=-1)  # (mh, mw, 2) i32
    chroma_mb = plane_index > 0 and h_samp == 2
    rpm = 1 if chroma_mb else 2  # blocks per MB edge in this plane
    shift = 1 if chroma_mb else 0
    out = (grid >> shift).astype(np.int16)
    if rpm > 1:
        out = np.repeat(np.repeat(out, rpm, axis=0), rpm, axis=1)
    assert out.shape == (bh, bw, 2)
    return out


def unpack_plane(d: dict[str, np.ndarray], raw_pool: np.ndarray,
                 desc_pool: np.ndarray, mv_blocks: np.ndarray,
                 mv2_blocks: np.ndarray) -> PlanePlan:
    """Packed sparse plan dict (+ pools, expanded MVs) → readable PlanePlan."""
    meta = d["meta"]
    cls_ = (meta >> 5) & 1
    refsel = (meta >> 3) & 3
    mode = meta & 7
    nbases = np.where(
        ((cls_ == 0) & (mode >= 1) & (mode <= 4)) | (cls_ == 1), mode, 0)
    live = (np.arange(MAX_BASES)[None, None, :] < nbases[:, :, None])
    # materialize dense raw/desc from the pools (the unified slot field is a
    # raw index for raw blocks, a desc start otherwise; the inapplicable
    # gather is masked out below)
    slot = d["slot"].astype(np.int64)
    is_raw = (cls_ == 0) & (mode == 6)
    raw_dense = raw_pool[np.clip(slot, 0, len(raw_pool) - 1)]
    raw_dense = raw_dense * is_raw[:, :, None].astype(np.uint8)
    didx = slot[:, :, None] + np.arange(MAX_BASES)[None, None, :]
    desc = desc_pool[np.clip(didx, 0, len(desc_pool) - 1)] * live
    scale8 = (desc & 0xFF).astype(np.int16)
    return PlanePlan(
        cls=cls_.astype(np.uint8),
        mode=mode.astype(np.uint8),
        dc=d["dc"].copy(),
        raw=raw_dense,
        basis_nx=np.where(live, (desc >> 25) & 0x7F, 0).astype(np.uint8),
        basis_ny=np.where(live, (desc >> 18) & 0x7F, 0).astype(np.uint8),
        basis_sx=np.where(live, ((desc >> 17) & 1) + 1, 0).astype(np.uint8),
        basis_sy=np.where(live, ((desc >> 16) & 1) + 1, 0).astype(np.uint8),
        basis_off=np.where(live, (desc >> 8) & 0xFF, 0).astype(np.int16),
        basis_scale=np.where(live, scale8 - ((scale8 & 0x80) << 1), 0).astype(np.int16),
        mv=mv_blocks,
        mv2=mv2_blocks,
        refsel=refsel.astype(np.uint8),
    )


class NativePlanner:
    """The frame planner of one sequence configuration, backed by the C++
    entropy loop."""

    def __init__(self, cfg: SeqConfig):
        self.cfg = cfg
        self._lib = _Library.get()

    def plan_frame(self, ftype: str, payload: bytes) -> FramePlan:
        cfg = self.cfg
        if ftype not in _FTYPE_CODE:
            raise PlannerError(f"bad frame type {ftype!r}")
        dicts = [_alloc_packed_plane(bh, bw) for bh, bw in cfg.block_grids]
        nest = np.zeros(cfg.nest_shape, np.uint8)
        mv_mb = np.zeros(cfg.mb_grid, np.uint32)
        mv2_mb = np.zeros(cfg.mb_grid, np.uint32)
        total = sum(bh * bw for bh, bw in cfg.block_grids)
        raw_pool = np.zeros((total, 16), np.uint8)
        desc_pool = np.zeros(MAX_BASES * total, np.uint32)
        dc_pool = np.zeros(total, np.uint8)
        pool = _PoolOut(raw_pool=_ptr(raw_pool), raw_stride=16,
                        raw_cap=total, desc_pool=_ptr(desc_pool),
                        desc_stride=1, desc_cap=MAX_BASES * total,
                        dc_pool=_ptr(dc_pool), dc_stride=1, dc_cap=total)
        pouts = (_PlaneOut * 3)()
        for i, d in enumerate(dicts):
            pouts[i] = _PlaneOut(**{k: _ptr(d[k]) for k in PLANE_KEYS})
        fout = _FrameOut(nest=_ptr(nest), mv=_ptr(mv_mb), mv2=_ptr(mv2_mb))
        err = ctypes.create_string_buffer(256)
        rc = self._lib.hvqm4_plan_frame(
            payload, len(payload), _FTYPE_CODE[ftype],
            cfg.width, cfg.height, cfg.h_samp, cfg.v_samp,
            pouts, ctypes.byref(pool), ctypes.byref(fout), err, len(err))
        if rc != 0:
            raise PlannerError(err.value.decode(errors="replace"))
        # buffers are fresh here, so masked fields are already zero and the
        # unpacked FramePlan is canonical
        planes = [
            unpack_plane(
                d, raw_pool, desc_pool,
                expand_mb_mv(mv_mb, bh, bw, cfg.h_samp, pi),
                expand_mb_mv(mv2_mb, bh, bw, cfg.h_samp, pi))
            for pi, (d, (bh, bw)) in enumerate(zip(dicts, cfg.block_grids))]
        return FramePlan(
            ftype=ftype, display_id=int(fout.display_id),
            dc_shift=int(fout.dc_shift), nest_x=int(fout.nest_x),
            nest_y=int(fout.nest_y), planes=planes,
            nest=nest if ftype == "I" else None)
