"""The C++ entropy planner, bound with ctypes: the port's copy of
`hvqm4_tpu/native/__init__.py` over a byte-for-byte copy of its
`_entropy.cc`.

The planner turns a frame payload into the packed device plan layout (dense
meta/dc/slot per plane, per-MB motion vectors, sparse raw/descriptor pools).
Three ways in:

- `NativePlanner.plan_frame` plans one frame into fresh buffers and unpacks
  it into a `FramePlan` (the session path);
- `NativePlanner.prepare` + `plan_frame_prepared` plan into a caller's
  stable views through a prebuilt argument block;
- `StepPlanner.plan` plans every stream of a multi-stream step in one
  GIL-released call, and `pack_offsets` and `assemble_shard` pack the
  planned scratch into the arena decoder's two staging buffers
  (`parallel.multistream`).

There is no Python planner behind it: a failed build raises with the
compiler's message.

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


class _AssembleArgs(ctypes.Structure):
    # ABI mirror of _entropy.cc AssembleArgs (hvqm4_assemble_shard)
    _fields_ = [
        ("st8", ctypes.c_void_p), ("st32", ctypes.c_void_p),
        ("raw", ctypes.c_void_p), ("desc", ctypes.c_void_p),
        ("dcp", ctypes.c_void_p), ("slot_used", ctypes.c_void_p),
        ("offs", ctypes.c_void_p),
        ("nvl", ctypes.c_uint64),
        ("raw_cap_full", ctypes.c_uint64),
        ("desc_cap_full", ctypes.c_uint64),
        ("dc_cap_full", ctypes.c_uint64),
        ("offs_off", ctypes.c_uint64),
        ("new_nest", ctypes.c_void_p), ("nest_elems", ctypes.c_uint64),
        ("is_i", ctypes.c_void_p), ("isi_off", ctypes.c_uint64),
        ("is_ref", ctypes.c_void_p), ("isref_off", ctypes.c_uint64),
        ("meta_0", ctypes.c_void_p), ("meta_nb0", ctypes.c_uint64),
        ("meta_off0", ctypes.c_uint64),
        ("meta_1", ctypes.c_void_p), ("meta_nb1", ctypes.c_uint64),
        ("meta_off1", ctypes.c_uint64),
        ("meta_2", ctypes.c_void_p), ("meta_nb2", ctypes.c_uint64),
        ("meta_off2", ctypes.c_uint64),
        ("meta5_0", ctypes.c_void_p), ("meta5_1", ctypes.c_void_p),
        ("meta5_2", ctypes.c_void_p),
        ("meta_mask", ctypes.c_void_p),
        ("cb_off", ctypes.c_uint64),
        ("meta_bits", ctypes.c_int32), ("mv_mode", ctypes.c_int32),
        ("mv_off", ctypes.c_uint64),
        ("mv", ctypes.c_void_p), ("mv2", ctypes.c_void_p),
        ("mv_per_stream", ctypes.c_uint64),
        ("mb_w", ctypes.c_uint64),
        ("luma_bw", ctypes.c_uint64),
    ]


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
            lib.hvqm4_assemble_shard.restype = None
            lib.hvqm4_assemble_shard.argtypes = [ctypes.POINTER(_AssembleArgs)]
            lib.hvqm4_pack_offsets.restype = None
            lib.hvqm4_pack_offsets.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
                ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p]
            lib.hvqm4_plan_step.restype = ctypes.c_int
            lib.hvqm4_plan_step.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(_PlaneOut), ctypes.POINTER(_PoolOut),
                ctypes.POINTER(_FrameOut),
                ctypes.c_char_p, ctypes.c_size_t,
            ]
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


def alloc_pools(total_blocks: int):
    """Full-capacity single-stream pools (contiguous layout)."""
    return (np.zeros((total_blocks, 16), np.uint8),
            np.zeros(MAX_BASES * total_blocks, np.uint32),
            np.zeros(total_blocks, np.uint8))


def make_pool_struct(raw_pool: np.ndarray, desc_pool: np.ndarray,
                     dc_pool: np.ndarray,
                     raw_stride: int | None = None,
                     desc_stride: int | None = None,
                     raw_cap: int | None = None,
                     desc_cap: int | None = None,
                     dc_cap: int | None = None) -> _PoolOut:
    out = _PoolOut(
        raw_pool=_ptr(raw_pool),
        raw_stride=raw_stride if raw_stride is not None else 16,
        raw_cap=raw_cap if raw_cap is not None else raw_pool.shape[0],
        desc_pool=_ptr(desc_pool),
        desc_stride=desc_stride if desc_stride is not None else 1,
        desc_cap=desc_cap if desc_cap is not None else desc_pool.shape[0],
        dc_pool=_ptr(dc_pool),
        dc_stride=1,
        dc_cap=dc_cap if dc_cap is not None else dc_pool.shape[0])
    # C writes through raw pointers
    out._keepalive = (raw_pool, desc_pool, dc_pool)
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


def pack_offsets(slot_used: np.ndarray, is_i: np.ndarray,
                 nest_elems: int, offs: np.ndarray) -> tuple[int, int]:
    """Fill one shard's (nvl, 4) packed-base table from its (nvl, 4)
    slot_used rows (+ nest bytes on I slots); u32 bases cumsum each slot's
    desc entries plus its mv2 pool words. Returns the exact (u8, u32-elem)
    region totals the tier pick quantizes. C mirror of the JAX package's
    numpy offsets in `parallel.multistream.MultiStreamDecoder._assemble`."""
    totals = np.zeros(2, np.uint64)
    _Library.get().hvqm4_pack_offsets(
        _ptr(slot_used), _ptr(is_i), len(is_i), nest_elems,
        _ptr(offs), _ptr(totals))
    return int(totals[0]), int(totals[1])


def assemble_shard(st8_row: np.ndarray, st32_row: np.ndarray, *,
                   raw: np.ndarray, desc: np.ndarray, dcp: np.ndarray,
                   slot_used: np.ndarray, offs: np.ndarray,
                   raw_cap_full: int, desc_cap_full: int, dc_cap_full: int,
                   u8l: dict, u32l: dict,
                   new_nest: np.ndarray | None,
                   is_i: np.ndarray, is_ref: np.ndarray,
                   metas: list[np.ndarray],
                   meta5s: list[np.ndarray],
                   meta_mask: np.ndarray, meta_bits: int,
                   mv: np.ndarray, mv2: np.ndarray, mv_mode: int) -> None:
    """Pack one shard's planned scratch into its staging rows: the C mirror
    of the JAX package's `MultiStreamDecoder._assemble_numpy` (pool
    prefixes, desc then refsel-2 mv2 pool on the u32 side, at the per-slot
    packed bases in `offs`; nest only on I slots; per-slot meta codebooks
    and B-bit indices, or the planner's 6-bit words when meta_bits == 6;
    dense fields at their layout offsets; forward vectors in the step's mv
    encoding). `*_cap_full` are the scratch strides; field offsets come
    from `multistream._layout` for the chosen variant."""
    nvl = len(is_i)
    mv_key = {0: None, 1: "mvp8", 3: "mv"}[mv_mode]
    if len(metas) > 3:
        raise ValueError(f"{len(metas)} planes exceed the C ABI's 3")
    mg = list(metas) + [None] * (3 - len(metas))
    m5 = list(meta5s) + [None] * (3 - len(meta5s))
    kw = {}
    for pi in range(3):
        present = mg[pi] is not None
        kw[f"meta_{pi}"] = _ptr(mg[pi]) if present else None
        kw[f"meta_nb{pi}"] = mg[pi].size // max(nvl, 1) if present else 0
        kw[f"meta_off{pi}"] = u32l[f"meta{pi}"][0] if present else 0
        kw[f"meta5_{pi}"] = _ptr(m5[pi]) if m5[pi] is not None else None
    args = _AssembleArgs(
        st8=_ptr(st8_row), st32=_ptr(st32_row),
        raw=_ptr(raw), desc=_ptr(desc), dcp=_ptr(dcp),
        slot_used=_ptr(slot_used), offs=_ptr(offs), nvl=nvl,
        raw_cap_full=raw_cap_full, desc_cap_full=desc_cap_full,
        dc_cap_full=dc_cap_full,
        offs_off=u32l["offs"][0],
        new_nest=_ptr(new_nest) if new_nest is not None else None,
        nest_elems=(new_nest.size // max(nvl, 1)
                    if new_nest is not None else 0),
        is_i=_ptr(is_i), isi_off=u8l["is_i"][0],
        is_ref=_ptr(is_ref), isref_off=u8l["is_ref"][0],
        meta_mask=_ptr(meta_mask),
        cb_off=u8l["metacb"][0] if meta_bits < 6 else 0,
        meta_bits=meta_bits,
        mv=_ptr(mv), mv2=_ptr(mv2),
        mv_per_stream=mv.size // max(nvl, 1),
        mb_w=mv.shape[-1],
        luma_bw=metas[0].shape[-1],
        mv_mode=mv_mode,
        mv_off=u32l[mv_key][0] if mv_key is not None else 0,
        **kw)
    _Library.get().hvqm4_assemble_shard(ctypes.byref(args))


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
        raw_pool, desc_pool, dc_pool = alloc_pools(total)
        pool = make_pool_struct(raw_pool, desc_pool, dc_pool)
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

    # -- prepared-call fast path (one ctypes call, zero setup) ----------------

    def prepare(self, plane_views: list[dict], pool: _PoolOut,
                nest_view: np.ndarray, mv_view: np.ndarray,
                mv2_view: np.ndarray):
        """Pre-build the ctypes argument block for a stable set of output
        views (one stream's slice of the multi-stream scratch + its pools).

        The returned block keeps references to the backing arrays: the C side
        writes through raw pointers, so the buffers must outlive the block."""
        pouts = (_PlaneOut * 3)()
        for i, d in enumerate(plane_views):
            pouts[i] = _PlaneOut(**{k: _ptr(d[k]) for k in PLANE_KEYS})
        fout = _FrameOut(nest=_ptr(nest_view), mv=_ptr(mv_view),
                         mv2=_ptr(mv2_view))
        err = ctypes.create_string_buffer(256)
        keepalive = (list(plane_views), nest_view, mv_view, mv2_view)
        return (pouts, pool, fout, err, keepalive)

    def plan_frame_prepared(self, ftype: str, payload: bytes, prep):
        """Plan into a prepared argument block.

        Returns (display_id, raw_used, desc_used)."""
        if ftype not in _FTYPE_CODE:
            raise PlannerError(f"bad frame type {ftype!r}")
        pouts, pool, fout, err, _keepalive = prep
        rc = self._lib.hvqm4_plan_frame(
            payload, len(payload), _FTYPE_CODE[ftype],
            self.cfg.width, self.cfg.height, self.cfg.h_samp, self.cfg.v_samp,
            pouts, ctypes.byref(pool), ctypes.byref(fout), err, len(err))
        if rc != 0:
            raise PlannerError(err.value.decode(errors="replace"))
        return (int(fout.display_id), int(fout.raw_used), int(fout.desc_used))


class StepPlanner:
    """Whole-step batch planner: one GIL-released C call plans every active
    slot of a multi-stream step (and fans slots over threads when the
    environment sets HVQM4_PLANNER_THREADS > 1). Argument blocks are built
    once per staging buffer."""

    def __init__(self, planner: NativePlanner, n: int,
                 stream_views: list, pools: list):
        self.planner = planner
        self.n = n
        self.pouts = (_PlaneOut * (3 * n))()
        self.pools = (_PoolOut * n)()
        self.fouts = (_FrameOut * n)()
        for si, (views, nest_view, mv_view, mv2_view) in enumerate(
                stream_views):
            for pi, d in enumerate(views):
                self.pouts[3 * si + pi] = _PlaneOut(
                    **{k: _ptr(d[k]) for k in PLANE_KEYS})
            self.pools[si] = pools[si]
            self.fouts[si] = _FrameOut(nest=_ptr(nest_view), mv=_ptr(mv_view),
                                       mv2=_ptr(mv2_view))
        # the C side writes through these views' raw pointers
        self._keepalive = (stream_views, pools)
        self.payloads = (ctypes.c_char_p * n)()
        self.sizes = (ctypes.c_size_t * n)()
        self.ftypes = (ctypes.c_int * n)()
        self.err = ctypes.create_string_buffer(256)

    def plan(self, jobs: list) -> int:
        """jobs: per slot, (ftype, payload bytes) or None.

        Returns 0 on success or the 1-based index of the first failed slot
        (poison it and plan again). Results are in self.fouts."""
        cfg = self.planner.cfg
        for si, job in enumerate(jobs):
            if job is None:
                self.payloads[si] = None
                self.sizes[si] = 0
                self.ftypes[si] = 0
            else:
                fchar, payload = job
                self.payloads[si] = payload
                self.sizes[si] = len(payload)
                self.ftypes[si] = _FTYPE_CODE[fchar]
        return self.planner._lib.hvqm4_plan_step(
            self.payloads, self.sizes, self.ftypes, self.n,
            cfg.width, cfg.height, cfg.h_samp, cfg.v_samp,
            self.pouts, self.pools, self.fouts, self.err, len(self.err))
