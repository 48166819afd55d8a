"""PyTorch device core (plain path) vs the JAX device core, bit for bit.

Inputs are made with numpy from a seed and handed to both sides; the codec
is integer, so every comparison is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _random_plane_plan
from hvqm4_tpu.ops import device_core as jdc
from hvqm4_tpu_torch.convert import plan_to_torch, plane_plan_arrays
from hvqm4_tpu_torch.ops import device_core as tdc
from hvqm4_tpu_torch.plans import PlanePlan
from hvqm4_tpu_torch.refdec import aot_acc, weight_blocks

from .test_mc_exhaustive import MVS, _mc_scalar
from .test_weight_aot_spec import _blocks_to_plane_np, _weight_scalar

torch.set_num_threads(1)

# descriptor words at the edges of every field: the sign bit, scale8 = 0x80
# (-128) and 0x7F, each stride bit alone, all-ones and all-zeros
EDGE_WORDS = [0x00000000, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0x00000080,
              0x0000007F, 0x000000FF, 0x00010000, 0x00020000, 0x00030000,
              0xFE000000, 0x01FC0000, 0x0000FF00, 0xAAAAAAAA, 0x55555555,
              0x81FF0080]


def test_unpack_desc_edge_words():
    rng = np.random.default_rng(0)
    words = np.array(EDGE_WORDS + list(rng.integers(0, 1 << 32, 64,
                                                    dtype=np.uint64)),
                     np.uint64).astype(np.uint32)
    want = jdc.unpack_desc(jnp.asarray(words))
    got = tdc.unpack_desc(torch.from_numpy(words.view(np.int32)))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    # the uint32 dtype takes the same int32 view
    got_u = tdc.unpack_desc(torch.from_numpy(words.view(np.int32))
                            .view(torch.uint32))
    for w, g in zip(want, got_u):
        assert np.array_equal(np.asarray(w), g.numpy())
    nx, ny, sx, sy, off, scale = (g.numpy() for g in got)
    assert scale[EDGE_WORDS.index(0x00000080)] == -128
    assert scale[EDGE_WORDS.index(0x0000007F)] == 127
    assert sx[EDGE_WORDS.index(0x00020000)] == 2
    assert sy[EDGE_WORDS.index(0x00010000)] == 2
    assert nx[EDGE_WORDS.index(0xFFFFFFFF)] == 127


def test_unpack_meta_and_basis_count_all_values():
    meta = np.arange(256, dtype=np.uint8)
    want = jdc.unpack_meta(jnp.asarray(meta))
    got = tdc.unpack_meta(torch.from_numpy(meta))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    cls_, _sel, mode = got
    jcls, _jsel, jmode = want
    assert np.array_equal(np.asarray(jdc.basis_count(jcls, jmode)),
                          tdc.basis_count(cls_, mode).numpy())


def _plans(rng, bh, bw, mv_grid):
    """One random plane plan as numpy (sprinkled with raw blocks), with its
    vectors on a per-block or per-MB grid."""
    p = {k: v[0] for k, v in _random_plane_plan(rng, bh, bw, 1).items()}
    p["meta"][::7] = (p["meta"][::7] & 0xD8) | 6  # intra raw blocks
    if mv_grid == "mb":
        for k in ("mv", "mv2"):
            p[k] = np.ascontiguousarray(p[k][:, ::2, ::2])
    return p


# (bh, bw, nest shape, vector grid): every grid with both nests and both
# vector grids across the set
CASES = [(12, 16, (38, 70), "block"), (12, 16, (70, 38), "mb"),
         (30, 40, (38, 70), "mb"), (30, 40, (70, 38), "block"),
         (60, 80, (38, 70), "block"), (60, 80, (70, 38), "mb")]


@pytest.mark.parametrize("bh,bw,nest_shape,mv_grid", CASES)
def test_decode_plane_matches_jax(bh, bw, nest_shape, mv_grid):
    rng = np.random.default_rng(bh * 1000 + bw)
    p = _plans(rng, bh, bw, mv_grid)
    nest = rng.integers(0, 256, nest_shape, dtype=np.uint8)
    ref0, ref1 = (rng.integers(0, 256, (bh * 4, bw * 4), dtype=np.uint8)
                  for _ in range(2))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = plan_to_torch(p, "cpu")

    want = np.asarray(jdc.decode_plane_intra(jp, jnp.asarray(nest)))
    got = tdc.decode_plane_intra(tp, torch.from_numpy(nest))
    assert got.dtype == torch.uint8
    assert np.array_equal(want, got.numpy())

    want = np.asarray(jdc.decode_plane_inter(
        jp, jnp.asarray(nest), jnp.asarray(ref0), jnp.asarray(ref1)))
    got = tdc.decode_plane_inter(tp, torch.from_numpy(nest),
                                 torch.from_numpy(ref0),
                                 torch.from_numpy(ref1))
    assert np.array_equal(want, got.numpy())


def test_decode_plane_stream_axis_matches_per_stream():
    """A leading stream axis N decodes each stream as it decodes alone."""
    rng = np.random.default_rng(5)
    n, bh, bw = 3, 6, 10
    p = _random_plane_plan(rng, bh, bw, n)
    nest = rng.integers(0, 256, (n, 38, 70), dtype=np.uint8)
    refs = [rng.integers(0, 256, (n, bh * 4, bw * 4), dtype=np.uint8)
            for _ in range(2)]
    batched = tdc.decode_plane_inter(
        plan_to_torch(p, "cpu"), torch.from_numpy(nest),
        *(torch.from_numpy(r) for r in refs))
    for j in range(n):
        one = tdc.decode_plane_inter(
            plan_to_torch({k: v[j] for k, v in p.items()}, "cpu"),
            torch.from_numpy(nest[j]), *(torch.from_numpy(r[j]) for r in refs))
        assert torch.equal(batched[j], one)


@pytest.mark.parametrize("mv", MVS)
def test_mc_all_phases_and_borders(mv):
    rng = np.random.default_rng(abs(mv[0] * 1000 + mv[1]))
    ph, pw = 16, 24
    bh, bw = ph // 4, pw // 4
    ref = rng.integers(0, 256, (ph, pw), dtype=np.uint8)
    grid = np.broadcast_to(np.array(mv, np.int16)[:, None, None],
                           (2, bh, bw)).copy()

    y, x, _by, _bx, _iw, _jw = jdc._pixel_maps(bh, bw)
    mvx, mvy = jdc._mv_pixels({"mv": jnp.asarray(grid)}, "mv", y, x)
    want = np.asarray(jdc._mc_plane(jnp.asarray(ref), y, x, mvx, mvy))

    ty, tx, _by, _bx, _iw, _jw = tdc._pixel_maps(bh, bw, "cpu")
    tmx, tmy = tdc._mv_pixels({"mv": torch.from_numpy(grid)}, "mv", ty, tx)
    got = tdc._mc_plane(torch.from_numpy(ref), ty, tx, tmx, tmy).numpy()
    assert np.array_equal(want, got)
    spec = _mc_scalar(ref, mv, bh, bw).transpose(0, 2, 1, 3).reshape(ph, pw)
    assert np.array_equal(spec, got)


# ---------------------------------------------------------------------------
# The literal spec (FORMAT.md §6.2-6.3), as tests/test_weight_aot_spec.py
# holds the JAX device core and golden decoder to it
# ---------------------------------------------------------------------------

def test_weight_blocks_spec_all_borders():
    """DC smoothing at corners, edges and interior: the port's golden
    decoder and its device core against the scalar transcription."""
    rng = np.random.default_rng(0)
    dcg = rng.integers(0, 256, (5, 7), dtype=np.uint8)
    want = _weight_scalar(dcg)
    assert np.array_equal(weight_blocks(dcg), want)
    # an all-mode-0 plan makes every pixel the smoothing output
    t = torch.from_numpy
    plan = {"meta": t(np.zeros((5, 7), np.uint8)), "dc": t(dcg),
            "desc": t(np.zeros((4, 5, 7), np.int32)),
            "raw": t(np.zeros((20, 28), np.uint8))}
    intra, _acc, _meta = tdc._intra_pixels_plane(
        plan, torch.zeros((38, 70), dtype=torch.uint8))
    assert intra.dtype == torch.int32
    assert np.array_equal(intra.numpy(), _blocks_to_plane_np(want))
    # and with a stream axis, each stream on its own grid
    dcg2 = np.stack([dcg, dcg[::-1, ::-1].copy()])
    plan2 = {"meta": t(np.zeros((2, 5, 7), np.uint8)), "dc": t(dcg2),
             "desc": t(np.zeros((2, 4, 5, 7), np.int32)),
             "raw": t(np.zeros((2, 20, 28), np.uint8))}
    intra2, _acc, _meta = tdc._intra_pixels_plane(
        plan2, torch.zeros((2, 38, 70), dtype=torch.uint8))
    for si in range(2):
        assert np.array_equal(intra2[si].numpy(),
                              _blocks_to_plane_np(_weight_scalar(dcg2[si])))


def test_aot_acc_spec_modular_and_mask():
    """Modular nest wrap, stride 1/2, signed scale, count masking."""
    rng = np.random.default_rng(1)
    nest = rng.integers(0, 256, (38, 70), dtype=np.uint8)
    p = PlanePlan.zeros(1, 1)
    cases = [(69, 37, 2, 2, 10, -128),   # wraps both axes at stride 2
             (0, 0, 1, 1, 255, 127)]
    for b, (nx, ny, sx, sy, off, scale) in enumerate(cases):
        p.basis_nx[0, 0, b] = nx
        p.basis_ny[0, 0, b] = ny
        p.basis_sx[0, 0, b] = sx
        p.basis_sy[0, 0, b] = sy
        p.basis_off[0, 0, b] = off
        p.basis_scale[0, 0, b] = scale
    # a third basis present in the arrays but masked out by count=2
    p.basis_scale[0, 0, 2] = 99

    want = np.zeros((4, 4), np.int64)
    for nx, ny, sx, sy, off, scale in cases:
        for i in range(4):
            for j in range(4):
                v = int(nest[(ny + i * sy) % 38, (nx + j * sx) % 70])
                want[i, j] += (v - off) * scale

    got = aot_acc(p, nest, np.array([[2]], np.int32))[0, 0]
    assert np.array_equal(got, want)

    # device core: the count comes from meta, so encode an AOT mode-2 block
    p.mode[0, 0] = 2
    arrs = plan_to_torch(plane_plan_arrays(p), "cpu")
    _intra, acc, _meta = tdc._intra_pixels_plane(arrs, torch.from_numpy(nest))
    assert np.array_equal(acc.numpy()[0:4, 0:4], want)
