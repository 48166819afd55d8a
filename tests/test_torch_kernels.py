"""The port's kernel modules: plain versions vs the Pallas kernels (run in
interpret mode, as tests/test_kernels.py runs them), and the routing and
build rules. The CUDA kernels against their plain versions are in
tests/test_torch_cuda.py, which imports no JAX so that it runs on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _random_plane_plan
from hvqm4_tpu.kernels.inter import decode_plane_inter_pallas
from hvqm4_tpu.kernels.intra import intra_synth_pallas
from hvqm4_tpu_torch.convert import plan_to_torch
from hvqm4_tpu_torch.kernels import _build
from hvqm4_tpu_torch.kernels.inter import inter_combine, inter_combine_plain
from hvqm4_tpu_torch.kernels.intra import intra_synth, intra_synth_plain

torch.set_num_threads(1)


def _plan(rng, bh, bw, n=1, mv_grid="block"):
    """Random plan arrays (numpy, leading stream axis n) with raw blocks
    sprinkled in and vectors on a per-block or per-MB grid."""
    p = _random_plane_plan(rng, bh, bw, n)
    p["meta"][:, ::7] = (p["meta"][:, ::7] & 0xD8) | 6
    if mv_grid == "mb":
        for k in ("mv", "mv2"):
            p[k] = np.ascontiguousarray(p[k][:, :, ::2, ::2])
    return p


def _to_plane(blocks):
    """(bh, bw, 4, 4) block-granular values → (H, W) plane layout."""
    bh, bw = blocks.shape[:2]
    return np.asarray(blocks).transpose(0, 2, 1, 3).reshape(bh * 4, bw * 4)


# (bh, bw, nest): 48x64 = 3,072 blocks runs the Pallas kernels over more
# than one 2,048-block tile
INTRA_CASES = [(12, 16, (38, 70)), (16, 12, (70, 38)), (48, 64, (38, 70))]


@pytest.mark.parametrize("bh,bw,nest_shape", INTRA_CASES)
@pytest.mark.parametrize("want_acc", [True, False])
def test_intra_synth_plain_matches_pallas(bh, bw, nest_shape, want_acc):
    rng = np.random.default_rng(bh * 100 + bw)
    p = {k: v[0] for k, v in _plan(rng, bh, bw).items()}
    nest = rng.integers(0, 256, nest_shape, dtype=np.uint8)
    want_px, want_acc_b = intra_synth_pallas(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(nest),
        interpret=True, want_acc=want_acc)
    got_px, got_acc = intra_synth_plain(plan_to_torch(p, "cpu"),
                                        torch.from_numpy(nest), want_acc)
    assert got_px.dtype == torch.uint8
    assert np.array_equal(_to_plane(want_px), got_px.numpy())
    if want_acc:
        assert np.array_equal(_to_plane(want_acc_b), got_acc.numpy())
    else:
        assert got_acc is None


@pytest.mark.parametrize("bh,bw,mv_grid", [(12, 16, "block"), (12, 16, "mb"),
                                           (48, 64, "mb")])
def test_inter_combine_plain_matches_pallas(bh, bw, mv_grid):
    rng = np.random.default_rng(bh * 100 + bw + 1)
    p = {k: v[0] for k, v in _plan(rng, bh, bw, mv_grid=mv_grid).items()}
    nest = rng.integers(0, 256, (38, 70), dtype=np.uint8)
    ref0, ref1 = (rng.integers(0, 256, (bh * 4, bw * 4), dtype=np.uint8)
                  for _ in range(2))
    want = decode_plane_inter_pallas(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(nest),
        jnp.asarray(ref0), jnp.asarray(ref1), interpret=True)
    tp = plan_to_torch(p, "cpu")
    px, acc = intra_synth_plain(tp, torch.from_numpy(nest))
    got = inter_combine_plain(tp, px, acc, torch.from_numpy(ref0),
                              torch.from_numpy(ref1))
    assert np.array_equal(np.asarray(want), got.numpy())


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(11)
    tp = plan_to_torch(_plan(rng, 6, 8, n=2), "cpu")
    nest = torch.from_numpy(rng.integers(0, 256, (2, 38, 70), dtype=np.uint8))
    ref = torch.from_numpy(rng.integers(0, 256, (2, 24, 32), dtype=np.uint8))
    counts = [k.launches for k in _build.kernels()]
    px, acc = intra_synth(tp, nest)
    want_px, want_acc = intra_synth_plain(tp, nest)
    assert torch.equal(px, want_px) and torch.equal(acc, want_acc)
    assert torch.equal(inter_combine(tp, px, acc, ref, ref),
                       inter_combine_plain(tp, px, acc, ref, ref))
    assert [k.launches for k in _build.kernels()] == counts


def test_other_devices_raise_instead_of_falling_back():
    """A tensor that is neither on the CPU nor on a card gets no plain
    fallback: the wrappers raise."""
    rng = np.random.default_rng(12)
    tp = plan_to_torch(_plan(rng, 2, 2), "meta")
    nest = torch.empty((1, 38, 70), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        intra_synth(tp, nest)
    x = torch.empty((1, 8, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        inter_combine(tp, x, x.int(), x, x)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which",
                        lambda _name: str(tmp_path / "no-such-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not any(tmp_path.iterdir())


def test_library_named_by_source_hash():
    path = _build.library_path()
    assert path == _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libhvqm4_kernels_") and path.suffix == ".so"
    assert {k.symbol for k in _build.kernels()} == {
        "hvqm4_intra_synth_acc", "hvqm4_intra_synth_noacc",
        "hvqm4_inter_combine", "hvqm4_yuv_to_rgb"}


@pytest.mark.parametrize("grid,match", [
    ((24, 32), "finer than the 4x4 blocks"),   # one vector per pixel
    ((12, 16), "finer than the 4x4 blocks"),   # per 2x2 pixels
    ((5, 8), "does not divide"),
])
def test_inter_combine_refuses_grids_finer_than_a_block(grid, match):
    """The kernel reads one vector per 4x4 block, so the wrapper refuses a
    finer grid on every device, the CPU included."""
    rng = np.random.default_rng(13)
    p = _plan(rng, 6, 8)
    for k in ("mv", "mv2"):
        p[k] = rng.integers(-8, 9, (1, 2, *grid)).astype(np.int16)
    tp = plan_to_torch(p, "cpu")
    px, acc = intra_synth_plain(tp, torch.zeros((1, 38, 70),
                                                dtype=torch.uint8))
    with pytest.raises(ValueError, match=match):
        inter_combine(tp, px, acc, px, px)


def test_require_checks_alignment():
    t = torch.zeros(64, dtype=torch.uint8)
    _build.require(t[4:20], "x", torch.uint8, (16,), t.device, align=4)
    with pytest.raises(ValueError, match="multiple of 4 bytes"):
        _build.require(t[2:18], "x", torch.uint8, (16,), t.device, align=4)
