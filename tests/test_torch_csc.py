"""The port's YUV→RGB and resize against the JAX package's (XLA, and the
Pallas kernel in interpret mode, as tests/test_csc_vit.py runs it). The
CUDA kernel against its plain version is in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvqm4_tpu.kernels.csc import yuv_to_rgb_pallas
from hvqm4_tpu.ops import csc as jcsc
from hvqm4_tpu_torch.kernels import _build
from hvqm4_tpu_torch.kernels.csc import (_vector_ok, yuv_to_rgb,
                                         yuv_to_rgb_plain)
from hvqm4_tpu_torch.ops import csc

torch.set_num_threads(1)


def _planes(rng, lead, h, w, samp):
    return [rng.integers(0, 256, (*lead, hh, ww), dtype=np.uint8)
            for hh, ww in ((h, w), (h // samp, w // samp),
                           (h // samp, w // samp))]


@pytest.mark.parametrize("n", [None, 3])
@pytest.mark.parametrize("samp", [2, 1])
@pytest.mark.parametrize("h,w", [(36, 48), (72, 96), (48, 72)])
def test_yuv_to_rgb_matches_jax(n, samp, h, w):
    """Exact against JAX `yuv_to_rgb`, `frame_to_rgb` and the Pallas kernel;
    72 rows run the Pallas kernel over two 64-row tiles; 72 wide is 8 mod
    16, a width the CUDA kernel's vector variant does not take."""
    rng = np.random.default_rng(h * 10 + samp + (n or 0))
    lead = (n,) if n else ()
    y, u, v = _planes(rng, lead, h, w, samp)
    uu, vv = (jcsc.upsample_chroma(jnp.asarray(c), samp, samp)
              for c in (u, v))
    want = np.asarray(jcsc.yuv_to_rgb(jnp.asarray(y), uu, vv))
    assert want.shape == (*lead, h, w, 3)
    assert np.array_equal(want, np.asarray(jcsc.frame_to_rgb(
        [jnp.asarray(p) for p in (y, u, v)], samp, samp)))
    pallas = [np.asarray(yuv_to_rgb_pallas(jnp.asarray(y2), u2, v2,
                                           interpret=True))
              for y2, u2, v2 in zip(y.reshape(-1, h, w),
                                    uu.reshape(-1, h, w),
                                    vv.reshape(-1, h, w))]
    assert np.array_equal(want.reshape(-1, h, w, 3), np.stack(pallas))
    t = [torch.from_numpy(p) for p in (y, u, v)]
    assert np.array_equal(want, yuv_to_rgb_plain(*t, samp, samp).numpy())
    got = csc.frame_to_rgb(t, samp, samp)
    assert got.dtype == torch.uint8 and np.array_equal(want, got.numpy())


def test_gray_maps_to_gray():
    y = torch.arange(256, dtype=torch.uint8).reshape(16, 16)
    c = torch.full((8, 8), 128, dtype=torch.uint8)
    rgb = csc.frame_to_rgb([y, c, c], 2, 2)
    assert torch.equal(rgb, y[..., None].expand(16, 16, 3))
    full = torch.full((16, 16), 128, dtype=torch.uint8)
    assert torch.equal(csc.yuv_to_rgb(y, full, full), rgb)


def test_upsample_chroma_replicates():
    c = torch.arange(6, dtype=torch.uint8).reshape(2, 3)
    assert csc.upsample_chroma(c, 2, 2).tolist() == [
        [0, 0, 1, 1, 2, 2], [0, 0, 1, 1, 2, 2],
        [3, 3, 4, 4, 5, 5], [3, 3, 4, 4, 5, 5]]
    assert csc.upsample_chroma(c, 1, 1) is c


# (input H, W, output side): downsampling with antialias at the decode
# path's size, a small downsample, and an upsample
@pytest.mark.parametrize("h,w,side", [(480, 640, 224), (48, 64, 32),
                                      (48, 64, 224)])
def test_resize_bilinear_matches_jax(h, w, side):
    img = np.random.default_rng(h + side).integers(0, 256, (h, w, 3),
                                                   dtype=np.uint8)
    want = np.asarray(jcsc.resize_bilinear(jnp.asarray(img), side, side))
    got = csc.resize_bilinear(torch.from_numpy(img), side, side)
    assert got.dtype == torch.float32 and got.shape == (side, side, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_resize_bilinear_keeps_leading_axes():
    imgs = np.random.default_rng(5).integers(0, 256, (2, 48, 64, 3),
                                             dtype=np.uint8)
    got = csc.resize_bilinear(torch.from_numpy(imgs), 32, 32)
    assert got.shape == (2, 32, 32, 3)
    for i in range(2):
        np.testing.assert_allclose(
            got[i].numpy(), np.asarray(jcsc.resize_bilinear(
                jnp.asarray(imgs[i]), 32, 32)), rtol=0, atol=1e-5)


def test_cpu_planes_take_the_plain_version():
    y, u, v = (torch.from_numpy(p) for p in _planes(
        np.random.default_rng(6), (2,), 16, 24, 2))
    before = [k.launches for k in _build.kernels()]
    assert torch.equal(yuv_to_rgb(y, u, v, 2, 2),
                       yuv_to_rgb_plain(y, u, v, 2, 2))
    assert [k.launches for k in _build.kernels()] == before


# (W, h_samp, (Y, U, V, RGB) base offsets in bytes from a 4,096-byte
# aligned address, vector variant allowed)
@pytest.mark.parametrize("w,samp,offs,want", [
    (640, 2, (0, 0, 0, 0), True),
    (48, 2, (0, 0, 0, 0), True),
    (640, 1, (0, 0, 0, 0), True),
    (16, 1, (16, 32, 48, 64), True),
    (640, 2, (0, 8, 24, 0), True),      # 4:2:0 chroma needs only 8 bytes
    (640, 2, (480 * 640, 240 * 320, 2 * 240 * 320, 0), True),  # frames[1]
    (72, 2, (0, 0, 0, 0), False),       # 8 mod 16
    (360, 2, (0, 0, 0, 0), False),
    (90, 2, (0, 0, 0, 0), False),
    (26, 1, (0, 0, 0, 0), False),
    (640, 2, (1, 0, 0, 0), False),      # an offset view of luma
    (640, 2, (0, 4, 0, 0), False),
    (640, 1, (0, 8, 0, 0), False),      # 4:4:4 chroma needs 16 bytes
    (640, 1, (0, 0, 8, 0), False),
    (640, 2, (0, 0, 0, 8), False),
    (90, 2, (250 * 90, 125 * 45, 125 * 45, 0), False),  # ragged frames[1]
])
def test_vector_variant_choice(w, samp, offs, want):
    assert _vector_ok(w, samp, *(4096 + o for o in offs)) is want


def test_bad_sampling_and_shapes_raise():
    y = torch.zeros((16, 16), dtype=torch.uint8)
    c = torch.zeros((8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="sampling"):
        yuv_to_rgb(y, c, c, 2, 1)  # 4:2:2 is not a SeqConfig sampling
    with pytest.raises(ValueError, match="chroma"):
        yuv_to_rgb(y, c, c, 1, 1)
    with pytest.raises(ValueError, match="chroma"):
        yuv_to_rgb(y, c, c[None], 2, 2)
    meta = torch.empty((16, 16), dtype=torch.uint8, device="meta")
    cm = torch.empty((8, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        yuv_to_rgb(meta, cm, cm, 2, 2)
