// YUV -> RGB for N streams: fixed-point BT.601 full range, clipped to u8,
// written interleaved as (N, H, W, 3).
//
// Replaces the Pallas kernel hvqm4_tpu/kernels/csc.py::_kernel. That kernel
// took chroma already upsampled by an XLA `jnp.repeat` prologue
// (hvqm4_tpu/ops/csc.py:53-54), padded rows to a 64-row tile, wrote three
// separate planes and left the interleave to a `jnp.stack`. Here the kernel
// owns the upsample: each thread reads U and V at (y >> v_shift,
// x >> h_shift) of the native-size chroma plane, so the full-size chroma
// tensors, the padding and the stack disappear.
//
// Bound on the H100: memory bandwidth and launch cost, with no reuse to
// exploit. At 640x480 4:2:0 a frame reads 1.5 B and writes 3 B per pixel
// (1.38 MB). One thread per output pixel, consecutive threads on
// consecutive pixels of a row, so the luma read and the 3-byte stores of a
// warp cover one contiguous span each; the chroma reads of neighbouring
// threads hit the same bytes and are served from L1. Vector stores (several
// pixels a thread) come later.
//
// The arithmetic is _kernel's: `>>` on signed int is arithmetic, as _sra.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(hvqm4::kThreads)
yuv_to_rgb(const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
           const uint8_t* __restrict__ v, uint8_t* __restrict__ rgb, int h,
           int w, int h_shift, int v_shift) {
  const int n = blockIdx.y;
  const int npix = h * w;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;  // ragged edge of the last tile
  const int py = p / w;
  const int px = p - py * w;
  const int cw = w >> h_shift;
  const size_t cplane = (size_t)(h >> v_shift) * cw;
  const size_t c = (size_t)n * cplane + (py >> v_shift) * cw + (px >> h_shift);

  const int yi = y[(size_t)n * npix + p];
  const int ui = (int)u[c] - 128;
  const int vi = (int)v[c] - 128;
  const int r = yi + ((91881 * vi + 32768) >> 16);
  const int g = yi - ((22554 * ui + 46802 * vi + 32768) >> 16);
  const int b = yi + ((116130 * ui + 32768) >> 16);
  uint8_t* o = rgb + ((size_t)n * npix + p) * 3;
  o[0] = (uint8_t)hvqm4::clip255(r);
  o[1] = (uint8_t)hvqm4::clip255(g);
  o[2] = (uint8_t)hvqm4::clip255(b);
}

}  // namespace

extern "C" int hvqm4_yuv_to_rgb(const void* y, const void* u, const void* v,
                                void* rgb, int n, int h, int w, int h_shift,
                                int v_shift, void* stream) {
  const int npix = h * w;
  if (n > 0 && npix > 0) {
    yuv_to_rgb<<<hvqm4::plane_grid(n, npix), hvqm4::kThreads, 0,
                 (cudaStream_t)stream>>>(
        (const uint8_t*)y, (const uint8_t*)u, (const uint8_t*)v,
        (uint8_t*)rgb, h, w, h_shift, v_shift);
  }
  return (int)cudaGetLastError();
}
