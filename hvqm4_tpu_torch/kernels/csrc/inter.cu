// Inter combine for one P/B plane of N streams: three half-pel predictions
// (forward from ref0 with mv, last from ref1 with mv, backward from ref1
// with mv2), the reference select (past / last / bidirectional blend), the
// residual add, the intra/inter merge and the clip (FORMAT.md 7.4-7.5).
//
// Replaces the Pallas kernel hvqm4_tpu/kernels/inter.py::_kernel. That
// kernel read 192 pre-gathered corner samples per block from an XLA
// prologue (per-MB vectors repeated to blocks, 12 corner gathers, a lane-
// major relayout padded to 2,048-block tiles), because Mosaic has no
// arbitrary 2-D gather. Here each thread reads its own vector from the
// per-block or per-MB grid (gh x gw, shifts passed in) and its own clamped
// corners from the u8 reference planes: no prologue, no padding.
//
// Bound on the H100: memory latency. Each output pixel moves about
// 10-20 B of global traffic: meta, one or two vectors (4-8 B, shared by a
// block or macroblock and served from L1), up to 8 reference bytes (one
// prediction's 4 corners, two for the blend; neighbouring pixels share
// them through L1), the 4 B residual and the u8 intra value, and one u8
// store. The reference reads are data-dependent gathers. The design: one
// thread per pixel, consecutive threads on consecutive pixels of a row so
// that reference rows and the stores coalesce whenever a block's vector is
// shared; only the predictions the block's refsel needs are read, and
// intra blocks read nothing but their intra value.

#include "common.cuh"

namespace {

using hvqm4::clampi;

__device__ __forceinline__ int ref_at(const uint8_t* __restrict__ ref, int ph,
                                      int pw, int yy, int xx) {
  return ref[clampi(yy, 0, ph - 1) * pw + clampi(xx, 0, pw - 1)];
}

// Half-pel prediction of pixel (y, x) with vector (mvx, mvy), clamped
// addressing: a, (a+b+1)>>1, (a+c+1)>>1 or (a+b+c+d+2)>>2 by phase.
__device__ __forceinline__ int predict(const uint8_t* __restrict__ ref, int ph,
                                       int pw, int y, int x, int mvx, int mvy) {
  const int sx = 2 * x + mvx;
  const int sy = 2 * y + mvy;
  const int ix = sx >> 1, hx = sx & 1;
  const int iy = sy >> 1, hy = sy & 1;
  const int a = ref_at(ref, ph, pw, iy, ix);
  if (!hx && !hy) return a;
  if (hx && !hy) return (a + ref_at(ref, ph, pw, iy, ix + 1) + 1) >> 1;
  if (!hx && hy) return (a + ref_at(ref, ph, pw, iy + 1, ix) + 1) >> 1;
  return (a + ref_at(ref, ph, pw, iy, ix + 1) + ref_at(ref, ph, pw, iy + 1, ix)
          + ref_at(ref, ph, pw, iy + 1, ix + 1) + 2) >> 2;
}

__global__ void __launch_bounds__(hvqm4::kThreads)
inter_combine(const uint8_t* __restrict__ meta, const int16_t* __restrict__ mv,
              const int16_t* __restrict__ mv2, const uint8_t* __restrict__ intra,
              const int32_t* __restrict__ acc, const uint8_t* __restrict__ ref0,
              const uint8_t* __restrict__ ref1, uint8_t* __restrict__ out,
              int bh, int bw, int gh, int gw, int sh_y, int sh_x) {
  const int n = blockIdx.y;
  const int ph = bh * 4, pw = bw * 4;
  const int npix = ph * pw;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;  // ragged edge of the last tile
  const int y = p / pw;
  const int x = p - y * pw;
  const size_t q = (size_t)n * npix + p;

  const int m = meta[(size_t)n * bh * bw + (y >> 2) * bw + (x >> 2)];
  if (((m >> 5) & 1) == 0) {  // intra block: already synthesised and clipped
    out[q] = intra[q];
    return;
  }
  const int sel = (m >> 3) & 3;
  const int ng = gh * gw;
  const int g = (y >> sh_y) * gw + (x >> sh_x);
  const int16_t* v = mv + (size_t)n * 2 * ng;
  const int mvx = v[g], mvy = v[ng + g];
  const uint8_t* r0 = ref0 + (size_t)n * npix;
  const uint8_t* r1 = ref1 + (size_t)n * npix;

  int pred;
  if (sel == 0) {
    pred = predict(r0, ph, pw, y, x, mvx, mvy);
  } else if (sel == 1) {
    pred = predict(r1, ph, pw, y, x, mvx, mvy);
  } else {
    const int16_t* v2 = mv2 + (size_t)n * 2 * ng;
    const int fwd = predict(r0, ph, pw, y, x, mvx, mvy);
    const int bwd = predict(r1, ph, pw, y, x, v2[g], v2[ng + g]);
    pred = (fwd + bwd + 1) >> 1;
  }
  out[q] = (uint8_t)hvqm4::clip255(pred + (acc[q] >> 4));
}

}  // namespace

extern "C" int hvqm4_inter_combine(const void* meta, const void* mv,
                                   const void* mv2, const void* intra,
                                   const void* acc, const void* ref0,
                                   const void* ref1, void* out, int n, int bh,
                                   int bw, int gh, int gw, int sh_y, int sh_x,
                                   void* stream) {
  const int npix = bh * bw * 16;
  if (n > 0 && npix > 0) {
    inter_combine<<<hvqm4::plane_grid(n, npix), hvqm4::kThreads, 0,
                    (cudaStream_t)stream>>>(
        (const uint8_t*)meta, (const int16_t*)mv, (const int16_t*)mv2,
        (const uint8_t*)intra, (const int32_t*)acc, (const uint8_t*)ref0,
        (const uint8_t*)ref1, (uint8_t*)out, bh, bw, gh, gw, sh_y, sh_x);
  }
  return (int)cudaGetLastError();
}
