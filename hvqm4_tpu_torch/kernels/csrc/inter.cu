// Inter combine for one P/B plane of N streams: the half-pel prediction
// (forward from ref0 with mv, last from ref1 with mv, or the blend of
// forward and backward, ref1 with mv2), the residual add, the intra/inter
// merge and the clip (FORMAT.md 7.4-7.5).
//
// Replaces the Pallas kernel hvqm4_tpu/kernels/inter.py::_kernel. That
// kernel read 192 pre-gathered corner samples per block from an XLA
// prologue (per-MB vectors repeated to blocks, 12 corner gathers, a lane-
// major relayout padded to 2,048-block tiles), because Mosaic has no
// arbitrary 2-D gather. Here each thread reads its block's vector from the
// per-block or per-MB grid and its own reference windows from the u8
// planes: no prologue, no padding.
//
// Bound on the H100: bytes. The work is integer gathers and averages, no
// products. At 640x480 luma (120x160 blocks), N=8, the whole arrays are
// 21.04 MB (meta 0.15 MB; mv, mv2 0.61 MB each; intra, ref0, ref1, out
// 2.46 MB each; acc 9.83 MB): 6.28 us at 3.35 TB/s.
//
// What held the first design (one thread per pixel) back, at 26.4 us,
// 23.8% of that bound:
//   - every pixel re-read its block's meta and vectors and did a division;
//   - it branched on the half-pel phase per pixel, though the phase is
//     `mv & 1` and so constant over a block (sx = 2x + mv);
//   - it clamped every corner read, even in the interior windows that are
//     most of the plane;
//   - one-byte reference loads and stores, and a 4-byte acc load, a pixel.
// This design:
//   - one thread per 4x4 block, laid out as in intra.cu: a warp covers 32
//     consecutive blocks of one block row, a thread block 8 block rows of
//     one stream; meta is read once, and an intra block copies its 4 u32
//     rows of `intra` and touches nothing else;
//   - the vector is read once per block (the wrapper refuses vector grids
//     finer than a block); hx = mvx & 1, hy = mvy & 1 and the window's
//     origin (x0 + (mvx >> 1), y0 + (mvy >> 1)) are constant per block, so
//     one (4 + hy) x (4 + hx) window of reference bytes is loaded into
//     registers per prediction (two for the blend), and the 16 outputs
//     follow from one formula, (a + hx*b + hy*c + hx*hy*d + r) >> (hx + hy),
//     with no per-pixel branch;
//   - a window inside the plane is read with no clamps: each window row's
//     4 or 5 bytes come from the two aligned u32 words that hold them,
//     joined by __funnelshift_r. Two word loads a row, against five byte
//     loads, at the cost of a shift; the rows of a plane are 4-byte
//     aligned, so neither word crosses a row. A window that crosses a
//     border takes byte loads with every clamp of `_mc_plane`, which keeps
//     vectors far outside the frame exact;
//   - acc is read as one int4 per block row and the output written as one
//     u32 per row: 512 B and 128 B per warp and pixel row, contiguous.

#include "common.cuh"

namespace {

using hvqm4::clampi;
using hvqm4::kTileX;
using hvqm4::kTileY;

// The 16 half-pel predictions of the 4x4 block whose top-left pixel is
// (x0, y0), with vector (mvx, mvy), from the (ph, pw) plane `ref`; with
// kBlend, each is averaged into `pred` as (pred + p + 1) >> 1 instead, so
// that a blend holds one set of 16 values, not two.
template <bool kBlend>
__device__ __forceinline__ void predict_block(const uint8_t* __restrict__ ref,
                                              int ph, int pw, int x0, int y0,
                                              int mvx, int mvy,
                                              int (&pred)[16]) {
  const int hx = mvx & 1, hy = mvy & 1;
  const int ix0 = x0 + (mvx >> 1), iy0 = y0 + (mvy >> 1);
  int win[5][5];  // row 4 is read only when hy, column 4 only when hx
  if (ix0 >= 0 && iy0 >= 0 && ix0 + 3 + hx < pw && iy0 + 3 + hy < ph) {
    const int sh = (ix0 & 3) * 8;
    const bool two = sh != 0 || hx;  // the bytes spill into a second word
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      if (r == 4 && !hy) {
#pragma unroll
        for (int c = 0; c < 5; ++c) win[4][c] = 0;
        break;
      }
      const uint32_t* w = reinterpret_cast<const uint32_t*>(
          ref + (size_t)(iy0 + r) * pw + (ix0 & ~3));
      const uint32_t lo = __ldg(w);
      const uint32_t hi = two ? __ldg(w + 1) : 0u;
      const uint32_t v = __funnelshift_r(lo, hi, sh);
      win[r][0] = v & 0xFF;
      win[r][1] = (v >> 8) & 0xFF;
      win[r][2] = (v >> 16) & 0xFF;
      win[r][3] = v >> 24;
      win[r][4] = hx ? (hi >> sh) & 0xFF : 0;
    }
  } else {
    // across a border: every read clamped, for any vector
    int cols[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) cols[c] = clampi(ix0 + c, 0, pw - 1);
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const uint8_t* row = ref + (size_t)clampi(iy0 + r, 0, ph - 1) * pw;
#pragma unroll
      for (int c = 0; c < 5; ++c) win[r][c] = row[cols[c]];
    }
  }
  // a, (a+b+1)>>1, (a+c+1)>>1 or (a+b+c+d+2)>>2 by phase
  const int shift = hx + hy;
  const int rnd = (1 << shift) >> 1;
  const int hxy = hx & hy;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = (win[i][j] + hx * win[i][j + 1] + hy * win[i + 1][j]
                     + hxy * win[i + 1][j + 1] + rnd) >> shift;
      pred[i * 4 + j] = kBlend ? (pred[i * 4 + j] + p + 1) >> 1 : p;
    }
  }
}

// at most 64 registers a thread: four thread blocks an SM
__global__ void __launch_bounds__(hvqm4::kThreads, 4)
inter_combine(const uint8_t* __restrict__ meta, const int16_t* __restrict__ mv,
              const int16_t* __restrict__ mv2, const uint8_t* __restrict__ intra,
              const int32_t* __restrict__ acc, const uint8_t* __restrict__ ref0,
              const uint8_t* __restrict__ ref1, uint8_t* __restrict__ out,
              int bh, int bw, int gh, int gw, int gsh_y, int gsh_x) {
  const int n = blockIdx.z;
  const int bx = blockIdx.x * kTileX + threadIdx.x;
  const int by = blockIdx.y * kTileY + threadIdx.y;
  if (bx >= bw || by >= bh) return;  // ragged edge of the last tiles
  const int ph = bh * 4, pw = bw * 4;
  const size_t plane = (size_t)n * ph * pw;
  const size_t p0 = plane + (size_t)(by * 4) * pw + bx * 4;

  const int m = meta[(size_t)n * bh * bw + by * bw + bx];
  if (((m >> 5) & 1) == 0) {  // intra block: already synthesised and clipped
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<uint32_t*>(out + p0 + i * pw) =
          __ldg(reinterpret_cast<const uint32_t*>(intra + p0 + i * pw));
    }
    return;
  }
  const int sel = (m >> 3) & 3;
  const int ng = gh * gw;
  const int g = (by >> gsh_y) * gw + (bx >> gsh_x);
  const int16_t* v = mv + (size_t)n * 2 * ng;
  int pred[16];
  predict_block<false>((sel == 1 ? ref1 : ref0) + plane, ph, pw, bx * 4,
                       by * 4, v[g], v[ng + g], pred);
  if (sel >= 2) {  // bidirectional: blend with the backward prediction
    const int16_t* v2 = mv2 + (size_t)n * 2 * ng;
    predict_block<true>(ref1 + plane, ph, pw, bx * 4, by * 4, v2[g],
                        v2[ng + g], pred);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(acc + p0 + i * pw));
    const uint32_t packed =
        (uint32_t)hvqm4::clip255(pred[i * 4] + (a.x >> 4))
        | (uint32_t)hvqm4::clip255(pred[i * 4 + 1] + (a.y >> 4)) << 8
        | (uint32_t)hvqm4::clip255(pred[i * 4 + 2] + (a.z >> 4)) << 16
        | (uint32_t)hvqm4::clip255(pred[i * 4 + 3] + (a.w >> 4)) << 24;
    *reinterpret_cast<uint32_t*>(out + p0 + i * pw) = packed;
  }
}

}  // namespace

extern "C" int hvqm4_inter_combine(const void* meta, const void* mv,
                                   const void* mv2, const void* intra,
                                   const void* acc, const void* ref0,
                                   const void* ref1, void* out, int n, int bh,
                                   int bw, int gh, int gw, int gsh_y,
                                   int gsh_x, void* stream) {
  if (n > 0 && bh > 0 && bw > 0) {
    inter_combine<<<hvqm4::block_grid(n, bh, bw), dim3(kTileX, kTileY), 0,
                    (cudaStream_t)stream>>>(
        (const uint8_t*)meta, (const int16_t*)mv, (const int16_t*)mv2,
        (const uint8_t*)intra, (const int32_t*)acc, (const uint8_t*)ref0,
        (const uint8_t*)ref1, (uint8_t*)out, bh, bw, gh, gw, gsh_y, gsh_x);
  }
  return (int)cudaGetLastError();
}
