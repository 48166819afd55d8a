// YUV -> RGB for N streams: fixed-point BT.601 full range, clipped to u8,
// written interleaved as (N, H, W, 3).
//
// Replaces the Pallas kernel hvqm4_tpu/kernels/csc.py::_kernel. That kernel
// took chroma already upsampled by an XLA `jnp.repeat` prologue
// (hvqm4_tpu/ops/csc.py:53-54), padded rows to a 64-row tile, wrote three
// separate planes and left the interleave to a `jnp.stack`. Here the kernel
// owns the upsample and the interleave: it reads U and V at their native
// size and writes (N, H, W, 3) directly.
//
// Bound on the H100: bytes. A 4:2:0 frame reads 1.5 B and writes 3 B per
// pixel (1.38 MB at 640x480; 88.47 MB, 26.4 us at 3.35 TB/s, for N=64); the
// work is three multiply-adds per chroma sample and a clip per output byte.
//
// What held the first design (one thread per pixel) back, at 32% of that
// bound for N=8: a 32-bit division per pixel to find its row; three byte
// loads and three byte stores per pixel, about 24 B per memory instruction
// of a warp; the three chroma products recomputed for each of the four
// pixels that share a 4:2:0 sample. This design has two variants, chosen by
// kernels/csc.py::_vector_ok and passed in as `vector`:
//   - vector (every row a whole number of 16-pixel groups, the luma and RGB
//     bases 16-byte aligned, the chroma bases 8-byte (4:2:0) or 16-byte
//     (4:4:4) aligned): one thread per 16-pixel group of a row, and in 4:2:0
//     of the two rows that share its chroma. It requests 16 B of Y per row
//     and 8 B each of U and V (16 B in 4:4:4) before any arithmetic,
//     computes the three chroma terms once per chroma sample (a quarter of
//     the products in 4:2:0), and packs each row's 48 output bytes with
//     __byte_perm into three 16-byte words. In 4:2:0 a warp stages its rows'
//     words in shared memory and writes each row as three 16-byte stores a
//     lane, each store of the warp one contiguous span; in 4:4:4 each lane
//     stores its own 48 bytes, at a 48-byte stride that L2 merges. Each is
//     the faster of the two on the H100 for its sampling (PERF.md §6);
//   - general (any other width or base), byte accesses and no division: in
//     4:2:0 one thread per pixel column of a chroma row, its two pixels
//     sharing the terms; in 4:4:4, where a pixel's Y, U, V and RGB share
//     one flat index, one thread per pixel of all N planes. Either way a
//     warp's byte stores of a channel fall in one 96-byte span (one thread
//     per 2x2 cell spread them over 192 bytes and ran slower than the first
//     design at 8-mod-16 widths; PERF.md §6).
// The vector variant and the 4:2:0 general one take their chroma row from
// the grid (column groups or pixel columns x chroma rows x streams). A
// thread block spans whole rows while a row has fewer than kCscThreads
// columns, so narrow planes fill it. At 480x640 4:2:0 the vector variant
// takes 1.8-2.0, 3.8-3.9 and 32.3 us for N = 1, 8 and 64 on the H100 (82%
// of the bound at N=64; PERF.md §6).
//
// The arithmetic is _kernel's: `>>` on signed int is arithmetic, as _sra,
// and every value is clipped to 0..255 before it is packed.

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

// Threads a thread block at most (the 4:4:4 general variant takes
// hvqm4::kThreads): of 64, 80, 128, 160 and 256, only 128 came within 3% of
// the fastest at every 4:2:0 point on the H100 (PERF.md §6).
constexpr int kCscThreads = 128;
constexpr int kGroup = 16;  // pixels of a row per thread, vector variant
constexpr int kMaxGridY = 65535;

struct Terms {
  int r, g, b;  // R = Y + r, G = Y - g, B = Y + b
};

__device__ __forceinline__ Terms chroma_terms(int u, int v) {
  const int ui = u - 128, vi = v - 128;
  return {(91881 * vi + 32768) >> 16, (22554 * ui + 46802 * vi + 32768) >> 16,
          (116130 * ui + 32768) >> 16};
}

template <typename T>
__device__ __forceinline__ T load(const uint8_t* p) {
  return *reinterpret_cast<const T*>(p);
}

__device__ __forceinline__ void store16(uint8_t* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ uint32_t word(uint2 q, int i) {
  return i == 0 ? q.x : q.y;
}

__device__ __forceinline__ uint32_t word(uint4 q, int i) {
  return i == 0 ? q.x : (i == 1 ? q.y : (i == 2 ? q.z : q.w));
}

__device__ __forceinline__ int byte_at(uint32_t w, int i) {
  return (int)((w >> (8 * i)) & 0xFFu);
}

// Four values in 0..255 -> one little-endian word a, b, c, d.
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// One row of a group: 16 luma bytes, pixel p taking the terms of chroma
// sample p >> kHShift -> the row's 48 bytes R,G,B,R,... as 12 words, byte j
// being channel j % 3 of pixel j / 3.
template <int kHShift>
__device__ __forceinline__ void rgb_row(uint4 yq,
                                        const Terms (&t)[kGroup >> kHShift],
                                        uint32_t (&out)[12]) {
  int c[3 * kGroup];
#pragma unroll
  for (int p = 0; p < kGroup; ++p) {
    const int yi = byte_at(word(yq, p >> 2), p & 3);
    const Terms& s = t[p >> kHShift];
    c[3 * p] = hvqm4::clip255(yi + s.r);
    c[3 * p + 1] = hvqm4::clip255(yi - s.g);
    c[3 * p + 2] = hvqm4::clip255(yi + s.b);
  }
#pragma unroll
  for (int k = 0; k < 12; ++k)
    out[k] = pack4(c[4 * k], c[4 * k + 1], c[4 * k + 2], c[4 * k + 3]);
}

// Writes one row's 48 bytes to `o` (16-byte aligned) if `active`. Every
// thread of the block calls it, active or not.
template <bool kStage>
__device__ __forceinline__ void write_row(uint8_t* o, const uint32_t (&wd)[12],
                                          bool active, uint4* stage) {
  if constexpr (kStage) {
    // chunk j of the warp's 3 x `lanes` is part j % 3 of lane j / 3's 48
    // bytes, so each of the three stores covers 16 x `lanes` contiguous
    // bytes where neighbouring lanes hold neighbouring groups. The last warp
    // of a thread block may have fewer than 32 lanes.
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int lane = tid & 31;
    const int lanes = min(32, (int)(blockDim.x * blockDim.y) - (tid & ~31));
    const unsigned mask = lanes == 32 ? 0xFFFFFFFFu : (1u << lanes) - 1;
    const unsigned live = __ballot_sync(mask, active);
    uint4* s = stage + 3 * (tid & ~31);
    s[3 * lane] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    s[3 * lane + 1] = make_uint4(wd[4], wd[5], wd[6], wd[7]);
    s[3 * lane + 2] = make_uint4(wd[8], wd[9], wd[10], wd[11]);
    __syncwarp(mask);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int j = lanes * k + lane;
      const int owner = j / 3;
      uint8_t* dst = reinterpret_cast<uint8_t*>(__shfl_sync(
          mask, reinterpret_cast<unsigned long long>(o), owner));
      if ((live >> owner) & 1u) store16(dst + 16 * (j - 3 * owner), s[j]);
    }
    __syncwarp(mask);
  } else if (active) {
    store16(o, make_uint4(wd[0], wd[1], wd[2], wd[3]));
    store16(o + 16, make_uint4(wd[4], wd[5], wd[6], wd[7]));
    store16(o + 32, make_uint4(wd[8], wd[9], wd[10], wd[11]));
  }
}

// `rows` chroma rows of `cols` 16-pixel groups per stream (blockIdx.z).
template <bool k420>
__global__ void __launch_bounds__(kCscThreads)
yuv_to_rgb_vector(const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
                  const uint8_t* __restrict__ v, uint8_t* __restrict__ rgb,
                  int w, int rows, int cols) {
  constexpr int kHShift = k420 ? 1 : 0;
  constexpr int kRows = k420 ? 2 : 1;  // luma rows a thread, sharing chroma
  constexpr int kSamples = kGroup >> kHShift;  // chroma samples a thread
  using Chroma = std::conditional_t<k420, uint2, uint4>;
  __shared__ uint4 stage[k420 ? 3 * kCscThreads : 1];  // staged in 4:2:0 only
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = blockIdx.z;
  const int cw = w >> kHShift;
  // the loop bound is the same for the whole thread block, so every thread
  // reaches write_row together
  for (int row0 = blockIdx.y * blockDim.y; row0 < rows;
       row0 += gridDim.y * blockDim.y) {
    const int cy = row0 + threadIdx.y;
    const bool active = g < cols && cy < rows;
    const size_t c = (n * rows + cy) * cw + (size_t)g * kSamples;
    const size_t p = (n * rows + cy) * kRows * w + (size_t)g * kGroup;
    uint32_t wd[kRows][12] = {};
    if (active) {
      uint4 yq[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        yq[r] = load<uint4>(y + p + (size_t)r * w);
      const Chroma uq = load<Chroma>(u + c), vq = load<Chroma>(v + c);
      Terms t[kSamples];
#pragma unroll
      for (int s = 0; s < kSamples; ++s)
        t[s] = chroma_terms(byte_at(word(uq, s >> 2), s & 3),
                            byte_at(word(vq, s >> 2), s & 3));
#pragma unroll
      for (int r = 0; r < kRows; ++r) rgb_row<kHShift>(yq[r], t, wd[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      write_row<k420>(rgb + (p + (size_t)r * w) * 3, wd[r], active, stage);
  }
}

// 4:2:0: pixel column x of chroma row cy, that is of luma rows 2cy and
// 2cy + 1, per stream (blockIdx.z), one a thread; the two pixels share the
// terms, and a warp's store of one channel falls in one 96-byte span.
__global__ void __launch_bounds__(kCscThreads)
yuv420_general(const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
               const uint8_t* __restrict__ v, uint8_t* __restrict__ rgb, int w,
               int rows) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  const size_t n = blockIdx.z;
  const int cw = w >> 1;
  for (int cy = blockIdx.y * blockDim.y + threadIdx.y; cy < rows;
       cy += gridDim.y * blockDim.y) {
    const size_t c = (n * rows + cy) * cw + (x >> 1);
    const size_t p = (n * rows + cy) * 2 * w + x;
    const int yi[2] = {y[p], y[p + w]};
    const Terms t = chroma_terms(u[c], v[c]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint8_t* o = rgb + (p + (size_t)r * w) * 3;
      o[0] = (uint8_t)hvqm4::clip255(yi[r] + t.r);
      o[1] = (uint8_t)hvqm4::clip255(yi[r] - t.g);
      o[2] = (uint8_t)hvqm4::clip255(yi[r] + t.b);
    }
  }
}

// 4:4:4: pixel p of all `total` pixels of the N planes, one a thread; Y, U,
// V share its flat index and RGB starts at 3p.
__global__ void __launch_bounds__(hvqm4::kThreads)
yuv444_general(const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
               const uint8_t* __restrict__ v, uint8_t* __restrict__ rgb,
               size_t total) {
  const size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= total) return;
  const int yi = y[p];
  const Terms t = chroma_terms(u[p], v[p]);
  uint8_t* o = rgb + 3 * p;
  o[0] = (uint8_t)hvqm4::clip255(yi + t.r);
  o[1] = (uint8_t)hvqm4::clip255(yi - t.g);
  o[2] = (uint8_t)hvqm4::clip255(yi + t.b);
}

template <bool k420>
void launch(bool vector, const uint8_t* y, const uint8_t* u, const uint8_t* v,
            uint8_t* rgb, int n, int h, int w, cudaStream_t stream) {
  if (n <= 0 || h <= 0 || w <= 0) return;
  if (!k420 && !vector) {
    // the wrapper keeps a plane under 2^31 pixels, and N under 65,536
    const size_t total = (size_t)n * h * w;
    const size_t blocks = (total + hvqm4::kThreads - 1) / hvqm4::kThreads;
    yuv444_general<<<(unsigned)blocks, hvqm4::kThreads, 0, stream>>>(
        y, u, v, rgb, total);
    return;
  }
  const int rows = k420 ? h >> 1 : h;  // chroma rows
  const int cols = vector ? w / kGroup : w;  // groups, or pixel columns
  if (rows <= 0 || cols <= 0) return;
  const int bx = std::min(cols, kCscThreads);
  const int by = std::min(kCscThreads / bx, rows);
  const dim3 block(bx, by);
  const dim3 grid((cols + bx - 1) / bx,
                  std::min((rows + by - 1) / by, kMaxGridY), n);
  if (vector) {
    yuv_to_rgb_vector<k420><<<grid, block, 0, stream>>>(y, u, v, rgb, w, rows,
                                                        cols);
  } else {
    yuv420_general<<<grid, block, 0, stream>>>(y, u, v, rgb, w, rows);
  }
}

}  // namespace

// (h_shift, v_shift) is (1, 1) for 4:2:0 or (0, 0) for 4:4:4, as the wrapper
// checks. `vector` picks the variant; the vector variant's preconditions are
// checked here once more, and a call that breaks them is refused.
extern "C" int hvqm4_yuv_to_rgb(const void* y, const void* u, const void* v,
                                void* rgb, int n, int h, int w, int h_shift,
                                int v_shift, int vector, void* stream) {
  const bool k420 = h_shift != 0 && v_shift != 0;
  if (vector) {
    const uintptr_t chroma_mask = k420 ? 7 : 15;
    if (w % kGroup != 0 || (((uintptr_t)y | (uintptr_t)rgb) & 15) != 0 ||
        (((uintptr_t)u | (uintptr_t)v) & chroma_mask) != 0) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const auto yp = (const uint8_t*)y, up = (const uint8_t*)u,
             vp = (const uint8_t*)v;
  const auto s = (cudaStream_t)stream;
  if (k420) {
    launch<true>(vector != 0, yp, up, vp, (uint8_t*)rgb, n, h, w, s);
  } else {
    launch<false>(vector != 0, yp, up, vp, (uint8_t*)rgb, n, h, w, s);
  }
  return (int)cudaGetLastError();
}
