// Intra synthesis for one plane of N streams: WeightImBlock + IntraAotBlock
// + OrgBlock + mode select + clip, and (kWantAcc) the unshifted AOT
// accumulator that inter blocks reuse as their residual.
//
// Replaces the Pallas kernels hvqm4_tpu/kernels/intra.py::_kernel
// (kWantAcc = true, P/B planes) and ::_kernel_noacc (kWantAcc = false,
// I planes). Those kernels left their gathers (nest samples, neighbour DCs,
// descriptor unpack) to an XLA prologue that laid every block out on lanes
// and padded to a 2,048-block tile, because Mosaic has no arbitrary 2-D
// gather. Here the kernel owns its gathers and reads the plan in plane
// layout directly: no prologue, no padding, no relayout.
//
// Bound on the H100: bytes. The work is integer gathers and a few integer
// multiply-adds per pixel, no products worth a tensor core. At 640x480
// luma (120x160 blocks), N=8, the whole arrays are 17.53 MB with the i32
// acc store (meta, dc 0.15 MB each; desc 2.46 MB; raw, out 2.46 MB each;
// acc 9.83 MB) and 7.70 MB without: 5.23 and 2.30 us at 3.35 TB/s.
//
// What held the first design (one thread per pixel, 256 a thread block)
// back, at 48 us for either variant, 10.6% and 4.8% of that bound:
//   - every thread block staged its stream's whole 2,660 B nest with byte
//     loads before a barrier, for 256 pixels: 9,600 stagings per luma
//     call, about 25.5 MB of byte-wide L2 reads;
//   - two runtime modulos per basis per pixel and a division per pixel;
//   - each of a block's 16 threads re-read its meta, 5 DCs and up to 4
//     descriptor words;
//   - one-byte and four-byte stores, one element a thread.
// This design:
//   - one thread per 4x4 block, its 16 pixels and accumulators in
//     registers; a warp covers 32 consecutive blocks of one block row and a
//     thread block 8 block rows of one stream (grid: block-column tiles x
//     block-row tiles x streams), so indices come from blockIdx/threadIdx
//     and the ragged last tiles are masked;
//   - the nest is staged once per thread block with 4-byte loads and serves
//     256 blocks (4,096 pixels, 16x the first design);
//   - meta, the 5 DCs and the block's `count` descriptor words are read
//     once per block; meta and the descriptor words are requested before
//     the staging barrier, all words at once, so their latency overlaps
//     the staging instead of adding one memory latency per basis;
//   - per basis, one modulo per axis; the 4 rows and 4 columns then follow
//     by increment and one conditional subtract, as sx, sy <= 2 < nh, nw;
//   - a block row of pixels is one aligned u32 store, of acc one int4
//     store, of raw one u32 load: a warp writes 128 B of pixels and 512 B
//     of acc per pixel row, contiguous.
// The sum over bases is integer, so its order does not change the result;
// select, shift and clip are the plain version's.

#include "common.cuh"

namespace {

using hvqm4::kMaxBases;
using hvqm4::kTileX;
using hvqm4::kTileY;

template <bool kWantAcc>
__global__ void __launch_bounds__(hvqm4::kThreads)
intra_synth(const uint8_t* __restrict__ meta, const uint8_t* __restrict__ dc,
            const int32_t* __restrict__ desc, const uint8_t* __restrict__ raw,
            const uint8_t* __restrict__ nest, uint8_t* __restrict__ out,
            int32_t* __restrict__ acc_out, int bh, int bw, int nh, int nw) {
  // the stream's nest in 4-byte words (the wrapper keeps nh * nw a
  // multiple of 4, so every stream's nest starts on a word)
  __shared__ uint32_t snest_w[hvqm4::kMaxNest / 4];
  const int n = blockIdx.z;
  const int bx = blockIdx.x * kTileX + threadIdx.x;
  const int by = blockIdx.y * kTileY + threadIdx.y;
  const bool live = bx < bw && by < bh;  // the last tiles are ragged
  const int nb = bh * bw;
  const int b0 = by * bw + bx;

  // the block's meta and descriptor words, requested before the nest is
  // staged so that their latency overlaps the staging
  const int m = live ? meta[(size_t)n * nb + b0] : 0;
  const int mode = m & 7;
  const int nbases = min(hvqm4::basis_count((m >> 5) & 1, mode), kMaxBases);
  const int32_t* dsc = desc + (size_t)n * kMaxBases * nb + b0;
  uint32_t words[kMaxBases];
#pragma unroll
  for (int b = 0; b < kMaxBases; ++b) {
    words[b] = b < nbases ? (uint32_t)__ldg(dsc + (size_t)b * nb) : 0u;
  }

  const int nwords = (nh * nw) >> 2;
  const uint32_t* nest_w =
      reinterpret_cast<const uint32_t*>(nest) + (size_t)n * nwords;
  for (int k = threadIdx.y * kTileX + threadIdx.x; k < nwords;
       k += hvqm4::kThreads) {
    snest_w[k] = __ldg(nest_w + k);
  }
  __syncthreads();
  if (!live) return;
  const uint8_t* snest = reinterpret_cast<const uint8_t*>(snest_w);

  // AOT accumulator over the block's bases (FORMAT.md 6.2, 6.5)
  int acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0;
#pragma unroll
  for (int b = 0; b < kMaxBases; ++b) {
    if (b >= nbases) break;
    const uint32_t d = words[b];
    const int nx = (int)(d >> 25);
    const int ny = (int)((d >> 18) & 0x7F);
    const int sx = (int)((d >> 17) & 1) + 1;
    const int sy = (int)((d >> 16) & 1) + 1;
    const int off = (int)((d >> 8) & 0xFF);
    const int s8 = (int)(d & 0xFF);
    const int scale = s8 - ((s8 & 0x80) << 1);
    int xs[4];
    xs[0] = nx % nw;  // operands are non-negative
#pragma unroll
    for (int j = 1; j < 4; ++j) {
      xs[j] = xs[j - 1] + sx;
      if (xs[j] >= nw) xs[j] -= nw;
    }
    int yy = ny % nh;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint8_t* row = snest + yy * nw;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i * 4 + j] += ((int)row[xs[j]] - off) * scale;
      }
      yy += sy;
      if (yy >= nh) yy -= nh;
    }
  }

  // pixel (by*4 + i, bx*4 + j) of stream n; rows are W = 4*bw bytes
  const int W = bw * 4;
  const size_t p0 = (size_t)n * nb * 16 + (size_t)(by * 4) * W + bx * 4;
  if (mode == 6) {  // OrgBlock: raw pixels, already u8
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<uint32_t*>(out + p0 + i * W) =
          __ldg(reinterpret_cast<const uint32_t*>(raw + p0 + i * W));
    }
  } else {
    const uint8_t* dc_n = dc + (size_t)n * nb;
    const int dcc = dc_n[b0];
    int px[16];
    if (mode == 0) {
      // WeightImBlock: DC smoothing against edge-replicated neighbour DCs
      const int du = dc_n[max(by - 1, 0) * bw + bx] - dcc;
      const int dd = dc_n[min(by + 1, bh - 1) * bw + bx] - dcc;
      const int dl = dc_n[by * bw + max(bx - 1, 0)] - dcc;
      const int dr = dc_n[by * bw + min(bx + 1, bw - 1)] - dcc;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int wacc = du * hvqm4::wsel(i) + dd * hvqm4::wsel(3 - i)
                         + dl * hvqm4::wsel(j) + dr * hvqm4::wsel(3 - j);
          px[i * 4 + j] = dcc + ((wacc + 8) >> 4);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) px[k] = dcc + (acc[k] >> 4);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t packed = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        packed |= (uint32_t)hvqm4::clip255(px[i * 4 + j]) << (8 * j);
      }
      *reinterpret_cast<uint32_t*>(out + p0 + i * W) = packed;
    }
  }
  if (kWantAcc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<int4*>(acc_out + p0 + i * W) =
          make_int4(acc[i * 4], acc[i * 4 + 1], acc[i * 4 + 2],
                    acc[i * 4 + 3]);
    }
  }
}

template <bool kWantAcc>
int launch(const void* meta, const void* dc, const void* desc, const void* raw,
           const void* nest, void* out, void* acc, int n, int bh, int bw,
           int nh, int nw, void* stream) {
  if (n > 0 && bh > 0 && bw > 0) {
    intra_synth<kWantAcc><<<hvqm4::block_grid(n, bh, bw),
                            dim3(kTileX, kTileY), 0, (cudaStream_t)stream>>>(
        (const uint8_t*)meta, (const uint8_t*)dc, (const int32_t*)desc,
        (const uint8_t*)raw, (const uint8_t*)nest, (uint8_t*)out,
        (int32_t*)acc, bh, bw, nh, nw);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hvqm4_intra_synth_acc(const void* meta, const void* dc,
                                     const void* desc, const void* raw,
                                     const void* nest, void* out, void* acc,
                                     int n, int bh, int bw, int nh, int nw,
                                     void* stream) {
  return launch<true>(meta, dc, desc, raw, nest, out, acc, n, bh, bw, nh, nw,
                      stream);
}

extern "C" int hvqm4_intra_synth_noacc(const void* meta, const void* dc,
                                       const void* desc, const void* raw,
                                       const void* nest, void* out, int n,
                                       int bh, int bw, int nh, int nw,
                                       void* stream) {
  return launch<false>(meta, dc, desc, raw, nest, out, nullptr, n, bh, bw, nh,
                       nw, stream);
}

extern "C" const char* hvqm4_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
