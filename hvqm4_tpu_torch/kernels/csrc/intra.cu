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
// Bound on the H100: memory latency, not bandwidth or arithmetic. Each
// output pixel moves about 10-20 B of global traffic (meta, dc and four
// neighbour dcs, up to four descriptor words, one raw byte; one u8 store
// plus a 4 B acc store), most of it the same words re-read by the 16
// threads of a 4x4 block and served from L1. The data-dependent reads are
// the nest samples: modular 2-D addressing into a 2,660 B table. The design:
//   - each thread block first stages its stream's nest in shared memory,
//     so every nest sample is a shared-memory read, never a global gather;
//   - one thread per pixel, consecutive threads on consecutive pixels of a
//     row, so the raw read and the stores coalesce;
//   - the basis loop stops at the block's basis count.
// Fusing with inter combine, vector loads and more pixels per thread (to
// amortise the nest staging) are left for later.

#include "common.cuh"

namespace {

using hvqm4::kMaxBases;

template <bool kWantAcc>
__global__ void __launch_bounds__(hvqm4::kThreads)
intra_synth(const uint8_t* __restrict__ meta, const uint8_t* __restrict__ dc,
            const int32_t* __restrict__ desc, const uint8_t* __restrict__ raw,
            const uint8_t* __restrict__ nest, uint8_t* __restrict__ out,
            int32_t* __restrict__ acc_out, int bh, int bw, int nh, int nw) {
  __shared__ uint8_t snest[hvqm4::kMaxNest];
  const int n = blockIdx.y;
  const int nsz = nh * nw;
  const uint8_t* nest_n = nest + (size_t)n * nsz;
  for (int k = threadIdx.x; k < nsz; k += blockDim.x) snest[k] = nest_n[k];
  __syncthreads();

  const int W = bw * 4;
  const int npix = bh * bw * 16;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;  // ragged edge of the last tile
  const int y = p / W;
  const int x = p - y * W;
  const int by = y >> 2, bx = x >> 2, i = y & 3, j = x & 3;
  const int nb = bh * bw;
  const int b0 = by * bw + bx;

  const int m = meta[(size_t)n * nb + b0];
  const int cls = (m >> 5) & 1;
  const int mode = m & 7;
  const int count = hvqm4::basis_count(cls, mode);

  // WeightImBlock: DC smoothing against edge-replicated neighbour DCs.
  const uint8_t* dcn = dc + (size_t)n * nb;
  const int dcc = dcn[b0];
  const int dcu = dcn[max(by - 1, 0) * bw + bx];
  const int dcd = dcn[min(by + 1, bh - 1) * bw + bx];
  const int dcl = dcn[by * bw + max(bx - 1, 0)];
  const int dcr = dcn[by * bw + min(bx + 1, bw - 1)];
  const int wacc = (dcu - dcc) * hvqm4::wsel(i) + (dcd - dcc) * hvqm4::wsel(3 - i)
                 + (dcl - dcc) * hvqm4::wsel(j) + (dcr - dcc) * hvqm4::wsel(3 - j);

  // AOT accumulator over the block's bases (FORMAT.md 6.2, 6.5).
  int acc = 0;
  const int32_t* dsc = desc + (size_t)n * kMaxBases * nb + b0;
  for (int b = 0; b < kMaxBases && b < count; ++b) {
    const uint32_t d = (uint32_t)dsc[(size_t)b * nb];
    const int nx = (int)(d >> 25);
    const int ny = (int)((d >> 18) & 0x7F);
    const int sx = (int)((d >> 17) & 1) + 1;
    const int sy = (int)((d >> 16) & 1) + 1;
    const int off = (int)((d >> 8) & 0xFF);
    const int s8 = (int)(d & 0xFF);
    const int scale = s8 - ((s8 & 0x80) << 1);
    const int yy = (ny + i * sy) % nh;  // operands are non-negative
    const int xx = (nx + j * sx) % nw;
    acc += ((int)snest[yy * nw + xx] - off) * scale;
  }

  int px;
  if (mode == 0) {
    px = dcc + ((wacc + 8) >> 4);
  } else if (mode == 6) {
    px = raw[(size_t)n * npix + p];
  } else {
    px = dcc + (acc >> 4);
  }
  out[(size_t)n * npix + p] = (uint8_t)hvqm4::clip255(px);
  if (kWantAcc) acc_out[(size_t)n * npix + p] = acc;
}

template <bool kWantAcc>
int launch(const void* meta, const void* dc, const void* desc, const void* raw,
           const void* nest, void* out, void* acc, int n, int bh, int bw,
           int nh, int nw, void* stream) {
  const int npix = bh * bw * 16;
  if (n > 0 && npix > 0) {
    intra_synth<kWantAcc><<<hvqm4::plane_grid(n, npix), hvqm4::kThreads, 0,
                            (cudaStream_t)stream>>>(
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
