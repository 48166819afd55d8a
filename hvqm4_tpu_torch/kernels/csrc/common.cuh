// Shared device helpers for the HVQM4 plane kernels (sm_90a).
//
// Layout contract (hvqm4_tpu_torch/convert.py): every tensor is contiguous
// with a leading stream axis N; per-block fields are (N, bh, bw), pixel
// planes (N, 4*bh, 4*bw), descriptors (N, 4, bh, bw) int32 (the u32 wire
// words), vectors (N, 2, gh, gw) int16.
//
// The decode kernels (intra.cu, inter.cu) run one thread per 4x4 block. A
// plane row is 4*bw bytes, a multiple of 4, and the wrappers pass
// 16-byte-aligned bases, so a block's pixel row is one aligned u32 and its
// i32 row one aligned int4. The csc kernel (csc.cu) runs one thread per 16
// pixels of a row (two rows in 4:2:0) where the width and the bases allow
// 16-byte accesses, else one per pixel (two rows in 4:2:0).
//
// Shifts of signed ints (`acc >> 4`, `mv >> 1`) are arithmetic under nvcc,
// as in the JAX and PyTorch references; `& 1` takes the half-pel phase of
// a negative vector. Division never appears on signed values.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hvqm4 {

constexpr int kThreads = 256;
constexpr int kMaxBases = 4;
constexpr int kMaxNest = 4096;  // the nest is 38x70 or 70x38 = 2,660 B

// A thread block of the decode kernels: one warp per block row, 32
// consecutive 4x4 blocks a warp, kTileY block rows of one stream.
constexpr int kTileX = 32;
constexpr int kTileY = kThreads / kTileX;

__host__ __device__ constexpr int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__host__ __device__ constexpr int clip255(int v) {
  return clampi(v, 0, 255);
}

// Intra modes 1..4 carry `mode` bases, every inter block `mode` residual
// bases, all other blocks none (FORMAT.md 5.3).
__device__ __forceinline__ int basis_count(int cls, int mode) {
  return (cls != 0 || (mode >= 1 && mode <= 4)) ? mode : 0;
}

// The smoothing weight table W = [4, 1, 0, 0] (FORMAT.md 6.3).
__host__ __device__ constexpr int wsel(int idx) {
  return idx == 0 ? 4 : (idx == 1 ? 1 : 0);
}

// The block grid of the decode kernels: (block-column tiles, block-row
// tiles, streams); the wrappers keep N at most 65,535.
inline dim3 block_grid(int n, int bh, int bw) {
  return dim3((unsigned)((bw + kTileX - 1) / kTileX),
              (unsigned)((bh + kTileY - 1) / kTileY), (unsigned)n);
}

}  // namespace hvqm4
