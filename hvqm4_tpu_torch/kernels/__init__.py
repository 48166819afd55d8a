"""Hand-written CUDA kernels for Hopper (sm_90a), beside their plain
PyTorch versions.

- `intra.intra_synth`: intra synthesis (+ AOT accumulator), `csrc/intra.cu`
- `inter.inter_combine`: MC predictions + select + residual + merge,
  `csrc/inter.cu`
- `csc.yuv_to_rgb`: YUV→RGB with the chroma upsample fused, `csrc/csc.cu`
  (a vector variant, 16 pixels a thread with 16-byte loads and stores,
  and a general one for other widths and unaligned planes)

Each wrapper takes its plain version for CPU tensors and launches its kernel
for CUDA tensors, or raises. `_build` compiles the sources with nvcc on
first use and binds them with ctypes.
"""
