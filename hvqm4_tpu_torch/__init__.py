"""hvqm4_tpu_torch — the PyTorch/CUDA port of hvqm4_tpu.

The package imports nothing of `hvqm4_tpu`. Its host half is its own copy of
the JAX package's JAX-free modules, under the same names, each held against
its original by `tests/test_torch_host.py`:

- `config`, `container`, `plans`: sequence config, `.h4m` demux, plan schema;
- `native`: the C++ entropy planner (`_entropy.cc`, byte for byte), built
  with g++ into `build/` and bound with ctypes;
- `refdec`: the NumPy golden decoder (the third party of `cli verify`);
- `audio`: IMA-ADPCM audio records ↔ PCM, `.wav`;
- `utils.profiling`: `StageTimer`;
- `bitio` (the writers only), `gop`, `encode`: the encoder, numpy on the
  host, its closed loop on the C++ planner and `refdec`, held byte-equal to
  the JAX package's streams by `tests/test_torch_encode.py`.

The device half is rewritten here:

- `convert`: host plan arrays (numpy) → int32/u8/i16 tensors on a device;
- `ops.device_core`: plane-layout decode in plain PyTorch, routed by device
  (a CPU tensor takes the plain path, a CUDA tensor the kernels);
- `kernels/`: hand-written CUDA C++ kernels for Hopper (`sm_90a`): intra
  synthesis, inter combine and YUV→RGB, built with nvcc and bound with
  ctypes;
- `ops.csc`: YUV→RGB (routed by device) and the bilinear resize;
- `models.vit`: the ViT encoder, fed from decoded frames;
- `utils.hashing`: on-device `oracle --csum`, FNV-1a, the oracle's digests;
- `parallel.multistream`: the N-stream decode, the main path: the arena
  `MultiStreamDecoder` (C++ step planning into two packed staging buffers,
  two uploads a step, plain-PyTorch unpack, K fused lock-step decodes,
  planning pipelined on worker threads), GOP-parallel decode of one clip,
  and the per-field lock-step step both share;
- `pipeline`, `data`: the consumer faces on the arena decoder:
  `VideoEmbedPipeline` (streams → ViT embeddings, the ViT at batch N) and
  `FrameBatchLoader` (streams → RGB batches, in decode or display order);
- `parallel.dist`: one process a rank (`launch`), the ("dp", "tp")
  `DeviceMesh` and the tensor-parallel collectives; with a mesh the
  decoder, the loader and the pipeline keep a rank's streams over "dp" and
  `models.vit.shard_vit_params` its heads and MLP units over "tp";
- `entry`: `entry()` (the lock-step step and its arguments at 640x480) and
  `dryrun_multichip(n)` (the sharded path on n ranks against the oracle);
- `utils.stats`: per-clip mode histograms over the C++ planner;
- `encode_tpu`: the encoder's full-nest search (`NestSearch`), every
  candidate scored on the device (`VideoEncoder(use_tpu_search=True)`);
- `session`, `cli`: the frame-at-a-time API and command line (`info`,
  `decode`, `hash`, `verify`, `audio`, `stats`, `remote`, `encode`,
  `transcode`; `decode --gop-parallel` and `verify --batched` on the arena
  decoder);
- `serve`: the decode service (YUV, RGB and ViT-embedding requests, with
  continuous batching on the arena decoder), its wire protocol and its
  clients.

Importing this package imports neither JAX nor the CUDA toolchain.
"""

__version__ = "0.1.0"


def __getattr__(name):  # lazy, like hvqm4_tpu: importing the package is free
    if name in ("DecoderSession", "DecodedFrame"):
        from . import session

        return getattr(session, name)
    if name in ("MultiStreamDecoder", "multi_frame_step"):
        from .parallel import multistream

        return getattr(multistream, name)
    if name == "VideoEmbedPipeline":
        from . import pipeline

        return pipeline.VideoEmbedPipeline
    if name == "FrameBatchLoader":
        from . import data

        return data.FrameBatchLoader
    if name in ("VideoEncoder", "encode_to_size"):
        from . import encode

        return getattr(encode, name)
    raise AttributeError(name)
