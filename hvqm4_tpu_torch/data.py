"""Training-data loader: `.h4m` corpora → on-device RGB batches.

The port of `hvqm4_tpu/data.py`: iterate batches of decoded RGB frames
(optionally resized) without the pixels ever visiting the host. Built on
the multi-stream decoder, so N clips decode in lock-step on one card.

Two iteration modes with DIFFERENT yield types:

- default (`display_order=False`): lock-step batches in decode order.
  Every item is `(rgb, valid)` where rgb is `(N, H', W', 3)` f32 in [0, 1]
  and valid is the per-stream liveness list (mask finished or poisoned
  streams, e.g. as loss weights):

      loader = FrameBatchLoader(cfg, clips, image_size=224)   # on the card
      loader = FrameBatchLoader(cfg, clips, image_size=224, device="cpu")
      for rgb, valid in loader:
          loss = train_step(model, rgb, valid)

- `display_order=True`: presentation-ordered frames, which are ragged by
  nature (B-frames decode ahead of their display slot). Every item is a
  non-empty list of `(stream_idx, frame)` pairs, where frame is one
  stream's `(H', W', 3)` image. A held-back frame is a view of its step's
  whole `(N, H', W', 3)` batch and keeps that batch alive, so buffering
  costs up to one GOP of device memory per stream. The views are not
  cloned: a clone would add a copy per frame to save memory only while a
  B-frame waits.

The batches are made under `torch.no_grad()` inside a function that returns
before the loader yields, so they are ordinary tensors that can feed a
module under training, and the consumer's grad mode is never touched.
Nothing here waits for the card: batches are enqueued on the current CUDA
stream behind their decode step. `device` defaults to `cuda` and the
constructor raises without a card; `device="cpu"` runs the plain path on
purpose.

With `mesh` (a ("dp", "tp") `DeviceMesh`, `parallel.dist.make_mesh`) the
decoder keeps this rank's share of the streams along "dp"
(`shard_streams`); the ranks of one "dp" group decode the same streams, as
the JAX loader replicates the decode over "tp". Batches, `valid` and the
display-order stream indices are then the rank's own.
"""

from __future__ import annotations

import torch

from .config import SeqConfig
from .ops.csc import frame_to_rgb, resize_bilinear
from .parallel.multistream import MultiStreamDecoder, shard_streams


class FrameBatchLoader:
    def __init__(self, cfg: SeqConfig, clips: list[bytes],
                 image_size: int | None = None, device="cuda", *,
                 display_order: bool = False, plan_ahead: int = 1,
                 mesh=None):
        self.cfg = cfg
        self.decoder = MultiStreamDecoder(
            cfg, clips, device, plan_ahead=plan_ahead,
            sharding=None if mesh is None else shard_streams(mesh, "dp"))
        self.display_order = display_order
        self.image_size = image_size

    @torch.no_grad()
    def _to_rgb(self, frames):
        rgb = frame_to_rgb(frames, self.cfg.h_samp, self.cfg.v_samp)
        if self.image_size is not None:
            return resize_bilinear(rgb, self.image_size, self.image_size)
        return rgb.to(torch.float32) / 255.0

    def __iter__(self):
        if not self.display_order:
            for frames, _metas, valid in self.decoder.run_pipelined():
                yield self._to_rgb(frames), valid
            return
        # display-order: hold back per-stream until ids are contiguous
        pending = [dict() for _ in range(self.decoder.n)]
        nxt = [None] * self.decoder.n
        for frames, metas, valid in self.decoder.run_pipelined():
            batch = self._to_rgb(frames)
            ready: list[tuple[int, torch.Tensor]] = []
            for si, (m, ok) in enumerate(zip(metas, valid)):
                if not ok:
                    continue
                if nxt[si] is None:
                    nxt[si] = m.display_id
                pending[si][m.display_id] = batch[si]
                while nxt[si] in pending[si]:
                    ready.append((si, pending[si].pop(nxt[si])))
                    nxt[si] += 1
            if ready:
                yield ready
        for si in range(self.decoder.n):
            for disp in sorted(pending[si]):
                yield [(si, pending[si].pop(disp))]
