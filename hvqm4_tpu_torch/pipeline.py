"""End-to-end on-device pipeline: `.h4m` streams → ViT embeddings.

The port of `hvqm4_tpu/pipeline.py`: multi-stream decode → YUV→RGB →
resize → ViT encode, with every pixel staying on the device from plan
upload to embedding. This is what a video-understanding training or
serving job calls to consume HVQM4 corpora directly on the card.

    pipe = VideoEmbedPipeline(cfg, clips, vit_cfg)             # on the card
    pipe = VideoEmbedPipeline(cfg, clips, vit_cfg, device="cpu")
    for emb, metas, valid in pipe.run():   # emb: (n_streams, dim) per step
        ...

Each step converts all N streams in one `frame_to_rgb` call (on the card,
one launch of the YUV→RGB kernel) and runs the ViT once at batch N. The
embeddings are enqueued on the current CUDA stream behind the decode step
and nothing here waits for the card: the consumer decides when to
synchronise. `device` defaults to `cuda` and the constructor raises without
a card; `device="cpu"` runs the plain path on purpose.

With `mesh` (a ("dp", "tp") `DeviceMesh`, `parallel.dist.make_mesh`) the
decoder keeps this rank's share of the streams along "dp" and the model
this rank's heads and MLP units along "tp" (`models.vit.shard_vit_params`):
decode has no collectives, the ViT all-reduces over "tp". Each rank yields
its own streams' (n/dp, dim) embeddings, metas and valids.
"""

from __future__ import annotations

import torch

from .config import SeqConfig
from .models.vit import ViT, ViTConfig, init_vit, shard_vit_params
from .ops.csc import frame_to_rgb, resize_bilinear
from .parallel.multistream import MultiStreamDecoder, shard_streams


@torch.no_grad()
def embed_frames(model: ViT, frames, h_samp: int, v_samp: int):
    """[Y, U, V] planes (N, H, W) u8 → (N, dim) f32 embeddings of `model`.

    A function, not a block in a generator: the grad-free region closes
    before any `yield`, so a consumer's own grad mode is never touched."""
    size = model.cfg.image_size
    rgb = frame_to_rgb(frames, h_samp, v_samp)          # (N, H, W, 3) u8
    return model(resize_bilinear(rgb, size, size))


class VideoEmbedPipeline:
    """`params`: a state dict of `models.vit.ViT` (what
    `convert.vit_params_to_torch` returns), or None for weights drawn from
    `rng_seed`; with `mesh` every rank takes the full model so and keeps its
    slice. `plan_ahead` sizes the decoder's staging ring."""

    def __init__(self, cfg: SeqConfig, clips: list[bytes],
                 vit_cfg: ViTConfig | None = None, params: dict | None = None,
                 device="cuda", *, rng_seed: int = 0, plan_ahead: int = 1,
                 mesh=None):
        self.cfg = cfg
        self.vit_cfg = vit_cfg or ViTConfig()
        self.decoder = MultiStreamDecoder(
            cfg, clips, device, plan_ahead=plan_ahead,
            sharding=None if mesh is None else shard_streams(mesh, "dp"))
        device = self.decoder.device
        if params is None:
            self.model = init_vit(
                self.vit_cfg, torch.Generator().manual_seed(rng_seed), device)
        else:
            self.model = ViT(self.vit_cfg)
            self.model.load_state_dict(params)
            self.model.to(device)
        if mesh is not None:
            shard_vit_params(self.model, mesh, "tp")

    def run(self, pipelined: bool = True):
        """Yield (embeddings (N, dim) f32 on the device, metas, valid) per
        decode step."""
        it = (self.decoder.run_pipelined() if pipelined else
              iter(self.decoder.step, None))
        h_samp, v_samp = self.cfg.h_samp, self.cfg.v_samp
        for frames, metas, valid in it:
            yield embed_frames(self.model, frames, h_samp, v_samp), metas, valid
