"""Rank functions of `tests/test_torch_sharded.py`, for
`hvqm4_tpu_torch.parallel.dist.launch`. They live apart from the test file
so that a rank imports no JAX (the test file imports both); each takes its
device first, as `launch` calls it."""

import sys

import numpy as np
import torch

from examples.train_vit_torch import loss_fn, train
from hvqm4_tpu_torch.models.vit import ViT, shard_vit_params
from hvqm4_tpu_torch.parallel.dist import make_mesh
from hvqm4_tpu_torch.pipeline import VideoEmbedPipeline


def vit_rank(dev, vcfg, sd: dict, head: tuple, images: np.ndarray,
             weight: np.ndarray) -> dict:
    """A (dp=1, tp=world) mesh: the full ViT from `sd`, this rank's slice,
    then the embeddings of `images` and the gradients of the probe's loss
    at the head `head` (this rank's slices of the sharded leaves)."""
    mesh = make_mesh(1, torch.distributed.get_world_size(), dev.type)
    model = ViT(vcfg)
    model.load_state_dict(sd)
    model.requires_grad_(True)
    shard_vit_params(model, mesh, "tp")
    x = torch.from_numpy(images)
    with torch.no_grad():
        emb = model(x)
    w, b = (torch.from_numpy(a).requires_grad_(True) for a in head)
    loss_fn(model, w, b, x, torch.from_numpy(weight)).backward()
    grads = {n: p.grad.float().numpy() for n, p in model.named_parameters()
             if p.grad is not None}
    grads.update({"head.w": w.grad.numpy(), "head.b": b.grad.numpy()})
    return {"emb": emb.numpy(), "grads": grads}


def mesh_rank(dev, dp: int, tp: int, cfg, clips: list, vcfg,
              train_kwargs: dict) -> dict:
    """A ("dp", "tp") mesh: `VideoEmbedPipeline(mesh=…)`'s embeddings and
    valids a step, then `train(mesh=…)`'s losses; and the modules of JAX or
    of `hvqm4_tpu` the rank imported (none, or the port leaks)."""
    mesh = make_mesh(dp, tp, dev.type)
    pipe = VideoEmbedPipeline(cfg, clips, vcfg, device=dev, mesh=mesh)
    steps = [(emb.numpy(), valid) for emb, _metas, valid in pipe.run()]
    losses = train(cfg, clips, vcfg, device=dev, mesh=mesh, **train_kwargs)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "hvqm4_tpu"))
    return {"pipeline": steps, "losses": losses, "leaked": leaked}


def failing_rank(dev, bad: int):
    """Raise on rank `bad`; the other ranks wait in a collective that
    never completes, so only the caller can stop them."""
    if torch.distributed.get_rank() == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    torch.distributed.barrier()


def steps_rank(dev, dp: int, tp: int, vcfg, batches: list,
               weight: np.ndarray) -> list:
    """A ("dp", "tp") mesh: `train_step`s of the probe from `init_vit` of
    seed 0 and a zero head, on this rank's "dp" share of each batch."""
    from examples.train_vit_torch import (make_optimizer, make_probe,
                                          train_step)

    mesh = make_mesh(dp, tp, dev.type)
    model, head = make_probe(vcfg, dev, seed=0)
    shard_vit_params(model, mesh, "tp")
    opt = make_optimizer(model, head)
    n = len(weight) // dp
    lo = mesh.get_local_rank("dp") * n
    w = torch.from_numpy(weight[lo:lo + n]).to(dev)
    return [float(train_step(model, head, opt,
                             torch.from_numpy(b[lo:lo + n]).to(dev), w,
                             mesh.get_group("dp"))) for b in batches]
