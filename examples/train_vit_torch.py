"""Training example on the port: `.h4m` corpus → decode on the card → ViT →
`torch.optim.Adam`. The counterpart of `examples/train_vit.py`; it imports
only `hvqm4_tpu_torch` and the port's clip generator
(`tools/encoder_torch.py`).

The framework as a training input pipeline: `FrameBatchLoader` decodes N
streams in lock-step on the card, converts them to RGB and resizes them
there, and the batch feeds the ViT without visiting the host. The objective
is the JAX example's: predict each frame's mean RGB from the pooled
embedding through a linear head, which drives real gradients through the
whole decode → RGB → resize → ViT stack, and the loss must fall.

    python examples/train_vit_torch.py [--width 64 --height 48 --streams 8
                                        --epochs 3] [--clip PATH ...]
                                       [--device cuda|cpu]
                                       [--dp 2 --tp 2 --backend nccl|gloo]

Without `--clip` the clips are the JAX example's: stream s is
`tools/encoder_torch.make_clip` (the port's generator) of the GOP patterns
["IPBPB", "IPP"] at seed s, byte for byte what `tools/encoder.make_clip`
gives the JAX example. `--device`
defaults to `cuda`; without a card the script fails. `--device cpu` runs
the plain PyTorch paths on purpose.

`--dp D` (with `--tp T`, default 1) trains on a ("dp", "tp") mesh of D*T
ranks, one process each (`parallel.dist.launch`): the streams shard over
"dp", the ViT's heads and MLP over "tp". The loss is the JAX example's
weighted mean over the whole global batch: the sum of the weights is
all-reduced over "dp", each rank divides its own weighted sum by it, and
the gradients are summed over "dp". DDP's averaging of the ranks' own means
would differ as soon as the "dp" shards hold different numbers of valid
frames, as at the end of streams of unequal length. The replicated
parameters are not reduced over "tp": `copy_to_tp` already gives every
"tp" rank their whole gradient. `--backend` defaults to `nccl` on `cuda`
(a card per rank) and `gloo` on the CPU; ranks that share a card take
`gloo`. A backend that cannot serve the ranks is one line and exit 1.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import torch
import torch.distributed as dist

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from hvqm4_tpu_torch.config import SeqConfig  # noqa: E402
from hvqm4_tpu_torch.container import Demuxer  # noqa: E402
from hvqm4_tpu_torch.data import FrameBatchLoader  # noqa: E402
from hvqm4_tpu_torch.models.vit import (ViT, ViTConfig, init_vit,  # noqa: E402
                                        shard_vit_params)
from hvqm4_tpu_torch.parallel.dist import launch, make_mesh  # noqa: E402
from tools.encoder_torch import make_clip  # noqa: E402

GOPS = ["IPBPB", "IPP"]


def loss_fn(model: ViT, head_w, head_b, images, weight, total=None):
    """The JAX example's masked loss: the per-stream MSE of the predicted
    mean RGB, weighted, over max(`total`, 1). `total` is the sum of the
    weights over the whole global batch; None takes this batch's."""
    emb = model(images)                                  # (N, dim)
    pred = emb @ head_w + head_b
    target = images.mean(dim=(1, 2))                     # (N, 3)
    per = ((pred - target) ** 2).mean(dim=1)             # (N,)
    if total is None:
        total = weight.sum()
    return (per * weight).sum() / total.clamp(min=1.0)


def train_step(model: ViT, head, opt, images, weight, dp=None):
    """One forward, backward and Adam step; returns the loss on the device
    (reading it would wait for the card). With `dp` (the "dp" process
    group) the batch is this rank's share of the global one: the weights'
    sum is all-reduced before the forward, and the gradients and the loss
    are summed over `dp` after the backward, in one f32 all-reduce."""
    opt.zero_grad(set_to_none=True)
    total = None
    if dp is not None:
        total = weight.sum()
        dist.all_reduce(total, group=dp)
    loss = loss_fn(model, *head, images, weight, total)
    loss.backward()
    loss = loss.detach()
    if dp is not None:
        grads = [p.grad for g in opt.param_groups for p in g["params"]
                 if p.grad is not None]
        flat = torch.cat([loss.reshape(1)]
                         + [g.reshape(-1).float() for g in grads])
        dist.all_reduce(flat, group=dp)
        loss = flat[0]
        off = 1
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
    opt.step()
    return loss


def make_probe(vcfg: ViTConfig, device, seed: int = 0, params=None):
    """(the ViT with its parameters trainable, the head (w, b)). `params`
    is what `convert.probe_params_to_torch` returns; None draws the ViT from
    `seed` with `init_vit` and starts the head at zeros."""
    if params is None:
        model = init_vit(vcfg, torch.Generator().manual_seed(seed), device)
        w = torch.zeros((vcfg.dim, 3), device=device)
        b = torch.zeros((3,), device=device)
    else:
        sd, w, b = params
        model = ViT(vcfg)
        model.load_state_dict(sd)
        model.to(device)
        w, b = w.detach().clone().to(device), b.detach().clone().to(device)
    model.requires_grad_(True)
    return model, (w.requires_grad_(True), b.requires_grad_(True))


def make_optimizer(model: ViT, head, lr: float = 1e-3):
    """`optax.adam(lr)`'s defaults, over every parameter and the head."""
    return torch.optim.Adam([*model.parameters(), *head], lr=lr,
                            betas=(0.9, 0.999), eps=1e-8)


def weight_of(valid: list, device) -> torch.Tensor:
    """The loader's `valid` list as f32 loss weights on the device; the
    upload does not wait for the card."""
    return torch.tensor(valid, dtype=torch.float32).to(device,
                                                        non_blocking=True)


def train(cfg: SeqConfig, clips: list[bytes], vcfg: ViTConfig,
          epochs: int = 3, lr: float = 1e-3, seed: int = 0, device="cuda",
          params=None, mesh=None) -> list[float]:
    """Train the mean-RGB probe; returns the per-step loss history. The
    losses stay on the device until every step has been enqueued.

    With `mesh` (a ("dp", "tp") `DeviceMesh`; call it on every rank) each
    rank builds the full probe from the same `seed` or `params`, keeps its
    "tp" slice, and trains on its "dp" share of the streams; the history
    is the global loss's, the same on every rank."""
    model, head = make_probe(vcfg, device, seed, params)
    dp = None
    if mesh is not None:
        shard_vit_params(model, mesh, "tp")
        dp = mesh.get_group("dp")
    opt = make_optimizer(model, head, lr)
    losses = []
    for _ in range(epochs):
        for images, valid in FrameBatchLoader(
                cfg, clips, image_size=vcfg.image_size, device=device,
                mesh=mesh):
            losses.append(train_step(model, head, opt, images,
                                     weight_of(valid, device), dp))
    return torch.stack(losses).tolist()


def train_rank(device, dp: int, tp: int, args: tuple,
               kwargs: dict) -> list[float]:
    """One rank of a ("dp", "tp") run, for `parallel.dist.launch`:
    `train(*args, **kwargs)` on this rank's device and the mesh."""
    return train(*args, device=device, mesh=make_mesh(dp, tp, device.type),
                 **kwargs)


def make_clips(cfg: SeqConfig, n_streams: int, gops=GOPS) -> list[bytes]:
    """One clip a stream, stream s `make_clip(cfg, gops, seed=s)`, as
    `examples/train_vit.py` makes its clips."""
    return [make_clip(cfg, gops, seed=s) for s in range(n_streams)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=48)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--clip", action="append", default=[],
                    help="an .h4m clip to train on (repeatable); replaces "
                         "the generated clips")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel mesh width (0 = no mesh)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel mesh width")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="process-group backend of the mesh (default: nccl "
                         "on cuda, gloo on the CPU)")
    args = ap.parse_args()

    if args.clip:
        clips = [pathlib.Path(p).read_bytes() for p in args.clip]
        cfg = Demuxer(clips[0]).info.cfg
    else:
        cfg = SeqConfig(args.width, args.height)
        clips = make_clips(cfg, args.streams)
    vcfg = ViTConfig(image_size=64, patch_size=8, dim=128, depth=2, heads=4)
    if args.dp:
        try:
            losses = launch(train_rank, args.dp * args.tp, args.dp, args.tp,
                            (cfg, clips, vcfg), {"epochs": args.epochs},
                            device=args.device, backend=args.backend)[0]
        except ValueError as e:  # a backend that cannot serve the ranks
            print(f"train_vit_torch.py: {e}", file=sys.stderr)
            return 1
        where = f"mesh dp={args.dp} tp={args.tp}"
    else:
        losses = train(cfg, clips, vcfg, epochs=args.epochs,
                       device=args.device)
        where = "single device"
    print(f"steps={len(losses)} first_loss={losses[0]:.5f} "
          f"last_loss={losses[-1]:.5f} ({where})")
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    sys.exit(main())
