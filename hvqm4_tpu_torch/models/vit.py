"""ViT video encoder on decoded frames (the decode → RGB → resize → ViT path).

The port of `hvqm4_tpu/models/vit.py`. The parameters are frozen unless
the caller asks: a trainer calls `model.requires_grad_(True)`, and every op
of `forward` has its backward in bf16 on the CPU and the card. It keeps the
JAX model's dtype flow (`gelu`, `attention` and
`LayerNorm` are each held against the JAX model's part, because a fault in
them can hide inside the end-to-end bf16 spread):

- bf16 weights and activations; every product takes bf16 operands and
  accumulates in f32, and its result is rounded to bf16 where JAX casts it;
- q, k and v in bf16; the scores, `* scale` and the softmax in f32 (the
  scores are an f32 product of the bf16 q and k, never rounded to bf16),
  then the probabilities in bf16;
- LayerNorm in f32 with the population variance and eps inside the rsqrt,
  output in bf16; the final LayerNorm, then the mean over patches in f32;
- the tanh GELU, `jax.nn.gelu`'s default.

Attention is an explicit product and softmax, not
`scaled_dot_product_attention`, which would round the scores elsewhere.
The f32 score product relies on full-f32 matmuls on the card
(`torch.backends.cuda.matmul.allow_tf32` is False, PyTorch's default).

Parameter layout: `wq`, `wk`, `wv` (d, nh, hd) are stored as (d, nh·hd),
`wo` (nh, hd, d) as (nh·hd, d); `convert.vit_params_to_torch` carries the
JAX pytree across.

Tensor parallelism: `shard_vit_params` keeps, in place, one "tp" rank's
heads and MLP hidden units, as the JAX `shard_vit_params` places them over
the mesh. `forward` then reads its head count from the weights; the
replicated `h` enters the q/k/v and `w1` products through
`dist.copy_to_tp`, and the `wo` and `w2` partial products stay in f32 until
`dist.reduce_from_tp` has summed them, then round to bf16 once, as JAX's
f32 product followed by one cast does (an all-reduce in bf16 would round
twice).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.dist import axis_size, copy_to_tp, reduce_from_tp

BF16 = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    dim: int = 384
    depth: int = 6
    heads: int = 6
    mlp_ratio: int = 4

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


def gelu(x):
    """`jax.nn.gelu`'s default, the tanh form (torch's default is erf)."""
    return F.gelu(x, approximate="tanh")


def attention(q, k, v):
    """Softmax attention, (B, nh, P, hd) bf16 → bf16. The scores are the f32
    product of the bf16 q and k, never rounded to bf16; `* scale` and the
    softmax run in f32, the probabilities in bf16."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    att = (q.float() @ k.float().transpose(-1, -2)) * scale
    return torch.softmax(att, dim=-1).to(BF16) @ v


def _frozen(*shape, dtype=BF16) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype), requires_grad=False)


class LayerNorm(nn.Module):
    """f32 LayerNorm → bf16, as the JAX `_ln`."""

    def __init__(self, d: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(d), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(d), requires_grad=False)

    def forward(self, x):
        x = x.to(torch.float32)
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        return ((x - mu) * torch.rsqrt(var + 1e-6) * self.g + self.b).to(BF16)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d, mlp = cfg.dim, cfg.mlp_ratio * cfg.dim
        self.ln1 = LayerNorm(d)
        self.wq, self.wk, self.wv = (_frozen(d, d) for _ in range(3))
        self.wo = _frozen(d, d)
        self.ln2 = LayerNorm(d)
        self.w1, self.b1 = _frozen(d, mlp), _frozen(mlp)
        # b2 is carried but never added, as in the JAX model: its gradient
        # is zeros there and None here
        self.w2, self.b2 = _frozen(mlp, d), _frozen(d)


class ViT(nn.Module):
    """(B, H, W, 3) f32 in [0, 1] → (B, dim) f32 pooled embeddings."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d, patch_in = cfg.dim, 3 * cfg.patch_size ** 2
        self.patch_w = _frozen(patch_in, d)
        self.patch_b = _frozen(d)
        self.pos = _frozen(cfg.n_patches, d)
        self.ln_f = LayerNorm(d)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.tp_group = None  # set by `shard_vit_params`

    def forward(self, images):
        cfg = self.cfg
        B = images.shape[0]
        ps, hd, tp = cfg.patch_size, cfg.head_dim, self.tp_group
        g = cfg.image_size // ps
        # patch vectors ordered (py, px, c), as vit.py:91-92
        x = images.reshape(B, g, ps, g, ps, 3).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, g * g, ps * ps * 3).to(BF16)
        x = x @ self.patch_w + self.patch_b + self.pos

        def heads(t):  # (B, P, nh·hd) → (B, nh, P, hd), nh this rank's
            return t.reshape(B, -1, t.shape[-1] // hd, hd).transpose(1, 2)

        def enter(t):  # the replicated input of a sharded product
            return t if tp is None else copy_to_tp(t, tp)

        def leave(t, w):  # a sharded product, summed over the ranks
            if tp is None:
                return t @ w
            return reduce_from_tp(t.float() @ w.float(), tp).to(BF16)

        for blk in self.blocks:
            h = enter(blk.ln1(x))
            q, k, v = heads(h @ blk.wq), heads(h @ blk.wk), heads(h @ blk.wv)
            x = x + leave(attention(q, k, v).transpose(1, 2).flatten(2),
                          blk.wo)
            h = enter(blk.ln2(x))
            x = x + leave(gelu(h @ blk.w1 + blk.b1), blk.w2)
        return self.ln_f(x).to(torch.float32).mean(dim=1)


def shard_vit_params(model: ViT, mesh, axis: str = "tp") -> ViT:
    """Keep, in place, this rank's slice of the full `model` along the
    mesh's `axis` (the JAX `shard_vit_params`: `wq/wk/wv` over heads, `wo`
    over the same rows, `w1`, `b1` and `w2` over the MLP hidden width). Rank
    t of T keeps heads [t*nh/T, (t+1)*nh/T), which are head-major columns,
    and hidden units [t*m/T, (t+1)*m/T); the rest stays replicated. Call it
    before an optimizer takes the parameters. Returns `model`."""
    cfg = model.cfg
    size, t = axis_size(mesh, axis), mesh.get_local_rank(axis)
    mlp = cfg.mlp_ratio * cfg.dim
    if cfg.heads % size or mlp % size:
        raise ValueError(f"{cfg.heads} heads and an MLP width of {mlp} must "
                         f"both divide by mesh axis {axis!r} size {size}")
    if size == 1:
        return model
    w = cfg.heads // size * cfg.head_dim
    cols, hidden = slice(t * w, (t + 1) * w), slice(t * mlp // size,
                                                      (t + 1) * mlp // size)
    everything = slice(None)
    for blk in model.blocks:
        for name, index in (("wq", (everything, cols)),
                            ("wk", (everything, cols)),
                            ("wv", (everything, cols)), ("wo", cols),
                            ("w1", (everything, hidden)), ("b1", hidden),
                            ("w2", hidden)):
            p = getattr(blk, name)
            setattr(blk, name, nn.Parameter(p.detach()[index].clone(),
                                            requires_grad=p.requires_grad))
    model.tp_group = mesh.get_group(axis)
    return model


def init_vit(cfg: ViTConfig, generator: torch.Generator, device) -> ViT:
    """A ViT with weights ~ normal / sqrt(fan_in) in bf16, biases at zero
    and LayerNorms at ones and zeros, as the JAX `init_vit`. The weights are
    drawn on the CPU from `generator` and then moved, so they do not depend
    on the device; they are not the JAX package's (its PRNG differs)."""
    model = ViT(cfg)
    d, mlp = cfg.dim, cfg.mlp_ratio * cfg.dim

    def dense(p: nn.Parameter, fan_in: int) -> None:
        w = torch.randn(p.shape, generator=generator, dtype=torch.float32)
        p.copy_((w / math.sqrt(fan_in)).to(BF16))

    with torch.no_grad():
        dense(model.patch_w, 3 * cfg.patch_size ** 2)
        dense(model.pos, d)
        for blk in model.blocks:
            for p in (blk.wq, blk.wk, blk.wv, blk.wo, blk.w1):
                dense(p, d)
            dense(blk.w2, mlp)
    return model.to(device)
