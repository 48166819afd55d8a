"""The port's ViT against the JAX `vit_encode`, on the JAX weights carried
across by `convert.vit_params_to_torch`, and its numeric parts against the
JAX model's own.

End to end: both sides run bf16 weights and activations with f32 scores and
LayerNorms, but round at slightly different places (XLA's and PyTorch's
bf16 elementwise ops, sum order). Sound runs reach max abs 8.5e-3 at
`ViTConfig(32, 8, 64, 2, 4)` and 7.0e-3 at the default config (largest
|embedding| 2.9 and 3.3), cosine >= 0.999994. The bound is max abs 2e-2 and
cosine >= 0.9999 per embedding. It catches a wrong patch order, weight
layout or block, but not every fault of the dtype flow: planted faults read
  - unbiased variance: 0.027-0.030 at dim 64 (caught), 0.010-0.011 at
    dim 384 (not caught);
  - the erf GELU: <= 7.9e-3, and scores rounded to bf16: <= 1.0e-2 (not
    caught at either size: both sit inside the spread of sound runs).
So each of these three is held by a test of its own part against the JAX
model's, and each planted fault is shown to fail that test.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvqm4_tpu.models import vit as jvit
import torch.nn.functional as F

from hvqm4_tpu_torch.convert import vit_params_to_torch
from hvqm4_tpu_torch.models import vit as tvit
from hvqm4_tpu_torch.models.vit import LayerNorm, ViT, ViTConfig, init_vit

torch.set_num_threads(1)


def _jax_params(cfg: jvit.ViTConfig) -> dict:
    return jax.tree_util.tree_map(np.asarray,
                                  jvit.init_vit(cfg, jax.random.key(0)))


def _leaves(params: dict):
    """(state-dict key, numpy leaf) for every leaf of the JAX pytree."""
    for k, a in params.items():
        if k == "blocks":
            for i, blk in enumerate(a):
                for bk, b in blk.items():
                    if isinstance(b, dict):
                        yield from ((f"blocks.{i}.{bk}.{x}", b[x]) for x in b)
                    else:
                        yield f"blocks.{i}.{bk}", b
        elif isinstance(a, dict):
            yield from ((f"{k}.{x}", a[x]) for x in a)
        else:
            yield k, a


def test_config_matches_jax():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(ViTConfig) == fields(jvit.ViTConfig)
    for args in [(), (32, 8, 64, 2, 4)]:
        t, j = ViTConfig(*args), jvit.ViTConfig(*args)
        assert (t.n_patches, t.head_dim) == (j.n_patches, j.head_dim)


def test_params_round_trip_every_leaf():
    params = _jax_params(jvit.ViTConfig(32, 8, 64, 2, 4))
    sd = vit_params_to_torch(params, "cpu")
    leaves = dict(_leaves(params))
    assert sorted(sd) == sorted(leaves)
    for key, a in leaves.items():
        t = sd[key]
        want = {"bfloat16": torch.bfloat16, "float32": torch.float32}
        assert t.dtype == want[a.dtype.name], key
        assert t.numel() == a.size and t.is_contiguous()
        back = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
        raw = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        assert np.array_equal(back.reshape(a.shape), raw), key
    assert tuple(sd["blocks.0.wq"].shape) == (64, 64)  # (d, nh·hd)
    assert tuple(sd["blocks.0.wo"].shape) == (64, 64)  # (nh·hd, d)
    ViT(ViTConfig(32, 8, 64, 2, 4)).load_state_dict(sd)  # every key, strict


@pytest.mark.parametrize("args,batch", [((32, 8, 64, 2, 4), 3), ((), 1)])
def test_vit_matches_jax(args, batch):
    jcfg, cfg = jvit.ViTConfig(*args), ViTConfig(*args)
    params = _jax_params(jcfg)
    model = ViT(cfg)
    model.load_state_dict(vit_params_to_torch(params, "cpu"))
    imgs = np.random.default_rng(batch).random(
        (batch, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jvit.vit_encode(p, jcfg, x))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(imgs)))
    got = model(torch.from_numpy(imgs))
    assert got.dtype == torch.float32 and got.shape == (batch, cfg.dim)
    got = got.numpy()
    assert np.abs(got - want).max() <= 2e-2
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert (cos >= 0.9999).all(), cos


def test_init_vit_is_deterministic():
    cfg = ViTConfig(32, 8, 64, 2, 4)

    def init(seed):
        return init_vit(cfg, torch.Generator().manual_seed(seed),
                        "cpu").state_dict()

    a, b, c = init(0), init(0), init(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["patch_w"], c["patch_w"])
    assert a["patch_w"].dtype == torch.bfloat16
    assert a["ln_f.g"].dtype == torch.float32
    assert torch.equal(a["blocks.1.ln2.g"], torch.ones(64))
    assert torch.equal(a["blocks.1.b1"], torch.zeros(256, dtype=torch.bfloat16))
    # normal / sqrt(fan_in): the patch weights' spread is 1/sqrt(3·8·8)
    std = float(a["patch_w"].float().std())
    assert abs(std * np.sqrt(3 * 8 * 8) - 1) < 0.05


# The numeric parts, each against the JAX model's. A check returns whether
# the port agrees, so that a planted fault can be shown to fail it.

def _bf16(rng, shape, scale):
    """Random bf16 values as (jax array, torch tensor) with equal bits."""
    a = (rng.standard_normal(shape) * scale).astype(jnp.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)


def _rel_err(got: torch.Tensor, want) -> float:
    """mean |got - want| / mean |want|, in f32."""
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).mean() / np.abs(want).mean())


def _layernorm_agrees(d: int) -> bool:
    """`LayerNorm` against `_ln` on bf16 input, random gain and bias. Sound:
    1.3e-9 at d=384 (one element in 75,000 a bf16 ulp apart), 0 at d=64;
    the unbiased variance: 1.3e-3 at d=384, 7.8e-3 at d=64."""
    rng = np.random.default_rng(d)
    xj, xt = _bf16(rng, (4, 196, d), 3.0)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    want = jvit._ln(xj + 0.5, {"g": jnp.asarray(g), "b": jnp.asarray(b)})
    ln = LayerNorm(d)
    ln.g.copy_(torch.from_numpy(g))
    ln.b.copy_(torch.from_numpy(b))
    got = ln(xt + 0.5)
    return got.dtype == torch.bfloat16 and _rel_err(got, want) <= 1e-5


def _gelu_agrees() -> bool:
    """`gelu` against `jax.nn.gelu` in f32 on [-8, 8]. Sound: max abs
    5.8e-7; the erf GELU: 4.7e-4."""
    xs = np.linspace(-8, 8, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(xs)))
    got = tvit.gelu(torch.from_numpy(xs)).numpy()
    return float(np.abs(got - want).max()) <= 1e-5


def _jax_attention(q, k, v):
    """`vit_encode`'s attention (vit.py:108-113) on (B, P, nh, hd) bf16."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    att = jnp.einsum("bqnh,bknh->bnqk", q, k,
                     preferred_element_type=jnp.float32) * scale
    att = jax.nn.softmax(att, axis=-1).astype(jnp.bfloat16)
    return jnp.einsum("bnqk,bknh->bqnh", att, v,
                      preferred_element_type=jnp.float32).astype(jnp.bfloat16)


def _attention_agrees() -> bool:
    """`attention` against `_jax_attention` with raw scores of spread 72,
    where a bf16 ulp (0.5) moves the softmax. Sound: 1.3e-6; scores rounded
    to bf16: 8.2e-3."""
    rng = np.random.default_rng(7)
    (qj, qt), (kj, kt), (vj, vt) = (_bf16(rng, (2, 196, 2, 64), 3.0)
                                    for _ in range(3))
    got = tvit.attention(*(t.transpose(1, 2) for t in (qt, kt, vt)))
    got = got.transpose(1, 2)
    return (got.dtype == torch.bfloat16
            and _rel_err(got, _jax_attention(qj, kj, vj)) <= 1e-4)


@pytest.mark.parametrize("d", [64, 384])
def test_layernorm_matches_jax(d):
    assert _layernorm_agrees(d)


def test_gelu_matches_jax():
    assert _gelu_agrees()


def test_attention_matches_jax():
    assert _attention_agrees()


def _ln_unbiased(self, x):
    x = x.to(torch.float32)
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=True)
    return ((x - mu) * torch.rsqrt(var + 1e-6) * self.g + self.b).to(torch.bfloat16)


def _attention_bf16_scores(q, k, v):
    att = (q @ k.transpose(-1, -2)).float() / math.sqrt(q.shape[-1])
    return torch.softmax(att, dim=-1).to(torch.bfloat16) @ v


@pytest.mark.parametrize("fault", ["unbiased variance", "erf gelu",
                                   "bf16 scores"])
def test_planted_fault_fails_its_check(fault, monkeypatch):
    if fault == "unbiased variance":
        monkeypatch.setattr(LayerNorm, "forward", _ln_unbiased)
        assert not _layernorm_agrees(384)
    elif fault == "erf gelu":
        monkeypatch.setattr(tvit, "gelu", F.gelu)
        assert not _gelu_agrees()
    else:
        monkeypatch.setattr(tvit, "attention", _attention_bf16_scores)
        assert not _attention_agrees()
