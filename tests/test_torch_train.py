"""The training path of the port against the JAX package's, on the CPU.

`examples/train_vit_torch.py` trains the mean-RGB probe with PyTorch
autograd over the port's ViT and `torch.optim.Adam`; the reference is
`examples/train_vit.py`: `jax.value_and_grad` over `vit_encode` and
`optax.adam`. Weights cross through `convert.probe_params_to_torch`.

The head starts at zeros in both examples, so at the first step every ViT
gradient is exactly 0 in both frameworks: a one-step parity test would not
reach the backward pass. So the gradients are compared at a random non-zero
head, and the optimizer over several steps.

Both sides run bf16 weights and activations and round in different places,
so the bounds are tolerances, each beside the worst value sound runs gave
on the CPU. `b2` is carried but never added by either model: JAX's gradient for
it is zeros and the port's `.grad` is None, which counts as zeros.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from examples.train_vit import train as jax_train
from examples.train_vit_torch import (loss_fn, make_optimizer, make_probe,
                                      train, train_step)
from hvqm4_tpu.config import SeqConfig as JaxSeqConfig
from hvqm4_tpu.models import vit as jvit
from hvqm4_tpu_torch import serve
from hvqm4_tpu_torch.config import SeqConfig
from hvqm4_tpu_torch.convert import probe_params_to_torch, vit_params_to_torch
from hvqm4_tpu_torch.models.vit import ViTConfig
from hvqm4_tpu_torch.pipeline import VideoEmbedPipeline
from tools.encoder import make_clip

torch.set_num_threads(1)

ARGS = (32, 8, 64, 2, 2)  # image, patch, dim, depth, heads


def _jax_loss(jcfg):
    """`examples/train_vit.py`'s loss (its `loss_fn`, lines 58-63)."""
    def loss(params, images, weight):
        emb = jvit.vit_encode(params["vit"], jcfg, images)
        pred = emb @ params["head"]["w"] + params["head"]["b"]
        target = images.mean(axis=(1, 2))
        per = ((pred - target) ** 2).mean(axis=1)
        return (per * weight).sum() / jnp.maximum(weight.sum(), 1.0)
    return loss


def _probe(seed: int, head_scale: float) -> dict:
    """The probe's pytree as numpy: the JAX ViT from `seed` and a head of
    normal * `head_scale` (zeros at 0)."""
    dim = ARGS[2]
    rng = np.random.default_rng(seed)
    return {"vit": jax.tree_util.tree_map(
                np.asarray, jvit.init_vit(jvit.ViTConfig(*ARGS),
                                          jax.random.key(seed))),
            "head": {"w": (head_scale * rng.standard_normal((dim, 3)))
                     .astype(np.float32),
                     "b": (head_scale * rng.standard_normal(3))
                     .astype(np.float32)}}


def _batch(seed: int):
    images = np.random.default_rng(seed).random((4, 32, 32, 3), np.float32)
    return images, np.array([1.0, 1.0, 0.0, 1.0], np.float32)


def _as_numpy(t) -> np.ndarray:
    return t.detach().float().numpy()


def test_probe_params_to_torch():
    params = _probe(0, 0.1)
    sd, w, b = probe_params_to_torch(params, "cpu")
    assert sorted(sd) == sorted(vit_params_to_torch(params["vit"], "cpu"))
    assert w.dtype == b.dtype == torch.float32
    assert tuple(w.shape) == (ARGS[2], 3) and tuple(b.shape) == (3,)
    assert np.array_equal(w.numpy(), params["head"]["w"])
    assert np.array_equal(b.numpy(), params["head"]["b"])
    w.add_(1.0)  # the tensors own their memory
    assert not np.array_equal(w.numpy(), params["head"]["w"])


@pytest.mark.parametrize("seed", [0, 1])
def test_gradients_match_jax(seed):
    """At a random non-zero head, every ViT leaf's gradient against
    `jax.value_and_grad` of the same loss: relative L2 <= 0.1 (worst measured
    0.028, the last block's wk); the head's gradient within 1e-2 max abs
    (worst measured 5.2e-3); the losses within 1e-3 relative (worst measured
    3.2e-4)."""
    jcfg = jvit.ViTConfig(*ARGS)
    params = _probe(seed, 0.1)
    images, weight = _batch(seed + 10)
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_loss(jcfg)))(
        jax.tree_util.tree_map(jnp.asarray, params), images, weight)
    jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    want = {k: _as_numpy(v) for k, v in
            vit_params_to_torch(jgrads["vit"], "cpu").items()}

    model, (w, b) = make_probe(ViTConfig(*ARGS), "cpu",
                               params=probe_params_to_torch(params, "cpu"))
    loss = loss_fn(model, w, b, torch.from_numpy(images),
                   torch.from_numpy(weight))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-3 * abs(float(jloss))
    worst = 0.0
    for name, p in model.named_parameters():
        if name.endswith(".b2"):
            assert p.grad is None and not want[name].any(), name
            continue
        g = _as_numpy(p.grad)
        rel = np.linalg.norm(g - want[name]) / np.linalg.norm(want[name])
        assert rel <= 0.1, (name, rel)
        worst = max(worst, rel)
    assert worst > 0  # the two backward passes are not the same code
    for got, key in ((w, "w"), (b, "b")):
        assert np.abs(_as_numpy(got.grad) - jgrads["head"][key]).max() \
            <= 1e-2


def test_adam_trajectory_matches_optax():
    """Four steps from a zero head on four batches: `train_step` with
    `make_optimizer` (Adam, optax's defaults) against `optax.adam(1e-3)`.
    Losses within 2e-2 relative (worst measured 1.7e-4); every parameter
    within 1.6e-2 max abs after the four steps (worst measured 2.9e-3, one or
    two bf16 ulps at the weights' size)."""
    jcfg = jvit.ViTConfig(*ARGS)
    params = _probe(2, 0.0)
    batches = [_batch(20 + i) for i in range(4)]
    opt = optax.adam(1e-3)
    loss_of = _jax_loss(jcfg)

    @jax.jit
    def step(p, o, images, weight):
        loss, grads = jax.value_and_grad(loss_of)(p, images, weight)
        updates, o = opt.update(grads, o)
        return optax.apply_updates(p, updates), o, loss

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jo = opt.init(jp)
    jlosses = []
    for images, weight in batches:
        jp, jo, loss = step(jp, jo, images, weight)
        jlosses.append(float(loss))

    model, head = make_probe(ViTConfig(*ARGS), "cpu",
                             params=probe_params_to_torch(params, "cpu"))
    topt = make_optimizer(model, head)
    tlosses = [float(train_step(model, head, topt, torch.from_numpy(i),
                                torch.from_numpy(w))) for i, w in batches]
    for t, j in zip(tlosses, jlosses):
        assert abs(t - j) <= 2e-2 * abs(j), (tlosses, jlosses)
    assert tlosses[-1] < tlosses[0]
    jp = jax.tree_util.tree_map(np.asarray, jp)
    want = vit_params_to_torch(jp["vit"], "cpu")
    sd = model.state_dict()
    diffs = {k: float(np.abs(_as_numpy(sd[k]) - _as_numpy(v)).max())
             for k, v in want.items()}
    for t, key in zip(head, ("w", "b")):
        diffs["head." + key] = float(np.abs(_as_numpy(t)
                                            - jp["head"][key]).max())
    assert max(diffs.values()) <= 1.6e-2, diffs
    assert diffs["blocks.1.wq"] > 0 or diffs["blocks.1.wk"] > 0


def test_train_matches_jax_train():
    """The port's `train` on its CPU `FrameBatchLoader` against
    `examples/train_vit.py::train` on the JAX loader, on the same clips
    from the same weights (the JAX `init_vit` of seed 0 carried across):
    loss histories of the same length within 2e-2 relative (worst measured
    1.6e-2, at the smallest loss, 8e-4: the resize and the bf16 ViT
    differ in rounding, which weighs most there), and the loss falls. The
    mirror of `tests/test_train_example.py::test_train_single_device`."""
    clips = [make_clip(JaxSeqConfig(64, 48), ["IPB"], seed=70 + s)
             for s in range(2)]
    jcfg = jvit.ViTConfig(*ARGS)
    want = jax_train(JaxSeqConfig(64, 48), clips, jcfg, epochs=3, lr=3e-3)
    params = {"vit": jax.tree_util.tree_map(
                  np.asarray, jvit.init_vit(jcfg, jax.random.key(0))),
              "head": {"w": np.zeros((ARGS[2], 3), np.float32),
                       "b": np.zeros(3, np.float32)}}
    got = train(SeqConfig(64, 48), clips, ViTConfig(*ARGS), epochs=3,
                lr=3e-3, device="cpu",
                params=probe_params_to_torch(params, "cpu"))
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert abs(g - w) <= 2e-2 * abs(w), (got, want)
    assert got[-1] < got[0]


def test_train_draws_from_seed():
    """Without `params` the ViT comes from `seed` (`init_vit`) and the head
    from zeros: the same seed gives the same history, another seed
    another."""
    clips = [make_clip(JaxSeqConfig(32, 16), ["IP"], seed=5)]
    cfg, vcfg = SeqConfig(32, 16), ViTConfig(16, 8, 32, 1, 2)
    a, b = (train(cfg, clips, vcfg, epochs=2, seed=0, device="cpu")
            for _ in range(2))
    c = train(cfg, clips, vcfg, epochs=2, seed=1, device="cpu")
    assert a == b and len(a) == 4 and a != c
    # the first step's loss: zero head, so mean(target^2) over the frames,
    # whatever the ViT
    assert a[0] == c[0]


def test_inference_paths_stay_frozen():
    """`VideoEmbedPipeline` and `DecodeServer`'s EMBED reply leave every ViT
    parameter with requires_grad False; the caller's grad mode is its
    own."""
    clip = make_clip(JaxSeqConfig(32, 16), ["IPB"], seed=9)
    vcfg = ViTConfig(16, 8, 32, 1, 2)
    pipe = VideoEmbedPipeline(SeqConfig(32, 16), [clip, clip], vcfg,
                              device="cpu")
    emb, _metas, valid = next(pipe.run())
    assert valid == [True, True] and not emb.requires_grad
    srv = serve.DecodeServer(("127.0.0.1", 0), device="cpu", vit_cfg=vcfg)
    try:
        assert len(srv.decode(clip, serve.MODE_EMBED)) == 3
        models = [pipe.model, srv._vit[1]]
    finally:
        srv.server_close()
    for model in models:
        assert not any(p.requires_grad for p in model.parameters())
    assert torch.is_grad_enabled() and not torch.is_inference_mode_enabled()
