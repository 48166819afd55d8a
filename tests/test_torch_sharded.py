"""The port's sharded path against the JAX package's, on the CPU.

Decode: one `MultiStreamDecoder(sharding=StreamShard(s, S), device="cpu")`
per shard, in one process, against JAX's `MultiStreamDecoder` sharded over
a "dp" mesh of conftest's virtual CPU devices (`shard_streams`), and the C
oracle. The tensor-parallel ViT, training on a dp x tp mesh and
`dryrun_multichip` run their ranks as processes through
`parallel.dist.launch` on `gloo`; the rank functions are in
`tests/torch_sharded_ranks.py`, which imports no JAX.

Bounds: decode is exact. The ViT's embeddings keep the pipeline tests'
bounds (max abs 2e-2, cosine 0.9999) and its gradients
tests/test_torch_train.py's (relative L2 0.1 a leaf, the head's 1e-2 max
abs), with the worst values measured here beside them.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import __graft_entry__ as graft
from examples.train_vit import train as jax_train
from examples.train_vit_torch import loss_fn, train
from hvqm4_tpu.config import SeqConfig as JaxSeqConfig
from hvqm4_tpu.models import vit as jvit
from hvqm4_tpu.native import NativePlanner as JaxNativePlanner
from hvqm4_tpu.parallel import multistream as jms
from hvqm4_tpu_torch import entry as tentry
from hvqm4_tpu_torch.config import SeqConfig
from hvqm4_tpu_torch.convert import probe_params_to_torch, vit_params_to_torch
from hvqm4_tpu_torch.models.vit import ViT, ViTConfig, shard_vit_params
from hvqm4_tpu_torch.parallel import dist as tdist
from hvqm4_tpu_torch.parallel import multistream as tms
from hvqm4_tpu_torch.pipeline import VideoEmbedPipeline
from tools.encoder import make_clip

from .conftest import run_oracle
from .test_torch_arena import corrupt_second_block
from .torch_sharded_ranks import failing_rank, mesh_rank, vit_rank

CFG = SeqConfig(64, 48)
JCFG = JaxSeqConfig(64, 48)
# 8 streams of unequal lengths and GOP shapes, so that some shards end
# before others and trailing steps hold filler slots
GOPS = [["IPBPB", "IPP"], ["IPB"], ["IP", "IPB"], ["IPBB"],
        ["IPP", "IP"], ["I"], ["IPBPB"], ["IP", "IP"]]


@pytest.fixture(scope="module")
def clips():
    return [make_clip(JCFG, g, seed=200 + s) for s, g in enumerate(GOPS)]


def _jax_steps(clips, shards: int, k: int) -> list:
    mesh = Mesh(np.array(jax.devices()[:shards]), ("dp",))
    ms = jms.MultiStreamDecoder(JCFG, clips, planner_factory=JaxNativePlanner,
                                sharding=jms.shard_streams(mesh, "dp"),
                                steps_per_dispatch=k)
    return [([np.asarray(p) for p in frames], valid)
            for frames, _m, valid in ms.run_pipelined()]


@pytest.mark.parametrize("shards,k", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_sharded_decode_matches_jax_and_oracle(clips, oracle_bin, tmp_path,
                                               shards, k):
    """Every step of every shard: frames and valids equal, exactly, the
    shard's slice of the JAX decoder's step; the same number of steps on
    every shard; each stream's valid frames, in order, the oracle's."""
    want = _jax_steps(clips, shards, k)
    n_local = len(clips) // shards
    got = [[] for _ in clips]
    for s in range(shards):
        ms = tms.MultiStreamDecoder(CFG, clips, "cpu", steps_per_dispatch=k,
                                    sharding=tms.StreamShard(s, shards))
        assert ms.n == n_local
        steps = list(ms.run_pipelined())
        assert len(steps) == len(want)
        lo = s * n_local
        for (frames, _m, valid), (jframes, jvalid) in zip(steps, want):
            assert valid == jvalid[lo:lo + n_local]
            for p, jp in zip(frames, jframes):
                assert np.array_equal(p.numpy(), jp[lo:lo + n_local])
            for j, ok in enumerate(valid):
                if ok:
                    got[lo + j].append(b"".join(p[j].numpy().tobytes()
                                                for p in frames))
    for clip, frames in zip(clips, got):
        assert b"".join(frames) == run_oracle(oracle_bin, clip, tmp_path)


@pytest.mark.parametrize("k", [1, 2])
def test_shard_staging_rows_equal_the_unsharded_decoders(clips, k):
    """A shard plans and packs exactly what an unsharded decoder of its own
    streams does, its own tiers included (no tier is shared across shards,
    unlike the JAX decoder's); once its streams have ended while others go
    on, its steps are filler with every frame invalid."""
    shards = 4
    for s in range(shards):
        ms = tms.MultiStreamDecoder(CFG, clips, "cpu", steps_per_dispatch=k,
                                    sharding=tms.StreamShard(s, shards))
        alone = tms.MultiStreamDecoder(CFG, clips[2 * s:2 * s + 2], "cpu",
                                       steps_per_dispatch=k)
        steps = 0
        while ms._more():
            buf, _metas, valid = ms.plan_step()
            rows = [valid] if k == 1 else valid
            if any(alone.active):
                abuf, _am, avalid = alone.plan_step()
                assert valid == avalid
                want, got = (alone.snapshot_step(abuf),
                             ms.snapshot_step(buf))
                assert got["variant"] == want["variant"]
                for g in ("u8", "u32"):
                    assert np.array_equal(got["staging"][g],
                                          want["staging"][g])
            else:
                assert not any(v for row in rows for v in row)
            steps += 1
        assert not any(alone.active)
        longest = max(sum(map(len, gops)) for gops in GOPS)
        assert steps == -(-longest // k)


@pytest.mark.parametrize("k", [1, 2])
def test_ranks_step_alike_when_a_stream_fails_in_a_planner(k):
    """The longest stream fails in shard 1's planner at its third frame:
    shard 0 cannot see that, so both shards walk its records and yield the
    same steps, which the trainer's collectives need. The JAX decoder stops
    after the other streams end; the port's first steps equal its slices
    exactly, and the steps it adds have every frame invalid."""
    gops = [["IPB"], ["IPBPB"], ["IP"], ["IP", "IPBPBPB"]]
    clips = [make_clip(JCFG, g, seed=500 + s) for s, g in enumerate(gops)]
    clips[3] = corrupt_second_block(clips[3])
    want = _jax_steps(clips, 2, k)
    runs = [list(tms.MultiStreamDecoder(
        CFG, clips, "cpu", steps_per_dispatch=k,
        sharding=tms.StreamShard(s, 2)).run_pipelined()) for s in range(2)]
    assert len(runs[0]) == len(runs[1]) == 9 > len(want) == 5
    for s, steps in enumerate(runs):
        for (frames, _m, valid), (jframes, jvalid) in zip(steps, want):
            assert valid == jvalid[2 * s:2 * s + 2]
            for p, jp in zip(frames, jframes):
                assert np.array_equal(p.numpy(), jp[2 * s:2 * s + 2])
        assert not any(v for _f, _m, valid in steps[len(want):]
                       for v in valid)


def test_divisibility_error_matches_jax(clips):
    mesh = Mesh(np.array(jax.devices()[:3]), ("dp",))
    with pytest.raises(ValueError) as jerr:
        jms.MultiStreamDecoder(JCFG, clips, planner_factory=JaxNativePlanner,
                               sharding=jms.shard_streams(mesh, "dp"))
    with pytest.raises(ValueError) as terr:
        tms.MultiStreamDecoder(CFG, clips, "cpu",
                               sharding=tms.StreamShard(0, 3))
    assert str(terr.value) == str(jerr.value)
    assert "8 streams not divisible by mesh axis 'dp' size 3" in str(
        terr.value)


# -- the tensor-parallel ViT: 2 gloo ranks ----------------------------------

VIT_ARGS = (32, 8, 128, 2, 4)  # image, patch, dim, depth, heads


@pytest.fixture(scope="module")
def tp_run():
    """The JAX ViT of seed 3 on a (dp=1, tp=2) mesh, the port's unsharded
    model and the port's two tp ranks on the same weights and images; and
    the gradients of the probe's loss at a random head."""
    jcfg = jvit.ViTConfig(*VIT_ARGS)
    params = jax.tree_util.tree_map(np.asarray,
                                    jvit.init_vit(jcfg, jax.random.key(3)))
    rng = np.random.default_rng(4)
    images = rng.random((4, 32, 32, 3), np.float32)
    weight = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    head = ((0.1 * rng.standard_normal((VIT_ARGS[2], 3))).astype(np.float32),
            (0.1 * rng.standard_normal(3)).astype(np.float32))
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("dp", "tp"))
    with mesh:
        jemb = np.asarray(jax.jit(jvit.vit_encode, static_argnums=1)(
            jvit.shard_vit_params(params, mesh, "tp"), jcfg, images))

    vcfg = ViTConfig(*VIT_ARGS)
    sd = vit_params_to_torch(params, "cpu")
    model = ViT(vcfg)
    model.load_state_dict(sd)
    model.requires_grad_(True)
    x = torch.from_numpy(images)
    with torch.no_grad():
        emb = model(x).numpy()
    w, b = (torch.from_numpy(a).requires_grad_(True) for a in head)
    loss_fn(model, w, b, x, torch.from_numpy(weight)).backward()
    grads = {n: p.grad.float().numpy() for n, p in model.named_parameters()
             if p.grad is not None}
    grads.update({"head.w": w.grad.numpy(), "head.b": b.grad.numpy()})
    ranks = tdist.launch(vit_rank, 2, vcfg, sd, head, images, weight,
                         device="cpu", backend="gloo")
    return {"jax": jemb, "full": emb, "grads": grads, "ranks": ranks}


def _close(a, b):
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                            * np.linalg.norm(b, axis=1))
    return float(np.abs(a - b).max()), float(cos.min())


def test_tp_embeddings_match_unsharded_and_jax(tp_run):
    """Both ranks give the same (B, dim) embeddings, within max abs 2e-2
    and cosine 0.9999 of the unsharded port model (measured 0.0: the f32
    partial sums and the unsharded bf16 products round alike here) and of
    JAX's tp `vit_encode` (measured 7.6e-3, cosine 0.999997)."""
    a, b = (r["emb"] for r in tp_run["ranks"])
    assert np.array_equal(a, b) and a.shape == (4, VIT_ARGS[2])
    for want in (tp_run["full"], tp_run["jax"]):
        err, cos = _close(a, want)
        assert err <= 2e-2 and cos >= 0.9999, (err, cos)


def test_tp_gradients_gathered_match_unsharded(tp_run):
    """Each rank's gradients of its slices, gathered along the sharded
    axes, against the unsharded model's: relative L2 <= 0.1 a leaf (worst
    measured 6.1e-3, the last block's wk), the head's within 1e-2 max abs
    (measured 0.0); the replicated leaves equal on both ranks."""
    g0, g1 = (r["grads"] for r in tp_run["ranks"])
    full = tp_run["grads"]
    assert set(g0) == set(g1) == set(full)
    worst = 0.0
    for name, want in full.items():
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("blocks.") and leaf in ("wq", "wk", "wv", "w1",
                                                   "b1"):
            got = np.concatenate([g0[name], g1[name]], axis=-1)
        elif name.startswith("blocks.") and leaf in ("wo", "w2"):
            got = np.concatenate([g0[name], g1[name]], axis=0)
        else:
            assert np.array_equal(g0[name], g1[name]), name
            got = g0[name]
        assert got.shape == want.shape, name
        if name.startswith("head."):
            assert np.abs(got - want).max() <= 1e-2, name
            continue
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 0.1, (name, rel)
        worst = max(worst, rel)
    assert worst > 0


# -- a dp=2 x tp=2 mesh: 4 gloo ranks ----------------------------------------

TRAIN_ARGS = (32, 8, 64, 2, 2)


def _probe(seed: int):
    jcfg = jvit.ViTConfig(*TRAIN_ARGS)
    return {"vit": jax.tree_util.tree_map(
                np.asarray, jvit.init_vit(jcfg, jax.random.key(seed))),
            "head": {"w": np.zeros((TRAIN_ARGS[2], 3), np.float32),
                     "b": np.zeros(3, np.float32)}}


@pytest.mark.parametrize("gops", [
    [["IPB", "IP"]] * 4,
    # shard 0 runs on after both streams of shard 1 have ended: the last
    # steps hold 2 valid frames on one "dp" shard and none on the other
    [["IPBPB", "IP"], ["IPBP", "IPP"], ["IP"], ["IPB"]]],
    ids=["equal", "unequal"])
def test_mesh_training_matches_jax_and_single_device(gops):
    """`train(mesh=dp 2 x tp 2)` on 4 gloo ranks: the same loss history on
    every rank, within 1e-3 relative over the first three steps of the
    port's single-device `train` on the same weights and of
    `examples/train_vit.py::train` on a JAX dp 2 x tp 2 mesh (worst
    measured 1.0e-4 and 4.2e-4), and within 2e-2 after, where Adam has
    parted the runs and the losses are small (test_torch_train.py's bound
    for `train()`; worst measured 5.3e-3 and 6.0e-3). In the unequal case the
    last steps' weights are [1, 1] on one shard and [0, 0] on the other: the
    global weighted mean is the valid frames' mean there, where DDP's mean
    of the shards' means would be half of it. The same ranks run
    `VideoEmbedPipeline(mesh=…)`: each rank's embeddings a step within
    the pipeline tests' bounds of the unsharded pipeline's on its own
    streams. No rank imports JAX or the JAX package."""
    clips = [make_clip(JCFG, g, seed=300 + s) for s, g in enumerate(gops)]
    vcfg = ViTConfig(*TRAIN_ARGS)
    params = _probe(0)
    kwargs = {"epochs": 1, "lr": 3e-3,
              "params": probe_params_to_torch(params, "cpu")}
    ranks = tdist.launch(mesh_rank, 4, 2, 2, CFG, clips, vcfg, kwargs,
                         device="cpu", backend="gloo")
    single = train(CFG, clips, vcfg, device="cpu", **kwargs)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    with mesh:
        want = jax_train(JCFG, clips, jvit.ViTConfig(*TRAIN_ARGS), epochs=1,
                         lr=3e-3, mesh=mesh)
    got = ranks[0]["losses"]
    assert all(r["losses"] == got and r["leaked"] == [] for r in ranks)
    assert len(got) == len(single) == len(want) == max(
        sum(map(len, g)) for g in gops)
    for t, (g, s, w) in enumerate(zip(got, single, want)):
        bound = 1e-3 if t < 3 else 2e-2
        assert abs(g - s) <= bound * abs(s), (t, got, single)
        assert abs(g - w) <= bound * abs(w), (t, got, want)

    for rank, r in enumerate(ranks):
        lo = (rank // 2) * 2
        alone = VideoEmbedPipeline(CFG, clips[lo:lo + 2], vcfg, device="cpu")
        ref = [(e.numpy(), v) for e, _m, v in alone.run()]
        assert len(r["pipeline"]) == len(got)
        for (emb, valid), (want_emb, want_valid) in zip(r["pipeline"], ref):
            assert valid == want_valid
            err, cos = _close(emb, want_emb)
            assert err <= 2e-2 and cos >= 0.9999, (rank, err, cos)
        # steps after this shard's streams ended: filler, every frame invalid
        assert not any(v for _e, valid in r["pipeline"][len(ref):]
                       for v in valid)


# -- launch, backends, shard_vit_params' refusals ---------------------------

def test_launch_raises_a_ranks_exception_and_stops_the_others():
    with pytest.raises(ValueError, match="rank 1 fails on purpose") as err:
        tdist.launch(failing_rank, 3, 1, device="cpu", backend="gloo")
    assert isinstance(err.value.__cause__, tdist.RankError)
    assert "failing_rank" in str(err.value.__cause__)


@pytest.mark.parametrize("device,world,backend,msg", [
    ("cpu", 2, "nccl", "backend 'nccl' needs a CUDA card per rank: 2 ranks "
                       "on 0 card(s) of cpu"),
    ("cpu", 2, "mpi", "unsupported backend 'mpi'"),
    ("cuda", 1, "gloo", "device 'cuda' requested but CUDA is not available"),
])
def test_check_backend_refuses_in_one_line(device, world, backend, msg):
    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((ValueError, RuntimeError)) as err:
        tdist.launch(failing_rank, world, 0, device=device, backend=backend)
    assert msg in str(err.value) and "\n" not in str(err.value)


class _Mesh:
    """The three calls `shard_vit_params` makes of a `DeviceMesh`."""
    mesh_dim_names = ("dp", "tp")

    def __init__(self, tp):
        self.tp = tp

    def size(self, dim):
        return (1, self.tp)[dim]

    def get_local_rank(self, axis):
        return 0


def test_shard_vit_params_refuses_what_does_not_divide():
    with pytest.raises(ValueError, match="4 heads and an MLP width of 128 "
                                         "must both divide by mesh axis "
                                         "'tp' size 3"):
        shard_vit_params(ViT(ViTConfig(16, 8, 32, 1, 4)), _Mesh(3))
    model = ViT(ViTConfig(16, 8, 32, 1, 4))
    assert shard_vit_params(model, _Mesh(1)) is model
    assert model.tp_group is None and model.blocks[0].wq.shape == (32, 32)


# -- the entry points -------------------------------------------------------

def test_entry_step_matches_jax_entry():
    """`entry("cpu")` draws the JAX entry's arguments and its step gives
    the JAX step's frames and state, exactly."""
    jfn, jargs = graft.entry()
    fn, args = tentry.entry("cpu")
    for a, b in zip(graft._example_step_args(JCFG, 2),
                    tentry._example_step_args(CFG, 2)):
        for x, y in zip(*(jax.tree_util.tree_leaves(t) for t in (a, b))):
            assert np.array_equal(x, y)
    frames, nest, prev, last = jax.jit(jfn)(*jargs)
    tframes, tnest, tprev, tlast = fn(*args)
    for want, got in zip([*frames, nest, *prev, *last],
                         [*tframes, tnest, *tprev, *tlast]):
        assert np.array_equal(np.asarray(want), got.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tentry.entry()


def test_dryrun_multichip_four_gloo_ranks(capsys):
    tentry.dryrun_multichip(4, device="cpu", backend="gloo", budget_s=200)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip: mesh dp=2 tp=2 on cpu, 2 "
                           "streams, ")
    assert "bit-exact against the C oracle (K=1 and K=2)" in line
    assert "embeddings (1, 128) a rank" in line
