"""The port's entry points: the counterpart of `__graft_entry__.py`.

- `entry(device)` → (fn, example_args): one lock-step multi-stream frame
  decode at 640x480 with n=2 (`multi_frame_step`), its plans random but
  in range and its state on `device`.
- `dryrun_multichip(n_devices, device, backend, budget_s)`: the sharded
  path on n ranks in a ("dp", "tp") mesh, tp=2 where n is even. Whole
  I/P/B clips of 2 GOP blocks decode through the arena decoder with the
  streams sharded over "dp"; every stream and frame of every rank is held
  against the C oracle's `--hash` (the port's `DecoderSession` where the
  oracle does not build; the run says which). The last step's frames then
  go through RGB → resize → a ViT sharded over "tp". Where the budget
  allows, the decode repeats at K=2.

The dry run's clips are `__graft_entry__.dryrun_multichip`'s: stream s is
`make_clip(cfg, gops, seed=s)` (`dryrun_clips`), from the port's generator
`tools/encoder_torch.py`, which writes the bytes `tools/encoder.py` writes
and imports nothing of the JAX package; so it runs from a checkout, as the
JAX entry does with `tools/encoder`.
"""

from __future__ import annotations

import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .config import MAX_BASES, SeqConfig
from .convert import plan_to_torch, state_to_torch
from .parallel.multistream import multi_frame_step

REPO = Path(__file__).resolve().parent.parent


def _random_plane_plan(rng, bh: int, bw: int, n: int) -> dict:
    """Synthetic (N, bh, bw) plan arrays in valid ranges, no bitstream
    needed (`__graft_entry__._random_plane_plan`, the same draws)."""
    cls_ = rng.integers(0, 2, (n, bh, bw)).astype(np.uint32)
    mode = rng.integers(0, 5, (n, bh, bw)).astype(np.uint32)
    refsel = rng.integers(0, 3, (n, bh, bw)).astype(np.uint32)
    return {
        "meta": (mode | (refsel << 3) | (cls_ << 5)).astype(np.uint8),
        "dc": rng.integers(0, 256, (n, bh, bw), dtype=np.uint8),
        "raw": rng.integers(0, 256, (n, bh * 4, bw * 4), dtype=np.uint8),
        "desc": rng.integers(0, 1 << 32, (n, MAX_BASES, bh, bw),
                             dtype=np.uint64).astype(np.uint32),
        "mv": rng.integers(-16, 17, (n, 2, bh, bw)).astype(np.int16),
        "mv2": rng.integers(-16, 17, (n, 2, bh, bw)).astype(np.int16),
    }


def _example_step_args(cfg: SeqConfig, n: int) -> tuple:
    """`__graft_entry__._example_step_args` as numpy, the same draws."""
    rng = np.random.default_rng(0)
    nh, nw = cfg.nest_shape
    plane_plans = [_random_plane_plan(rng, bh, bw, n)
                   for bh, bw in cfg.block_grids]
    nest = rng.integers(0, 256, (n, nh, nw), dtype=np.uint8)
    new_nest = rng.integers(0, 256, (n, nh, nw), dtype=np.uint8)
    is_i = np.zeros((n,), bool)
    is_ref = np.ones((n,), bool)

    def refs():
        return [rng.integers(0, 256, (n, h, w), dtype=np.uint8)
                for h, w in cfg.plane_shapes]

    return plane_plans, nest, new_nest, is_i, is_ref, refs(), refs()


def entry(device="cuda"):
    """(multi_frame_step, its arguments on `device`) at 640x480, n=2."""
    plans, nest, new_nest, is_i, is_ref, prev, last = _example_step_args(
        SeqConfig(640, 480), n=2)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is "
                           f"not available")
    nest, prev, last = state_to_torch(nest, prev, last, dev)
    return multi_frame_step, (
        [plan_to_torch(p, dev) for p in plans], nest,
        torch.from_numpy(new_nest).to(dev), torch.from_numpy(is_i).to(dev),
        torch.from_numpy(is_ref).to(dev), prev, last)


def _golden_hashes(cfg: SeqConfig, clips: list) -> tuple[list, str]:
    """Per-stream FNV-1a hashes of every frame, from `oracle --hash`, or
    from the port's `DecoderSession` on the CPU where `make -C oracle`
    fails; and which of the two gave them."""
    from .utils.hashing import fnv1a

    if subprocess.run(["make", "-s", "-C", str(REPO / "oracle")],
                      capture_output=True).returncode != 0:
        from .session import DecoderSession

        return ([[f"{fnv1a(f.yuv_bytes()):08x}"
                  for f in DecoderSession(cfg, "cpu").decode_clip(c)]
                 for c in clips], "the port's DecoderSession")
    want = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, clip in enumerate(clips):
            path = Path(tmp) / f"{i}.h4m"
            path.write_bytes(clip)
            out = subprocess.run(
                [str(REPO / "oracle" / "hvqm4_oracle"), "--hash", str(path),
                 "/dev/null"], check=True, capture_output=True, text=True)
            want.append([line.split("hash=")[1] for line in
                         out.stdout.splitlines() if "hash=" in line])
    return want, "the C oracle"


def _dryrun_rank(dev, dp: int, tp: int, cfg: SeqConfig, clips: list,
                 want: list, deadline: float) -> dict:
    """One rank of `dryrun_multichip`: decode its streams at K=1, check
    them, embed the last step through the tp ViT, then K=2 if every rank
    has the time. Returns the frames it checked and the embeddings'
    shape."""
    from .models.vit import ViTConfig, init_vit, shard_vit_params
    from .parallel.dist import make_mesh
    from .parallel.multistream import MultiStreamDecoder, shard_streams
    from .pipeline import embed_frames
    from .utils.hashing import fnv1a

    mesh = make_mesh(dp, tp, dev.type)
    shard = shard_streams(mesh, "dp")
    n_local = len(clips) // shard.count
    lo = shard.index * n_local

    def decode(k: int):
        ms = MultiStreamDecoder(cfg, clips, dev, sharding=shard,
                                steps_per_dispatch=k)
        got = [[] for _ in range(n_local)]
        last = None
        for frames, _metas, valid in ms.run_pipelined():
            fnp = [p.cpu().numpy() for p in frames]
            for j, ok in enumerate(valid):
                if ok:
                    yuv = b"".join(fnp[pi][j].tobytes() for pi in range(3))
                    got[j].append(f"{fnv1a(yuv):08x}")
            last = frames
        for j in range(n_local):
            if got[j] != want[lo + j]:
                raise RuntimeError(
                    f"K={k} stream {lo + j}: sharded decode diverges from the "
                    f"golden hashes ({len(got[j])} frames)")
        return sum(map(len, got)), last

    t0 = time.monotonic()
    frames, last = decode(1)
    k1_s = time.monotonic() - t0
    vcfg = ViTConfig(image_size=64, patch_size=8, dim=128, depth=2, heads=4)
    model = shard_vit_params(init_vit(vcfg, torch.Generator().manual_seed(0),
                                      dev), mesh, "tp")
    emb = embed_frames(model, last, cfg.h_samp, cfg.v_samp)
    if tuple(emb.shape) != (n_local, vcfg.dim) or \
            not bool(torch.isfinite(emb).all()):
        raise RuntimeError(f"embeddings {tuple(emb.shape)}: want finite "
                           f"({n_local}, {vcfg.dim})")
    # K=2 only where every rank has the time left, so all agree
    more = torch.tensor([int(deadline - time.time() > 1.5 * k1_s + 30)],
                        device=dev)
    dist.all_reduce(more, op=dist.ReduceOp.MIN)
    ks = [1]
    if int(more):
        frames += decode(2)[0]
        ks.append(2)
    return {"frames": frames, "ks": ks, "emb": tuple(emb.shape)}


def dryrun_clips(dp: int, budget_s: float) -> tuple:
    """(cfg, clips) of the dry run at a "dp" width of `dp`, as
    `__graft_entry__.dryrun_multichip` makes them: 64x48, two streams a
    shard of ["IPBPB", "IPP"], or under a tight budget (< 300 s) one a
    shard of ["IPB", "IP"]; stream s `make_clip(cfg, gops, seed=s)`."""
    from tools.encoder_torch import make_clip

    cfg = SeqConfig(64, 48)
    small = budget_s < 300
    n_streams = dp if small else 2 * dp  # two streams a shard normally
    gops = ["IPB", "IP"] if small else ["IPBPB", "IPP"]
    return cfg, [make_clip(cfg, gops, seed=s) for s in range(n_streams)]


def dryrun_multichip(n_devices: int, device="cuda", backend: str | None = None,
                     budget_s: float = 480.0) -> None:
    """The sharded path on `n_devices` ranks (`parallel.dist.launch`): a
    ("dp", "tp") mesh with tp=2 where `n_devices` is even. Under a tight
    budget (< 300 s) the clips are fewer and shorter, still I/P/B in two GOP
    blocks. Raises if a rank fails; prints one line."""
    from .parallel.dist import launch

    t_start = time.monotonic()
    deadline = time.time() + budget_s
    tp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // tp
    cfg, clips = dryrun_clips(dp, budget_s)
    n_streams = len(clips)
    want, golden = _golden_hashes(cfg, clips)
    out = launch(_dryrun_rank, n_devices, dp, tp, cfg, clips, want, deadline,
                 device=device, backend=backend)
    ks = " and ".join(f"K={k}" for k in out[0]["ks"])
    print(f"dryrun_multichip: mesh dp={dp} tp={tp} on {device}, {n_streams} "
          f"streams, {sum(o['frames'] for o in out) // tp} frames bit-exact "
          f"against {golden} ({ks}), embeddings {out[0]['emb']} a rank "
          f"[{time.monotonic() - t_start:.0f} s of {budget_s:.0f} s budget]")
