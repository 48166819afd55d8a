#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. card: CUDA must be available (no CPU fallback); prints the card's name
   and power limit as nvidia-smi reports them.
2. build: the CUDA kernels (nvcc, sm_90a), the C oracle and the C++ planner,
   with their build seconds and nvcc's register/shared-memory report.
3. kernels vs plain: every CUDA entry point against its plain PyTorch
   version on the card, exact: the decode kernels on random plans
   (`DECODE_CASES`) at the 640x480 block grids with N = 1, 8 and 33, at
   ragged grids (45 and 46 blocks wide, 13 and 14 high), with windows
   straddling every border and vectors of +-2,000, both nest orientations,
   per-block and per-MB vector grids, and `inter_combine` refusing a
   per-pixel grid; `yuv_to_rgb` on random planes (`CSC_CASES`) at 480x640,
   N=8, 4:2:0 and 4:4:4, at a ragged 250x90 and a 200x360 (8 mod 16 wide),
   in the 2-D form, as a view of stacked frames and one byte off an aligned
   base, printing the kernel variant each case took; both must be taken.
4. session: testdata/ref640.h4m and retail640.h4m (28 frames each) through
   `DecoderSession` on cuda; every frame's on-device csum must equal
   `oracle --csum`, and retail640's FNV-1a hashes `oracle --hash`.
5. lock-step: 8 streams (4x each clip) through `multi_frame_step`; every
   frame of every stream must equal the oracle's csum. The decode kernels
   must have launched during phases 4-5.
5b. arena (the main path): the same 8 streams through the arena
   `MultiStreamDecoder` on cuda, `run_pipelined` at K = 1 and K = 2
   (plan_ahead 2), then a packed replay (every step planned and
   snapshotted, `stage_packed`, `device_step` on a fresh decoder); every
   frame of every stream must equal the oracle's csum (`batch_csum` on the
   card). `intra_synth_acc` and `inter_combine` must each launch 3 x the
   decode steps of the phase (dispatched steps x K), `intra_synth_noacc`
   never.
5c. consumers: the same 8 streams through `data.FrameBatchLoader` and
   `pipeline.VideoEmbedPipeline` on cuda, with the default ViT (224x224,
   patch 16, dim 384, depth 6, 6 heads). The loader in decode order at full
   size: every batch times 255, rounded, must equal the integer formula on
   the oracle's frames of that step (the batched `yuv_to_rgb` behind the
   arena is exact). At `image_size` 224: shape, range (1e-6 of float
   slack above 1), and within 1e-6 of
   `resize_bilinear` of the checked RGB. In display order: every display id
   of every stream once and in order, each frame the checked one with that
   id. The pipeline at `plan_ahead` 1 and 2, its consumer synchronising only
   at the end: (8, 384) finite embeddings a step, every stream valid, each
   within max abs 2e-2 and cosine 0.9999 of the same model run one frame a
   call on the checked RGB (a gate for gross errors). `yuv_to_rgb` must
   launch once a step (not once a frame), `intra_synth_acc` and
   `inter_combine` 3 x the decode steps, `intra_synth_noacc` never; the
   variant `yuv_to_rgb` took is printed. Then, uncounted, the command line
   on the card: `decode --start-time` inside ref640's second block equals
   `--start-block 1` and the oracle's frames, and `stats` gives its four
   keys.
5d. encoder: the first two display-order frames of ref640.h4m (the
   oracle's) as source, at 640x480. `encode_tpu.NestSearch(nest,
   "cuda").best` on the first frame's 19,200 luma residuals, against a nest
   built by `plans.build_nest`, must equal the same call on `device="cpu"`
   in descriptors, terms and scales. `VideoEncoder(cfg,
   use_tpu_search=True, device="cuda").encode(frames, ["IP"])`: the clip
   through `DecoderSession` on cuda, every frame's on-device csum equal to
   `oracle --csum` of that clip; the luma PSNR of the oracle's decode
   against the source must be the one a CPU run of the same encode gave
   (`ENCODE_PSNR`; the encoder is deterministic). `cli transcode` of that
   clip on the default device: exit 0, geometry, frame count and
   `usec_per_frame` kept, the result decoding identically by the oracle and
   by the session on the card. Those three session decodes of one I and one
   P frame must launch `intra_synth_noacc`, `intra_synth_acc` and
   `inter_combine` 9 times each (3 planes x 3 decodes) and `yuv_to_rgb`
   never. Then the search's and the encoder's times.
5e. training: the same 8 streams through `FrameBatchLoader(image_size=224)`
   into the default ViT and `examples/train_vit_torch.py`'s mean-RGB probe,
   `torch.optim.Adam(1e-3)`, two epochs of 28 steps. Every loss must be
   finite and epoch 2's mean below the first step's loss; at step 2 every
   ViT leaf but the never-added `b2` must have a non-zero gradient (`b2`'s
   is None). The first three batches, moved to the CPU, go through
   `train_step` there: each from the card's weights and Adam state before
   that step, losses within 2e-2 relative and parameters within
   `PARAM_BOUND`; and all three chained from the start, parameters within
   `PARAM_BOUND`. `intra_synth_acc` and `inter_combine` must launch 3 x
   the decode steps, `yuv_to_rgb` once a step, `intra_synth_noacc` never. Then, after the counts: epoch 2's train_fps
   and its ms a step split into loader, forward, backward and opt.step by
   CUDA events; the launches of one train step from the profiler and the
   host synchronisations it makes unasked; the device's busy share over a
   third, profiled epoch; embed_fps of the same streams. Last the soak:
   `scripts/soak_device_torch.py`'s cases of `SOAK_SEEDS` on the card
   (random geometries, each stream a `make_clip` clip drawn as
   `scripts/soak_device.py` draws it), each stream equal to the oracle's
   bytes.
5f. sharded: the same 8 streams at full width on a dp=2 x tp=2 mesh of 4
   ranks sharing the one card through gloo (`parallel.dist.launch`), then
   at world size 1 through nccl. Each rank, counted: its 4 (8) streams
   through `MultiStreamDecoder(sharding=shard_streams(mesh))`, every
   frame's csum equal to the oracle's; `VideoEmbedPipeline(mesh=…)` with
   the default ViT (3 heads and an MLP of 768 a tp rank); two epochs of
   `FrameBatchLoader(mesh=…)` into `train_step` with
   the "dp" group. `intra_synth_acc` and `inter_combine` must launch 3 x
   the rank's decode steps, `yuv_to_rgb` once an embed or train step,
   `intra_synth_noacc` never. Then, uncounted, the unsharded pipeline on
   the rank's own streams: every step's embeddings within max abs 2e-2
   and cosine 0.9999. Every rank's first two losses within 1e-3 relative
   of phase 5e's on one device (step 1 trains only the zero head, so both
   take step 2 from the same ViT), the same history on every rank, and no
   module of JAX or `hvqm4_tpu` in any rank. Printed: which collectives
   gloo runs on CUDA tensors, each rank's counts, train_fps of epoch 2 on
   each mesh (ranks sharing one card) beside phase 5e's, the phase's
   seconds.
6. serve: the port's `DecodeServer` on cuda, on a thread, answers both
   clips over TCP in YUV (FNV-1a == `oracle --hash`), RGB (== the integer
   formula on the oracle's frames) and EMBED (28 finite 384-vectors; two
   frames a clip against the port's CPU ViT with the same weights), then
   four mixed requests over one `MuxClient` connection (== the single-shot
   replies), then metrics; `cli remote` fetches one clip in YUV (FNV-1a ==
   `oracle --hash`) and `--metrics` from it. Then a batching server (`batch_window_s`
   0.25, `max_batch` 4) answers four concurrent requests: both clips in
   YUV (== `oracle --hash`) and RGB (== the integer formula), and a
   truncated clip that must fail alone; fewer batches than batched
   requests, and `yuv_to_rgb` launched by the batch's RGB replies. Every
   kernel, `yuv_to_rgb` included, must have launched during this phase.
   Then request latencies and the ViT's time per frame.
7. times (after a line of the card's SM and memory clocks and power draw):
   kernel and plain times (CUDA events, 3 warm-ups, median of 20;
   the profiler's device time per call), in a process of its own (a fresh
   profiler), each call with a cold L2: a 256 MiB write (`L2Flush`) goes
   before it, outside the events and left out of the profiler's sum. The
   decode kernels at both 640x480 grids with N = 1, 8 and 32, each beside
   its bound: the bytes this data needs (`intra_bytes`, `inter_bytes`)
   over 3.35 TB/s; `yuv_to_rgb` at 480x640 4:2:0 with N = 1, 8 and 64 and
   4:4:4 with N = 8 (the vector variant), and at 480x632 (8 mod 16 wide:
   the general variant) with N = 8 in both.
   A device time below its bound / 1.05 fails the phase. Then session
   and lock-step frame rates, host planning timed separately, and beside
   them the arena path's: pipelined fps at K = 1 and 2 with the decoder's
   stage split per frame (plan, assemble, stage, upload, dispatch, wait),
   the packed replay's device-phase fps with its plans already on the
   card, bytes uploaded per frame on both paths, the device's busy share
   over a pipelined window, and the profiler's launches per step split
   into the port's kernels, copies and the rest. Then the consumers:
   end-to-end fps of the pipeline and of the loader at 224 beside the
   arena's, the ViT's ms a frame at batch 1 and at batch 8 on the same
   images, RGB + resize of one step alone, the host synchronisations that
   an arena step and an embed make unasked, and the device's busy share
   over one pipeline run.
8. bench: `python3 bench_torch.py` at its defaults in its own process
   group, its total budget `BENCH_BUDGET_S`: rc 0 and one JSON line,
   `backend` cuda, no `phase_failures`, `bitexact` and
   `device_replay_bitexact` true on both clips (retail at K=28), `value`,
   `device_fps`, `retail_device_fps` and `plan_fps` above 0, and in every
   job that touched the card `intra_synth_acc` and `inter_combine`
   launched 3 x its decode steps (dispatched steps x K: the hash 28, the
   device phase 28 a pass with its warm pass, the pipeline 2 x 28),
   `intra_synth_noacc` and `yuv_to_rgb` never. Then its instruments, each
   rc 0 with its keys on the card: `scripts/device_sweep_torch.py 8`,
   `compute_ceiling_torch.py 2`, `profile_split_torch.py 8` and
   `soak_throughput_torch.py --minutes 0.5`. The bench's headline fields,
   its whole line and each instrument's line are printed with the card's
   name and power limit.
9. tools: random clips of the port's generator (`tools/encoder_torch.py`)
   at 640x480, each ["IPB", "IP"], made in parallel processes: three 4:2:0
   streams (`slices` 8; `mv_extreme`; 2 audio channels with `dc_shift` 7)
   through the arena `MultiStreamDecoder` on cuda at K = 1 and 2, and a
   4:4:4 clip at version 1.5 through `DecoderSession`; every frame's csum
   equal to `oracle --csum`. On the arena `intra_synth_acc` and
   `inter_combine` must launch 3 x the decode steps and
   `intra_synth_noacc` never; in the session `intra_synth_noacc` 3 x the I
   frames. Beside it, in a process of its own (`fuzz_child`), the 60
   mutants of `scripts/fuzz_battery_torch.py`'s six bases: those the
   oracle decodes with rc 0 and the port's planner plans whole go through
   the arena decoder on cuda at K = 1 and 2, with no CUDA fault, every
   frame equal to `refdec`'s golden decode on the CPU, and every csum
   equal to `oracle --csum` where the golden decode's is. A mutant whose
   golden decode parts from the oracle is printed and counted. The
   phase's seconds are printed.

`launches` in the kernels line is the sum of the counted phases 4-5, 5b,
5c, 5d, 5e, 5f (every rank), 6 and 9 (its child too); its times are the
luma grid's (480x640 for `yuv_to_rgb`) at N=8. Before the last lines
the script fails if any module of JAX or of `hvqm4_tpu` was imported,
and prints its own seconds end to end. The line before the last is a
JSON object of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import io
import json
import os
import signal
import statistics
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
CLIPS = ("ref640.h4m", "retail640.h4m")
N_STREAMS = 8
GRIDS_640 = ((120, 160), (60, 80))  # luma and 4:2:0 chroma block grids
SCRATCH = REPO / "build" / "chip_smoke"  # git ignores build/


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, warmup: int = 3, iters: int = 20, before=None) -> float:
    """Median device time of one call, from CUDA events around it;
    `before`, when given, runs before each call, outside the events."""
    import torch

    for _ in range(warmup):
        if before:
            before()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if before:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_plan(rng, bh: int, bw: int, n: int, grid: tuple) -> dict:
    """Random (N, …) plan arrays in valid ranges: every block mode incl.
    raw blocks, all refsel values, random descriptor words, and vectors
    on a (gh, gw) grid, some far outside the frame."""
    cls_ = rng.integers(0, 2, (n, bh, bw))
    mode = rng.integers(0, 5, (n, bh, bw))
    refsel = rng.integers(0, 4, (n, bh, bw))
    meta = (mode | (refsel << 3) | (cls_ << 5)).astype(np.uint8)
    meta[:, ::7] = (meta[:, ::7] & 0xD8) | 6  # intra raw blocks
    gh, gw = grid

    def vectors():
        v = rng.integers(-16, 17, (n, 2, gh, gw)).astype(np.int16)
        v[:, :, ::5, ::3] = rng.integers(-2000, 2001, v[:, :, ::5, ::3].shape)
        return v

    return {
        "meta": meta,
        "dc": rng.integers(0, 256, (n, bh, bw), dtype=np.uint8),
        "raw": rng.integers(0, 256, (n, bh * 4, bw * 4), dtype=np.uint8),
        "desc": rng.integers(0, 1 << 32, (n, 4, bh, bw),
                             dtype=np.uint64).astype(np.uint32),
        "mv": vectors(),
        "mv2": vectors(),
    }


def border_vectors(rng, plan: dict) -> dict:
    """Make every block inter, with every refsel, and give it small vectors
    (-9..9, every half-pel phase) so that the blocks along each border
    read windows that straddle it; every 7th backward vector component is
    +-2000, far outside the plane. Per-block vector grids only."""
    n, bh, bw = plan["meta"].shape
    sel = rng.integers(0, 4, (n, bh, bw))
    plan["meta"] = ((plan["meta"] & 7) | (sel << 3) | (1 << 5)).astype(
        np.uint8)
    combos = np.stack(np.meshgrid(np.arange(-9, 10), np.arange(-9, 10)),
                      -1).reshape(-1, 2)
    k = rng.permutation(n * bh * bw) % len(combos)
    plan["mv"] = np.ascontiguousarray(
        combos[k].reshape(n, bh, bw, 2).transpose(0, 3, 1, 2), np.int16)
    mv2 = plan["mv"][:, :, ::-1, ::-1].copy()
    mv2.reshape(-1)[::7] = rng.choice([-2000, 2000], mv2.reshape(-1)[::7].size)
    plan["mv2"] = mv2
    return plan


def max_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max())


# Phase 3's decode cases: (N, block grid, nest, vector grid, vectors). The
# 640x480 grids at N = 1, 8 and 33, both nests and both vector grids; a
# block width that is no multiple of a warp's 32 blocks and a band of rows
# that is no multiple of a thread block's 8 (45 and 13, 46 and 14); every
# block inter with windows straddling each border.
DECODE_CASES = [
    (8, (120, 160), (38, 70), "block", "random"),
    (8, (120, 160), (70, 38), "mb", "random"),
    (8, (60, 80), (38, 70), "mb", "random"),
    (8, (60, 80), (70, 38), "block", "random"),
    (1, (120, 160), (70, 38), "block", "random"),
    (1, (60, 80), (38, 70), "mb", "random"),
    (33, (60, 80), (70, 38), "block", "random"),
    (33, (14, 46), (38, 70), "mb", "random"),
    (1, (13, 45), (70, 38), "block", "random"),
    (8, (12, 20), (38, 70), "block", "border"),
]


def phase_kernels(dev) -> dict:
    """Phase 3: each kernel against its plain version, exact. The random
    descriptor words carry nest offsets up to 127, beyond both nest sides
    (38 and 70), so the kernels' modular addressing wraps."""
    import torch

    from hvqm4_tpu_torch.convert import plan_to_torch
    from hvqm4_tpu_torch.kernels.csc import (_vector_ok, yuv_to_rgb,
                                             yuv_to_rgb_plain)
    from hvqm4_tpu_torch.kernels.inter import inter_combine, inter_combine_plain
    from hvqm4_tpu_torch.kernels.intra import intra_synth, intra_synth_plain

    rng = np.random.default_rng(2024)
    err = {"intra_synth_noacc": 0, "intra_synth_acc": 0, "inter_combine": 0}
    for n, (bh, bw), nest_shape, vgrid, vectors in DECODE_CASES:
        grid = (bh, bw) if vgrid == "block" else (bh // 2, bw // 2)
        p = random_plan(rng, bh, bw, n, grid)
        if vectors == "border":
            p = border_vectors(rng, p)
        plan = plan_to_torch(p, dev)
        nest = torch.from_numpy(rng.integers(
            0, 256, (n, *nest_shape), dtype=np.uint8)).to(dev)
        ref0, ref1 = (torch.from_numpy(rng.integers(
            0, 256, (n, bh * 4, bw * 4), dtype=np.uint8)).to(dev)
            for _ in range(2))
        want_px, want_acc = intra_synth_plain(plan, nest, want_acc=True)
        got_px, _ = intra_synth(plan, nest, want_acc=False)
        err["intra_synth_noacc"] = max(err["intra_synth_noacc"],
                                       max_err(got_px, want_px))
        got_px, got_acc = intra_synth(plan, nest, want_acc=True)
        err["intra_synth_acc"] = max(err["intra_synth_acc"],
                                     max_err(got_px, want_px),
                                     max_err(got_acc, want_acc))
        want = inter_combine_plain(plan, want_px, want_acc, ref0, ref1)
        got = inter_combine(plan, got_px, got_acc, ref0, ref1)
        err["inter_combine"] = max(err["inter_combine"], max_err(got, want))
        torch.cuda.synchronize()
        print(f"kernels vs plain: grid {bh}x{bw} N={n} nest {nest_shape[0]}x"
              f"{nest_shape[1]} vectors {grid[0]}x{grid[1]} {vectors}: "
              f"max_abs_err {err}")
    # one vector per pixel is finer than the kernel's one per block
    fine = {**plan, "mv": torch.zeros((n, 2, bh * 4, bw * 4),
                                      dtype=torch.int16, device=dev)}
    try:
        inter_combine(fine, got_px, got_acc, ref0, ref1)
        fail("inter_combine took a per-pixel vector grid")
    except ValueError as e:
        print(f"kernels: inter_combine refuses a per-pixel grid ({e})")
    err["yuv_to_rgb"] = 0
    variants = set()
    for n, h, w, samp, form in CSC_CASES:
        y, u, v = csc_planes(rng, n, h, w, samp, form, dev)
        got = yuv_to_rgb(y, u, v, samp, samp)
        e = max_err(got, yuv_to_rgb_plain(y, u, v, samp, samp))
        torch.cuda.synchronize()
        err["yuv_to_rgb"] = max(err["yuv_to_rgb"], e)
        variant = "vector" if _vector_ok(w, samp, y.data_ptr(), u.data_ptr(),
                                         v.data_ptr(), got.data_ptr()) \
            else "general"
        variants.add(variant)
        print(f"kernels vs plain: yuv_to_rgb {h}x{w} "
              f"{'4:2:0' if samp == 2 else '4:4:4'} N={n} {form}, {variant} "
              f"variant: max_abs_err {e}")
    if variants != {"vector", "general"}:
        fail(f"yuv_to_rgb: the cases took only {variants}")
    for name, e in err.items():
        if e != 0:
            fail(f"{name} differs from its plain version (max_abs_err {e})")
    return err


# Phase 3's `yuv_to_rgb` cases: (N, H, W, sampling, form), `form` as in
# `csc_planes`. 250x90 is no multiple of the JAX kernel's 64-row tile and,
# like 360, no multiple of the vector variant's 16-pixel group; frames of
# a stack start aligned at 640x480; the offset form never does.
CSC_CASES = [(N_STREAMS, 480, 640, 2, "stack"),
             (N_STREAMS, 480, 640, 1, "stack"),
             (N_STREAMS, 250, 90, 2, "stack"),
             (N_STREAMS, 200, 360, 2, "stack"),
             (1, 480, 640, 2, "2d"), (3, 480, 640, 2, "view"),
             (1, 480, 640, 2, "offset")]


# Phase 7's `yuv_to_rgb` points: (N, W, sampling) at H = 480. 640 wide
# takes the vector variant; 632, 8 mod 16, the general one.
CSC_TIME_POINTS = [(1, 640, 2), (N_STREAMS, 640, 2), (64, 640, 2),
                   (N_STREAMS, 640, 1), (N_STREAMS, 632, 2),
                   (N_STREAMS, 632, 1)]


def csc_planes(rng, n: int, h: int, w: int, samp: int, form: str,
               dev) -> list:
    """Random u8 planes [Y, U, V] on `dev`, chroma at its native size:
    (N, H, W) for "stack"; (H, W) planes of their own for "2d"; the last
    frame of a stack of N for "view"; (H, W) planes starting one byte past
    an aligned base for "offset"."""
    import torch

    planes = random_yuv(rng, n if form in ("stack", "view") else None, h, w,
                        samp, dev)
    if form == "view":
        return [p[-1] for p in planes]
    if form == "offset":
        out = []
        for p in planes:
            flat = torch.empty(p.numel() + 1, dtype=torch.uint8, device=dev)
            flat[1:] = p.reshape(-1)
            out.append(flat[1:].view(p.shape))
        return out
    return planes


def random_yuv(rng, n, h: int, w: int, samp: int, dev) -> list:
    """Random u8 planes [Y, U, V] on `dev`, chroma at its native size, with
    a leading stream axis unless `n` is None."""
    import torch

    lead = (n,) if n else ()
    return [torch.from_numpy(rng.integers(0, 256, (*lead, hh, ww),
                                          dtype=np.uint8)).to(dev)
            for hh, ww in ((h, w), (h // samp, w // samp),
                           (h // samp, w // samp))]


def phase_session(dev, clips: dict, oracle: Path, want_csums: dict) -> None:
    """Phase 4: DecoderSession on the card against the C oracle."""
    from hvqm4_tpu_torch.container import Demuxer
    from hvqm4_tpu_torch.session import DecoderSession
    from hvqm4_tpu_torch.utils.hashing import fnv1a, frame_csum

    for name, data in clips.items():
        path = REPO / "testdata" / name
        want = want_csums[name]
        sess = DecoderSession(Demuxer(data).info.cfg, dev)
        planner = type(sess.planner).__name__
        if planner != "NativePlanner":
            fail(f"session planner is {planner}, not NativePlanner")
        got, hashes = [], []
        for f in sess.decode_clip(data):
            got.append(f"{int(frame_csum(f.planes)):08x}")
            if name == "retail640.h4m":
                hashes.append(f"{fnv1a(f.yuv_bytes()):08x}")
        if got != want or len(got) != 28:
            bad = next((i for i, (a, b) in enumerate(zip(got, want))
                        if a != b), min(len(got), len(want)))
            fail(f"session {name}: {len(got)} frames vs oracle's "
                 f"{len(want)}, first mismatch at frame {bad}")
        msg = f"session {name} on {dev}: {len(got)} frames, csum == oracle"
        if hashes:
            res = subprocess.run([str(oracle), "--hash", str(path),
                                  "/dev/null"], check=True,
                                 capture_output=True, text=True)
            want_h = [ln.split("hash=")[1] for ln in res.stdout.splitlines()
                      if "hash=" in ln]
            if hashes != want_h:
                fail(f"session {name}: FNV-1a hashes differ from oracle")
            msg += ", FNV-1a == oracle --hash"
        print(f"{msg} (planner {planner})")


STREAM_CLIPS = [CLIPS[j % 2] for j in range(N_STREAMS)]  # 4x each clip


def phase_lockstep(cfg, clips: dict, dev, want: dict) -> None:
    """Phase 5: 8 streams through `decode_lockstep` (per-stream
    NativePlanner, stacked per step, `multi_frame_step`); every frame of
    every stream against the oracle."""
    from hvqm4_tpu_torch.parallel.multistream import decode_lockstep
    from hvqm4_tpu_torch.utils.hashing import batch_csum

    got = [[] for _ in range(N_STREAMS)]
    for frames, valid in decode_lockstep(
            cfg, [clips[n] for n in STREAM_CLIPS], dev):
        cs = batch_csum(*frames).cpu().tolist()
        for j in range(N_STREAMS):
            if valid[j]:
                got[j].append(f"{cs[j]:08x}")
    for j, name in enumerate(STREAM_CLIPS):
        if got[j] != want[name]:
            fail(f"lock-step stream {j} ({name}) differs from the oracle")
    print(f"lock-step on {dev}: {N_STREAMS} streams, "
          f"{sum(map(len, got))} frames, csum == oracle on every frame")


def arena_csums(ms, steps) -> list:
    """Per stream, the csum of every valid frame of `steps`, an iterator
    of (frames, metas, valid) from `ms`."""
    from hvqm4_tpu_torch.utils.hashing import batch_csum

    got = [[] for _ in range(ms.n)]
    for frames, _metas, valid in steps:
        cs = batch_csum(*frames).cpu().tolist()
        for j in range(ms.n):
            if valid[j]:
                got[j].append(f"{cs[j]:08x}")
    return got


def plan_replay(cfg, streams: list, dev) -> tuple:
    """Every step of the 8 streams planned ahead by a decoder on `dev`, as
    `snapshot_step` payloads, with the count of valid frames."""
    from hvqm4_tpu_torch.parallel.multistream import MultiStreamDecoder

    ms = MultiStreamDecoder(cfg, streams, dev)
    snaps, valid = [], []
    while any(ms.active):
        buf, _metas, v = ms.plan_step()
        snaps.append(ms.snapshot_step(buf))
        valid.append(v)
    return snaps, valid


def phase_arena(cfg, clips: dict, dev, want: dict) -> int:
    """Phase 5b: the arena decoder on the card, pipelined at K = 1 and 2,
    then a packed replay; every frame of every stream against the oracle.
    Returns the decode steps run (dispatched steps x K)."""
    from hvqm4_tpu_torch.parallel.multistream import MultiStreamDecoder

    streams = [clips[n] for n in STREAM_CLIPS]
    substeps = 0
    for k in (1, 2):
        ms = MultiStreamDecoder(cfg, streams, dev, steps_per_dispatch=k,
                                plan_ahead=2)
        got = arena_csums(ms, ms.run_pipelined())
        for j, name in enumerate(STREAM_CLIPS):
            if got[j] != want[name]:
                fail(f"arena K={k} stream {j} ({name}) differs from the "
                     f"oracle")
        substeps += int(ms.stats["steps"]) * k
        print(f"arena on {dev}, run_pipelined K={k}: {N_STREAMS} streams, "
              f"{int(ms.stats['frames'])} frames in {int(ms.stats['steps'])}"
              f" dispatches, csum == oracle on every frame")
    snaps, valid = plan_replay(cfg, streams, dev)
    ms = MultiStreamDecoder(cfg, streams, dev)
    ms.stage_packed(snaps)
    got = arena_csums(ms, ((ms.device_step(s), None, v)
                           for s, v in zip(snaps, valid)))
    for j, name in enumerate(STREAM_CLIPS):
        if got[j] != want[name]:
            fail(f"arena packed replay stream {j} ({name}) differs from the "
                 f"oracle")
    substeps += len(snaps)
    print(f"arena on {dev}, packed replay: {len(snaps)} steps staged in one "
          f"upload per dtype, csum == oracle on every frame")
    return substeps


def lockstep_steps(cfg, clips: dict, dev) -> list:
    """The host half of lock-step decode, done ahead for timing: every
    step's stacked inputs, already on the card, with its frame count."""
    from hvqm4_tpu_torch.convert import stack_plans
    from hvqm4_tpu_torch.parallel.multistream import plan_steps

    return [(stack_plans(cfg, plans, dev), sum(p is not None for p in plans))
            for plans in plan_steps(cfg, [clips[n] for n in STREAM_CLIPS])]


def run_lockstep(cfg, steps, dev) -> None:
    """The device half: every step through `multi_frame_step`."""
    import torch

    from hvqm4_tpu_torch.parallel.multistream import (init_state,
                                                      multi_frame_step)

    nest, ref_prev, ref_last = init_state(cfg, N_STREAMS, dev)
    for (plane_plans, new_nest, is_i, is_ref), _frames in steps:
        multi_frame_step(plane_plans, nest, new_nest, is_i, is_ref,
                         ref_prev, ref_last)
    torch.cuda.synchronize()


HBM_BYTES_PER_S = 3.35e12  # one H100 SXM, NVIDIA's data sheet
TIME_NS = (1, N_STREAMS, 32)  # N=32 luma moves more than the 50 MB L2
FLUSH_BYTES = 256 << 20  # phase 7's L2 flush: a write of 5x the L2
BOUND_SLACK = 1.05  # a device time below bound / 1.05 is no reading


class L2Flush:
    """Phase 7's cold L2: each call writes `FLUSH_BYTES` of float64 over a
    buffer of its own, so that the next call finds none of its inputs in
    the L2 and every line there dirty with other data (its own writes
    must evict them). The profiler names its kernel after `ROW`; no plain
    version fills float64."""

    ROW = "FillFunctor<double>"

    def __init__(self, dev):
        import torch

        self.buf = torch.empty(FLUSH_BYTES // 8, dtype=torch.float64,
                               device=dev)
        self.value = 0.0

    def __call__(self) -> None:
        self.value += 1.0
        self.buf.fill_(self.value)


def intra_bytes(plan, nest, want_acc: bool) -> tuple:
    """(bytes this plan needs, bytes of the whole arrays) of one
    `intra_synth` call, each input read once and each output written once.
    A block reads its descriptor words up to its basis count, raw pixels
    only in mode 6, DCs unless it is a raw block or the neighbour of a
    mode-0 block; meta, the nest and the outputs are whole."""
    import torch

    meta = plan["meta"].long()
    mode, cls_ = meta & 7, (meta >> 5) & 1
    count = torch.where((cls_ != 0) | ((mode >= 1) & (mode <= 4)), mode,
                        torch.zeros_like(mode))
    m0 = mode == 0
    dc_need = mode != 6
    dc_need[..., 1:, :] |= m0[..., :-1, :]
    dc_need[..., :-1, :] |= m0[..., 1:, :]
    dc_need[..., :, 1:] |= m0[..., :, :-1]
    dc_need[..., :, :-1] |= m0[..., :, 1:]
    npix = plan["raw"].numel()
    out = npix * (5 if want_acc else 1)
    need = (meta.numel() + int(dc_need.sum()) + 4 * int(count.clamp(max=4).sum())
            + 16 * int((mode == 6).sum()) + nest.numel() + out)
    whole = sum(plan[k].numel() * plan[k].element_size()
                for k in ("meta", "dc", "desc", "raw")) + nest.numel() + out
    return need, whole


def _block_vectors(grid, bh: int, bw: int):
    """(N, 2, gh, gw) vectors → per-block (mvx, mvy), each (N, bh, bw)."""
    import torch

    gh, gw = grid.shape[-2:]
    rows = torch.arange(bh, device=grid.device) * gh // bh
    cols = torch.arange(bw, device=grid.device) * gw // bw
    v = grid.long()[:, :, rows][:, :, :, cols]
    return v[:, 0], v[:, 1]


def _window_bytes(reads, ph: int, pw: int) -> int:
    """Distinct bytes of one (N, ph, pw) reference plane that the half-pel
    windows read: `reads` is [(block mask, mvx, mvy)], each (N, bh, bw);
    a window is (4 + hy) x (4 + hx) bytes, clamped to the plane."""
    import torch

    seen = None
    for need, mvx, mvy in reads:
        n, bh, bw = need.shape
        dev = need.device
        if seen is None:
            seen = torch.zeros((n, ph * pw), dtype=torch.bool, device=dev)
        r = torch.arange(5, device=dev)
        iy = (torch.arange(bh, device=dev)[:, None] * 4 + (mvy >> 1))
        ix = (torch.arange(bw, device=dev)[None, :] * 4 + (mvx >> 1))
        rows = (iy[..., None] + r).clamp(0, ph - 1)
        cols = (ix[..., None] + r).clamp(0, pw - 1)
        ok = (need[..., None, None] & (r < 4 + (mvy & 1)[..., None])[..., :, None]
              & (r < 4 + (mvx & 1)[..., None])[..., None, :])
        idx = rows[..., :, None] * pw + cols[..., None, :]
        stream = torch.arange(n, device=dev)[:, None, None, None, None]
        seen[stream.expand_as(idx)[ok], idx[ok]] = True
    return int(seen.sum())


def inter_bytes(plan, ref0, ref1) -> tuple:
    """(bytes this plan needs, bytes of the whole arrays) of one
    `inter_combine` call. An intra block reads its 16 intra bytes; an inter
    block its 64 acc bytes, its vector (and the backward one when it
    blends) and the distinct reference bytes of its windows; meta and the
    output are whole."""
    import torch

    meta = plan["meta"].long()
    inter, sel = ((meta >> 5) & 1) == 1, (meta >> 3) & 3
    n, bh, bw = meta.shape
    ph, pw = ref0.shape[-2:]
    mvx, mvy = _block_vectors(plan["mv"], bh, bw)
    m2x, m2y = _block_vectors(plan["mv2"], bh, bw)
    blend = inter & (sel >= 2)

    def cells(mask, grid):  # vector cells that a block of `mask` reads
        gh, gw = grid.shape[-2:]
        rows = torch.arange(bh, device=mask.device) * gh // bh
        cols = torch.arange(bw, device=mask.device) * gw // bw
        used = torch.zeros((n, gh, gw), dtype=torch.bool, device=mask.device)
        s, y, x = mask.nonzero(as_tuple=True)
        used[s, rows[y], cols[x]] = True
        return int(used.sum())

    need = (meta.numel() + 16 * int((~inter).sum()) + 64 * int(inter.sum())
            + 4 * cells(inter, plan["mv"]) + 4 * cells(blend, plan["mv2"])
            + _window_bytes([(inter & (sel != 1), mvx, mvy)], ph, pw)
            + _window_bytes([(inter & (sel == 1), mvx, mvy),
                             (blend, m2x, m2y)], ph, pw)
            + n * ph * pw)
    whole = (sum(plan[k].numel() * plan[k].element_size()
                 for k in ("meta", "mv", "mv2"))
             + n * ph * pw * (1 + 4 + 1 + 1 + 1))
    return need, whole


def kernel_times_child() -> None:
    """Phase 7's kernel timings (`kernel_times`) on the card, in a process
    of its own: a fresh profiler. In a process that has profiled the
    earlier phases, the profiler's windows lost device activity, and a
    window that lost some reads too few us a call. Prints the timing
    lines, then one JSON line of the luma (480x640) N=8 figures."""
    import torch

    print(json.dumps(kernel_times(torch.device("cuda", 0), card_line())))


def kernel_times(dev, tag: str) -> dict:
    """Phase 7's kernel timings: the decode kernels vs plain at the 640x480
    grids with N = 1, 8 and 32, each beside its bound; `yuv_to_rgb` vs
    plain at `CSC_TIME_POINTS`. Returns, per kernel, the luma (or 480x640)
    N=8 figures."""
    import torch

    from hvqm4_tpu_torch.convert import plan_to_torch
    from hvqm4_tpu_torch.kernels.csc import yuv_to_rgb, yuv_to_rgb_plain
    from hvqm4_tpu_torch.kernels.inter import inter_combine, inter_combine_plain
    from hvqm4_tpu_torch.kernels.intra import intra_synth, intra_synth_plain

    rng = np.random.default_rng(7)
    times = {}

    flush = L2Flush(dev)

    def timed(name, kern, plain, nbytes, what, keep):
        # plain, kernel, kernel, plain: the two halves bracket drift; every
        # call starts with a cold L2
        p1, k1, k2, p2 = (cuda_ms(plain, before=flush),
                          cuda_ms(kern, before=flush),
                          cuda_ms(kern, before=flush),
                          cuda_ms(plain, before=flush))
        k, p = min(k1, k2), min(p1, p2)
        dev_us, plain_us = (device_us_per_call(kern, flush),
                            device_us_per_call(plain, flush))
        need, whole = nbytes
        bound_us = need / HBM_BYTES_PER_S * 1e6
        share = (f"{100 * bound_us / dev_us:.1f}% of it" if dev_us
                 else "share not measured")
        print(f"time {name} {what}: kernel {k:.4f} ms, plain {p:.4f} ms "
              f"({p / k:.1f}x) per call, cold L2; device only: kernel "
              f"{fmt_us(dev_us)}, plain {fmt_us(plain_us)}; bound "
              f"{bound_us:.2f} us ({need / 1e6:.3f} MB this data needs; the "
              f"whole arrays {whole / 1e6:.3f} MB = "
              f"{whole / HBM_BYTES_PER_S * 1e6:.2f} us), {share} [{tag}]")
        if dev_us and bound_us > BOUND_SLACK * dev_us:
            fail(f"{name} {what}: {dev_us:.2f} us on the device is below its "
                 f"bound of {bound_us:.2f} us: no reading of the kernel")
        if keep:
            times[name] = {"ms": k, "plain_ms": p, "bound_us": bound_us,
                           "device_us": dev_us}

    for bh, bw in GRIDS_640:
        for n in TIME_NS:
            plan = plan_to_torch(random_plan(rng, bh, bw, n, (bh, bw)), dev)
            nest = torch.from_numpy(rng.integers(
                0, 256, (n, 38, 70), dtype=np.uint8)).to(dev)
            ref0, ref1 = (torch.from_numpy(rng.integers(
                0, 256, (n, bh * 4, bw * 4), dtype=np.uint8)).to(dev)
                for _ in range(2))
            px, acc = intra_synth(plan, nest, want_acc=True)
            what = f"grid {bh}x{bw} N={n}"
            keep = (bh, bw) == GRIDS_640[0] and n == N_STREAMS
            for want_acc in (False, True):
                timed(f"intra_synth_{'acc' if want_acc else 'noacc'}",
                      lambda: intra_synth(plan, nest, want_acc),
                      lambda: intra_synth_plain(plan, nest, want_acc),
                      intra_bytes(plan, nest, want_acc), what, keep)
            timed("inter_combine",
                  lambda: inter_combine(plan, px, acc, ref0, ref1),
                  lambda: inter_combine_plain(plan, px, acc, ref0, ref1),
                  inter_bytes(plan, ref0, ref1), what, keep)
            del plan, nest, ref0, ref1, px, acc
            torch.cuda.empty_cache()

    for n, w, samp in CSC_TIME_POINTS:
        y, u, v = random_yuv(rng, n, 480, w, samp, dev)
        nbytes = 4 * y.numel() + u.numel() + v.numel()  # Y, U, V in; RGB out
        # fresh planes start aligned, so the width picks the variant
        variant = "vector" if w % 16 == 0 else "general"
        timed("yuv_to_rgb", lambda: yuv_to_rgb(y, u, v, samp, samp),
              lambda: yuv_to_rgb_plain(y, u, v, samp, samp), (nbytes, nbytes),
              f"480x{w} {'4:2:0' if samp == 2 else '4:4:4'} N={n}, {variant} "
              f"variant", (n, w, samp) == (N_STREAMS, 640, 2))
        del y, u, v  # N=64's are 29 MB; each point's RGB dies in timed
        torch.cuda.empty_cache()
    return times


def phase_times(dev, cfg, clips: dict, tag: str) -> dict:
    """Phase 7 timings: `kernel_times` in a process of its own
    (`kernel_times_child`), then the session and lock-step frame rates.
    Returns, per kernel, the luma (or 480x640) N=8 figures."""
    import torch

    from hvqm4_tpu_torch.container import Demuxer
    from hvqm4_tpu_torch.session import DecoderSession

    rc, out, err, secs = run_group(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.kernel_times_child()"], 900)
    lines = out.strip().splitlines()
    if rc != 0 or not lines:
        fail(f"kernel timings: rc {rc}:\n{out[-2000:]}\n{err[-3000:]}")
    print("\n".join(lines[:-1]))
    times = json.loads(lines[-1])
    print(f"kernel timings: {secs:.1f} s in their own process [{tag}]")

    for name, data in clips.items():
        sess = DecoderSession(Demuxer(data).info.cfg, dev, profile=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(1 for _ in sess.decode_clip(data))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        plan_s = sess.timer.totals["plan"]
        print(f"time session {name}: {n} frames in {wall:.4f} s = "
              f"{n / wall:.1f} fps end to end; host planning {plan_s:.4f} s, "
              f"upload+device {wall - plan_s:.4f} s = "
              f"{n / (wall - plan_s):.1f} fps [{tag}]")

    t0 = time.perf_counter()
    steps = lockstep_steps(cfg, clips, dev)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    frames = sum(n for _, n in steps)
    run_lockstep(cfg, steps, dev)  # warm
    t0 = time.perf_counter()
    run_lockstep(cfg, steps, dev)
    dev_s = time.perf_counter() - t0
    lock_bytes = sum(t.numel() * t.element_size()
                     for (plans, *rest), _n in steps
                     for t in [*(v for p in plans for v in p.values()),
                               *rest])
    print(f"time lock-step {N_STREAMS} streams: {frames} frames; host "
          f"planning+stacking+upload {host_s:.4f} s ({frames / host_s:.1f} "
          f"fps), device steps {dev_s:.4f} s ({frames / dev_s:.1f} fps); "
          f"uploads {lock_bytes / frames:.1f} B/frame in 18 copies a step "
          f"[{tag}]")

    device_profile(lambda: run_lockstep(cfg, steps, dev),
                   f"lock-step device steps ({frames} frames)", tag)
    del steps
    arena_fps = arena_times(cfg, clips, dev, tag, frames / host_s,
                            frames / dev_s, lock_bytes / frames)
    consumer_times(cfg, clips, dev, tag, arena_fps)
    retail = clips["retail640.h4m"]
    device_profile(lambda: sum(1 for _ in DecoderSession(
        cfg, dev).decode_clip(retail)), "session retail640.h4m (28 frames)",
        tag)
    return times


STAT_KEYS = ("plan_s", "assemble_s", "stage_s", "upload_s", "dispatch_s",
             "wait_s", "dequeue_s")


def arena_times(cfg, clips: dict, dev, tag: str, lock_host_fps: float,
                lock_dev_fps: float, lock_bytes: float) -> float:
    """Phase 7, the arena path beside the lock-step one: pipelined fps at
    K = 1 and 2 (second of two runs; decoder set-up timed apart), the
    packed replay's device phase, bytes uploaded per frame, the device's
    busy share over a pipelined window and the launches per step. Returns
    the pipelined fps at K = 1."""
    import torch

    from hvqm4_tpu_torch.parallel.multistream import MultiStreamDecoder

    streams = [clips[n] for n in STREAM_CLIPS]

    def pipelined(k):
        t0 = time.perf_counter()
        ms = MultiStreamDecoder(cfg, streams, dev, steps_per_dispatch=k)
        setup = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(sum(valid) for _f, _m, valid in ms.run_pipelined())
        torch.cuda.synchronize()
        return ms, n, time.perf_counter() - t0, setup

    fps_k1 = 0.0
    for k in (1, 2):
        pipelined(k)  # warm: allocator, pinned pages, first launches
        ms, n, wall, setup = pipelined(k)
        if k == 1:
            fps_k1 = n / wall
        split = ", ".join(f"{key[:-2]} {1e3 * ms.stats[key] / n:.4f}"
                          for key in STAT_KEYS)
        print(f"time arena pipelined K={k} {N_STREAMS} streams: {n} frames "
              f"in {wall:.4f} s = {n / wall:.1f} fps end to end "
              f"({int(ms.stats['steps'])} dispatches; decoder set-up "
              f"{setup:.4f} s apart); per frame ms: {split} [{tag}]")

    snaps, valid = plan_replay(cfg, streams, dev)
    n = sum(sum(v) for v in valid)
    up = sum(s["sizes"][0] + 4 * s["sizes"][1] for s in snaps)
    ms = MultiStreamDecoder(cfg, streams, dev)
    packed = None

    def staged():
        nonlocal packed
        bufs = [dict(s) for s in snaps]
        packed = ms.stage_packed(bufs, packed)
        for t in (ms.nest, *ms.ref_prev, *ms.ref_last):
            t.zero_()
        return bufs

    def replay(bufs):
        for b in bufs:
            ms.device_step(b)

    replay(staged())  # warm
    bufs = staged()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    replay(bufs)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    print(f"time arena packed replay {N_STREAMS} streams: {n} frames, "
          f"device phase {dev_s:.4f} s = {n / dev_s:.1f} fps with the plans "
          f"on the card; uploads {up / n:.1f} B/frame in 2 copies a step "
          f"[{tag}]")
    print(f"compare {N_STREAMS} streams: lock-step host {lock_host_fps:.1f} "
          f"fps, device {lock_dev_fps:.1f} fps, {lock_bytes:.1f} B/frame "
          f"uploaded; arena replay device {n / dev_s:.1f} fps, "
          f"{up / n:.1f} B/frame ({lock_bytes / (up / n):.1f}x fewer) [{tag}]")
    bufs = staged()
    res = profile(lambda: replay(bufs))
    if res is None:
        print(f"profile arena packed replay: launches not measured (the "
              f"profiler recorded no CUDA activity) [{tag}]")
    else:
        _wall, rows = res
        ours = sum(c for _us, c, key in rows
                   if "intra_synth" in key or "inter_combine" in key)
        copies = sum(c for _us, c, key in rows if "memcpy" in key.lower())
        total = sum(c for _us, c, _key in rows)
        rest = total - ours - copies
        steps = len(snaps)
        print(f"profile arena packed replay: {steps} steps, device launches "
              f"per step {total / steps:.2f}: the port's kernels "
              f"{ours / steps:.2f}, copies {copies / steps:.2f}, the rest "
              f"(unpack, slots, state rotation) {rest / steps:.2f} [{tag}]")
    # the decoder (pinned ring, step planners) is built before the window
    # opens: the window holds run_pipelined alone
    ms = MultiStreamDecoder(cfg, streams, dev)
    device_profile(lambda: sum(1 for _ in ms.run_pipelined()),
                   f"arena pipelined K=1 ({n} frames, decoder built before "
                   f"the window)", tag)
    return fps_k1


def consumer_times(cfg, clips: dict, dev, tag: str, arena_fps: float) -> None:
    """Phase 7, the consumer paths beside the arena: end-to-end fps of the
    pipeline and of the loader at 224 (second of two runs, the consumer
    synchronising once at the end; set-up apart), the ViT's time per frame
    at batch 1 and at batch 8 on the same images, and the device's busy
    share over one pipeline run."""
    import torch

    from hvqm4_tpu_torch.data import FrameBatchLoader
    from hvqm4_tpu_torch.ops.csc import frame_to_rgb, resize_bilinear
    from hvqm4_tpu_torch.parallel.multistream import MultiStreamDecoder
    from hvqm4_tpu_torch.pipeline import VideoEmbedPipeline, embed_frames

    streams = [clips[n] for n in STREAM_CLIPS]

    def pipeline_run():
        pipe = VideoEmbedPipeline(cfg, streams, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(sum(valid) for _e, _m, valid in pipe.run())
        torch.cuda.synchronize()
        return pipe, n, time.perf_counter() - t0

    def loader_run():
        loader = FrameBatchLoader(cfg, streams, image_size=224, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(sum(valid) for _rgb, valid in loader)
        torch.cuda.synchronize()
        return loader, n, time.perf_counter() - t0

    for what, run in (("pipeline (decode, RGB, resize, ViT at batch "
                       f"{N_STREAMS})", pipeline_run),
                      ("loader at 224 (decode, RGB, resize)", loader_run)):
        run()  # warm
        obj, n, wall = run()
        st = obj.decoder.stats
        split = ", ".join(f"{key[:-2]} {1e3 * st[key] / n:.4f}"
                          for key in STAT_KEYS)
        print(f"time {what} {N_STREAMS} streams: {n} frames in {wall:.4f} s "
              f"= {n / wall:.1f} fps end to end, {1e3 * wall / st['steps']:.3f}"
              f" ms a step; the arena alone {arena_fps:.1f} fps in this run; "
              f"decoder per frame ms: {split} [{tag}]")

    pipe = VideoEmbedPipeline(cfg, streams, device=dev)
    model = pipe.model
    imgs = torch.rand((N_STREAMS, 224, 224, 3),
                      generator=torch.Generator().manual_seed(1)).to(dev)

    def batched():
        return model(imgs)

    def singly():
        return [model(imgs[i:i + 1]) for i in range(N_STREAMS)]

    with torch.no_grad():
        # batch 1, batch 8, batch 8, batch 1: the halves bracket drift
        s1, b1, b2, s2 = (cuda_ms(singly), cuda_ms(batched), cuda_ms(batched),
                          cuda_ms(singly))
        one, many = min(s1, s2) / N_STREAMS, min(b1, b2) / N_STREAMS
        one_us, many_us = device_us_per_call(singly), device_us_per_call(batched)
    per = lambda us: fmt_us(None if us is None else us / N_STREAMS)  # noqa: E731
    print(f"time vit batch 1 vs batch {N_STREAMS} on the same {N_STREAMS} "
          f"images (224x224, dim {model.cfg.dim}, depth {model.cfg.depth}): "
          f"{one:.4f} ms a frame one frame a call, {many:.4f} ms a frame at "
          f"batch {N_STREAMS} ({one / many:.1f}x); device only {per(one_us)} "
          f"and {per(many_us)} a frame [{tag}]")
    # what the consumer adds to an arena step, alone: RGB + resize of one
    # step's frames, and whether anything on the path makes the host wait
    ms = MultiStreamDecoder(cfg, streams, dev)
    ms.step()
    step_syncs = implicit_syncs(ms.step)
    frames = ms.step()[0]
    to_rgb = lambda: resize_bilinear(frame_to_rgb(frames, 2, 2), 224, 224)  # noqa: E731
    embed_syncs = implicit_syncs(
        lambda: embed_frames(model, frames, cfg.h_samp, cfg.v_samp))
    print(f"time csc+resize batch {N_STREAMS} 480x640 -> 224x224: "
          f"{cuda_ms(to_rgb):.4f} ms a step; device only "
          f"{fmt_us(device_us_per_call(to_rgb))}; host synchronisations "
          f"nobody asked for (torch's sync debug mode): {step_syncs} in one "
          f"arena step, {embed_syncs} in one embed of {N_STREAMS} frames "
          f"[{tag}]")
    device_profile(lambda: sum(1 for _ in pipe.run()),
                   f"pipeline ({N_STREAMS} streams, 224 frames, built before "
                   f"the window)", tag)


def implicit_syncs(fn) -> int:
    """The host synchronisations one call of `fn` makes without being asked
    to: torch's sync debug mode warns at each."""
    import warnings

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message).lower() for w in caught)


@functools.lru_cache(maxsize=None)
def oracle_frames(oracle: Path, name: str, cfg) -> tuple:
    """The oracle's decoded frames of a clip (planar YUV bytes each) and
    its per-frame `--hash` lines."""
    path = REPO / "testdata" / name
    SCRATCH.mkdir(parents=True, exist_ok=True)
    out = SCRATCH / f"{name}.yuv"
    subprocess.run([str(oracle), str(path), str(out)], check=True)
    data = out.read_bytes()
    fb = cfg.frame_bytes
    frames = [data[i:i + fb] for i in range(0, len(data), fb)]
    res = subprocess.run([str(oracle), "--hash", str(path), "/dev/null"],
                         check=True, capture_output=True, text=True)
    hashes = [ln.split("hash=")[1] for ln in res.stdout.splitlines()
              if "hash=" in ln]
    return frames, hashes


def split_planes(frame: bytes, cfg) -> list:
    """Planar YUV bytes → [Y, U, V] numpy planes."""
    planes, off = [], 0
    for h, w in cfg.plane_shapes:
        planes.append(np.frombuffer(frame, np.uint8, h * w, off).reshape(h, w))
        off += h * w
    return planes


def ref_rgb(frame: bytes, cfg) -> bytes:
    """The normative integer YUV→RGB (hvqm4_tpu/ops/csc.py) in numpy, chroma
    replicated to full size."""
    y, u, v = split_planes(frame, cfg)
    u, v = (np.repeat(np.repeat(c, cfg.v_samp, 0), cfg.h_samp, 1)
            for c in (u, v))
    yi = y.astype(np.int64)
    ui = u.astype(np.int64) - 128
    vi = v.astype(np.int64) - 128
    r = yi + ((91881 * vi + 32768) >> 16)
    g = yi - ((22554 * ui + 46802 * vi + 32768) >> 16)
    b = yi + ((116130 * ui + 32768) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8).tobytes()


def cpu_embedding(model, frame: bytes, cfg, vcfg) -> np.ndarray:
    """The port's plain CPU path on one oracle frame: RGB, resize, ViT."""
    import torch

    from hvqm4_tpu_torch.ops.csc import frame_to_rgb, resize_bilinear

    planes = [torch.from_numpy(p.copy()) for p in split_planes(frame, cfg)]
    with torch.inference_mode():
        img = resize_bilinear(frame_to_rgb(planes, cfg.h_samp, cfg.v_samp),
                              vcfg.image_size, vcfg.image_size)
        return model(img[None])[0].numpy()


def within_vit_gate(got: np.ndarray, want: np.ndarray) -> tuple:
    """(max abs difference, least cosine) of two (…, dim) embeddings."""
    d = float(np.abs(got - want).max())
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    return d, float(cos.min())


def phase_consumers(dev, cfg, clips: dict, oracle: Path,
                    kernels: list) -> dict:
    """Phase 5c: `FrameBatchLoader` and `VideoEmbedPipeline` on the card at
    8 streams, every output against the oracle's frames; returns the launch
    counts of the class runs. The command-line checks after them are not
    counted."""
    import torch

    from hvqm4_tpu_torch import cli
    from hvqm4_tpu_torch.container import Demuxer
    from hvqm4_tpu_torch.data import FrameBatchLoader
    from hvqm4_tpu_torch.kernels import csc as csc_kernel
    from hvqm4_tpu_torch.native import NativePlanner
    from hvqm4_tpu_torch.ops.csc import resize_bilinear
    from hvqm4_tpu_torch.pipeline import VideoEmbedPipeline

    streams = [clips[n] for n in STREAM_CLIPS]
    # the checked RGB: the integer formula on the oracle's frames, per clip
    # in decode order, on the card; and each clip's display ids
    checked, disp_ids, ftypes = {}, {}, {}
    for name, data in clips.items():
        frames, _hashes = oracle_frames(oracle, name, cfg)
        checked[name] = torch.from_numpy(np.stack([
            np.frombuffer(ref_rgb(f, cfg), np.uint8).reshape(
                cfg.height, cfg.width, 3) for f in frames])).to(dev)
        planner = NativePlanner(cfg)
        recs = list(Demuxer(data).video_records())
        disp_ids[name] = [planner.plan_frame(r.frame_char, r.payload)
                          .display_id for r in recs]
        ftypes[name] = "".join(r.frame_char for r in recs)
    steps = len(checked[CLIPS[0]])
    print(f"consumers: {N_STREAMS} streams of {steps} frames; B frames: "
          + ", ".join(f"{n} {ftypes[n].count('B')}" for n in CLIPS))
    if not any("B" in t for t in ftypes.values()):
        fail("consumers: no clip holds B frames, so the display-order "
             "hold-back would not be exercised")

    def want_batch(t: int):
        return torch.stack([checked[n][t] for n in STREAM_CLIPS])

    def as_u8(rgb):
        return (rgb * 255.0).round().to(torch.uint8)

    taken = collections.Counter()
    vector_ok = csc_kernel._vector_ok

    def spy(*args):
        ok = vector_ok(*args)
        taken["vector" if ok else "general"] += 1
        return ok

    csc_kernel._vector_ok = spy  # which variant each launch takes
    try:
        # loader, decode order, full size
        n_steps = 0
        for t, (rgb, valid) in enumerate(FrameBatchLoader(
                cfg, streams, device=dev, plan_ahead=2)):
            if valid != [True] * N_STREAMS or rgb.dtype != torch.float32 \
                    or tuple(rgb.shape) != (N_STREAMS, 480, 640, 3):
                fail(f"loader step {t}: valid {valid}, {rgb.dtype} "
                     f"{tuple(rgb.shape)}")
            if not torch.equal(as_u8(rgb), want_batch(t)):
                fail(f"loader step {t}: batch x 255 differs from the integer "
                     f"formula on the oracle's frames")
            n_steps += 1
        if n_steps != steps:
            fail(f"loader: {n_steps} steps, want {steps}")
        print(f"loader on {dev}, decode order, full size: {n_steps} batches "
              f"of {N_STREAMS}x480x640x3, x255 == the integer formula on the "
              f"oracle's frames on every stream")

        # loader, decode order, resized
        worst = 0.0
        for t, (rgb, valid) in enumerate(FrameBatchLoader(
                cfg, streams, image_size=224, device=dev)):
            if valid != [True] * N_STREAMS or \
                    tuple(rgb.shape) != (N_STREAMS, 224, 224, 3):
                fail(f"loader 224 step {t}: valid {valid}, "
                     f"{tuple(rgb.shape)}")
            # the resize's weights sum to 1 within float rounding, so a
            # saturated patch may come out a few 1e-7 above 1, as from
            # `jax.image.resize`
            if float(rgb.min()) < 0.0 or float(rgb.max()) > 1.0 + 1e-6:
                fail(f"loader 224 step {t}: values outside [0, 1 + 1e-6]")
            worst = max(worst, float((rgb - resize_bilinear(
                want_batch(t), 224, 224)).abs().max()))
        if worst > 1e-6:
            fail(f"loader 224: max abs {worst} > 1e-6 against "
                 f"resize_bilinear of the checked RGB")
        print(f"loader on {dev}, image_size 224: in [0, 1 + 1e-6], max abs {worst:.1e}"
              f" against resize_bilinear of the checked RGB (bound 1e-6)")

        # loader, display order: the n-th frame a stream delivers is the
        # checked frame whose display id is n
        seen = [0] * N_STREAMS
        items = 0
        for ready in FrameBatchLoader(cfg, streams, device=dev,
                                      display_order=True, plan_ahead=2):
            if not ready:
                fail("loader display order: an empty item")
            items += 1
            for si, frame in ready:
                name = STREAM_CLIPS[si]
                if seen[si] not in disp_ids[name]:
                    fail(f"loader display order: stream {si} delivered more "
                         f"frames than it has")
                t = disp_ids[name].index(seen[si])
                if not torch.equal(as_u8(frame), checked[name][t]):
                    fail(f"loader display order: stream {si} frame "
                         f"{seen[si]} is not display id {seen[si]}")
                seen[si] += 1
        if seen != [steps] * N_STREAMS:
            fail(f"loader display order: frames per stream {seen}, want "
                 f"{steps} each")
        print(f"loader on {dev}, display order: {sum(seen)} frames in {items} "
              f"items, every display id of every stream once and in order, "
              f"each == the checked frame with that id")

        # pipeline: the consumer never waits for the card inside the loop
        runs = {}
        for ahead in (1, 2):
            pipe = VideoEmbedPipeline(cfg, streams, device=dev,
                                      plan_ahead=ahead)
            embs, valids = [], []
            for emb, _metas, valid in pipe.run():
                embs.append(emb)
                valids.append(valid)
            torch.cuda.synchronize()
            if valids != [[True] * N_STREAMS] * steps:
                fail(f"pipeline plan_ahead={ahead}: valid differs from the "
                     f"arena phase's ({len(valids)} steps)")
            got = torch.stack(embs)
            if tuple(got.shape) != (steps, N_STREAMS, pipe.vit_cfg.dim) or \
                    got.dtype != torch.float32 or \
                    not bool(torch.isfinite(got).all()):
                fail(f"pipeline plan_ahead={ahead}: want finite f32 "
                     f"({steps}, {N_STREAMS}, {pipe.vit_cfg.dim}), got "
                     f"{got.dtype} {tuple(got.shape)}")
            runs[ahead] = got.cpu().numpy()
        with torch.no_grad():  # the same model, one frame a call
            single = {n: torch.cat([pipe.model(resize_bilinear(
                checked[n][t], 224, 224)[None]) for t in range(steps)])
                .cpu().numpy() for n in CLIPS}
        want = np.stack([single[n] for n in STREAM_CLIPS], axis=1)
        for ahead, got in runs.items():
            d, cos = within_vit_gate(got, want)
            print(f"pipeline on {dev}, plan_ahead={ahead}: {steps} steps of "
                  f"({N_STREAMS}, {pipe.vit_cfg.dim}) finite embeddings, "
                  f"batch {N_STREAMS} vs one frame a call on the checked RGB: "
                  f"max abs {d:.3e}, least cosine {cos:.7f}")
            # a gate for gross errors (wrong frame, resize or weights): the
            # batched matmuls tile differently from batch 1's
            if not (d <= 2e-2 and cos >= 0.9999):
                fail(f"pipeline plan_ahead={ahead}: max abs {d} > 2e-2 or "
                     f"cosine {cos} < 0.9999 against one frame a call")
        print(f"pipeline: plan_ahead 1 and 2 give "
              f"{'the same bits' if np.array_equal(runs[1], runs[2]) else 'different bits'}")
        torch.cuda.synchronize()
    finally:
        csc_kernel._vector_ok = vector_ok
    launches = {k.symbol: k.launches for k in kernels}
    print(f"consumers: yuv_to_rgb variants taken: {dict(taken)}")

    # the command line on the card (after the counts were read)
    SCRATCH.mkdir(parents=True, exist_ok=True)
    ref = REPO / "testdata" / CLIPS[0]
    demux = Demuxer(clips[CLIPS[0]])
    first = demux.block_video_counts()[0]
    sec = (first + 2.5) * demux.info.usec_per_frame / 1e6
    outs = [SCRATCH / "start_time.yuv", SCRATCH / "start_block.yuv"]
    with contextlib.redirect_stderr(io.StringIO()):
        rcs = [cli.main(["decode", str(ref), str(outs[0]), "--start-time",
                         f"{sec:.6f}"]),
               cli.main(["decode", str(ref), str(outs[1]), "--start-block",
                         "1"])]
    frames, _hashes = oracle_frames(oracle, CLIPS[0], cfg)
    if rcs != [0, 0] or outs[0].read_bytes() != outs[1].read_bytes() or \
            outs[0].read_bytes() != b"".join(frames[first:]):
        fail(f"cli decode --start-time {sec:.6f}: differs from --start-block "
             f"1 or from the oracle's frames {first}.. (exit codes {rcs})")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["stats", str(REPO / "testdata" / CLIPS[1])])
    stats = json.loads(buf.getvalue())
    if rc != 0 or sorted(stats) != ["block_classes", "frames", "modes",
                                    "video_payload_bytes"]:
        fail(f"cli stats {CLIPS[1]}: exit {rc}, keys {sorted(stats)}")
    print(f"cli on {dev}: decode --start-time {sec:.6f} == --start-block 1 "
          f"== the oracle's frames {first}..{len(frames) - 1} of {CLIPS[0]}; "
          f"stats {CLIPS[1]}: frames {stats['frames']}, block classes "
          f"{stats['block_classes']}")
    return launches


# Luma PSNR (dB) of phase 5d's encoded clip, decoded by the oracle, against
# its source, by display id: from `encoder_clip(cfg, src, "cpu")` on a CPU.
# The encoder is deterministic, so the card's run must give the same.
ENCODE_PSNR = (40.15144579922554, 18.014456742058343)


def encoder_source(cfg, clips: dict, oracle: Path) -> list:
    """The first two frames of ref640.h4m in display order, as the oracle
    decodes them: [[Y, U, V] numpy planes] x 2."""
    from hvqm4_tpu_torch.container import Demuxer
    from hvqm4_tpu_torch.native import NativePlanner

    frames, _hashes = oracle_frames(oracle, CLIPS[0], cfg)
    planner = NativePlanner(cfg)
    disp = [planner.plan_frame(r.frame_char, r.payload).display_id
            for r in Demuxer(clips[CLIPS[0]]).video_records()]
    return [split_planes(frames[disp.index(d)], cfg) for d in (0, 1)]


def encoder_clip(cfg, src: list, device) -> tuple:
    """The phase's encode, ["IP"] with the full-nest search on `device`:
    (clip bytes, per `_encode_frame` call a dict of the frame type, its
    seconds, the seconds inside the host's motion search `_mb_search`, and
    the calls of and seconds inside `NestSearch.best`)."""
    from hvqm4_tpu_torch.encode import VideoEncoder
    from hvqm4_tpu_torch.encode_tpu import NestSearch

    enc = VideoEncoder(cfg, use_tpu_search=True, device=device)
    spent, cur = [], {}

    def clocked(fn, key):
        def inner(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                cur[key] = cur.get(key, 0.0) + time.perf_counter() - t0
                cur[key + "_calls"] = cur.get(key + "_calls", 0) + 1
        return inner

    encode_frame = enc._encode_frame

    def frame(ftype, *args):
        cur.clear()
        t0 = time.perf_counter()
        payload = encode_frame(ftype, *args)
        spent.append({"ftype": ftype, "s": time.perf_counter() - t0, **cur})
        return payload

    enc._encode_frame = frame
    enc._mb_search = clocked(enc._mb_search, "motion")
    best = NestSearch.best
    NestSearch.best = clocked(best, "best")
    try:
        return enc.encode(src, ["IP"]), spent
    finally:
        NestSearch.best = best


def luma_psnr(cfg, src: list, decoded: list, disp: list) -> list:
    """PSNR in dB of each decoded frame's luma against its source frame,
    ordered by display id."""
    out = {}
    for frame, d in zip(decoded, disp):
        y = split_planes(frame, cfg)[0].astype(np.float64)
        mse = float(np.mean((y - src[d][0].astype(np.float64)) ** 2))
        out[d] = 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    return [out[d] for d in sorted(out)]


def oracle_decode(oracle: Path, path: Path, cfg) -> list:
    """The oracle's decode of the clip at `path`: planar YUV bytes a frame."""
    out = path.with_suffix(".yuv")
    subprocess.run([str(oracle), str(path), str(out)], check=True)
    data = out.read_bytes()
    return [data[i:i + cfg.frame_bytes]
            for i in range(0, len(data), cfg.frame_bytes)]


def session_csums(cfg, data: bytes, dev) -> list:
    from hvqm4_tpu_torch.session import DecoderSession
    from hvqm4_tpu_torch.utils.hashing import frame_csum

    return [f"{int(frame_csum(f.planes)):08x}"
            for f in DecoderSession(cfg, dev).decode_clip(data)]


def phase_encoder(dev, cfg, clips: dict, oracle: Path, kernels: list,
                  tag: str) -> dict:
    """Phase 5d: the encoder side at 640x480 on the card: the full-nest
    search against its CPU run, an encode with the search on the card and a
    `cli transcode`, both clips against the oracle through the session on
    the card. Returns the launch counts of the phase; the times come after
    the counts were read."""
    import torch

    from hvqm4_tpu_torch import cli
    from hvqm4_tpu_torch.container import Demuxer
    from hvqm4_tpu_torch.encode import _blockify
    from hvqm4_tpu_torch.encode_tpu import NestSearch
    from hvqm4_tpu_torch.plans import build_nest
    from hvqm4_tpu_torch.utils.hashing import oracle_csums

    SCRATCH.mkdir(parents=True, exist_ok=True)
    src = encoder_source(cfg, clips, oracle)

    # the search: the first frame's luma residuals around their block means
    bh, bw = cfg.block_grids[0]
    blocks = _blockify(src[0][0]).astype(np.int32).reshape(bh, bw, 16)
    dcg = np.clip(np.round(blocks.mean(2)), 0, 255).astype(np.uint8)
    nest = build_nest(cfg, dcg, 0, 0)
    resid = blocks.reshape(-1, 16) - dcg.reshape(-1, 1).astype(np.int32)
    on_card, on_cpu = NestSearch(nest, dev), NestSearch(nest, "cpu")
    if not on_card.ok:
        fail("encoder: the nest of ref640's first frame has no candidate")
    got, want = on_card.best(resid), on_cpu.best(resid)
    for what, g, w in zip(("descriptors", "terms", "scales"), got, want):
        if not np.array_equal(g, w):
            bad = int(np.argwhere((g != w).reshape(len(g), -1).any(1))[0, 0])
            fail(f"encoder: the search on {dev} and on the CPU differ in "
                 f"their {what}, first at residual {bad}")
    print(f"nest search on {dev}: {len(resid)} residuals x "
          f"{len(on_card.C)} candidates, descriptors, terms and scales == "
          f"the CPU's; {int((got[2] != 0).sum())} non-zero scales")

    # the encode with the search on the card
    clip_a, spent = encoder_clip(cfg, src, dev)
    path_a = SCRATCH / "encoded.h4m"
    path_a.write_bytes(clip_a)
    info = Demuxer(clip_a).info
    if info.cfg != cfg or info.video_frames != 2:
        fail(f"encoder: the clip is {info.cfg} with {info.video_frames} "
             f"frames")
    want_a = oracle_csums(oracle, path_a)
    if session_csums(cfg, clip_a, dev) != want_a or len(want_a) != 2:
        fail(f"encoder: the encoded clip through the session on {dev} "
             f"differs from oracle --csum")
    psnr = luma_psnr(cfg, src, oracle_decode(oracle, path_a, cfg), [0, 1])
    print(f"encode on {dev} (search on the card, [\"IP\"]): {len(clip_a)} "
          f"bytes, session csum == oracle on both frames; luma PSNR of the "
          f"oracle's decode against the source "
          f"{', '.join(f'{p:.6f}' for p in psnr)} dB")
    if any(abs(p - w) > 1e-9 for p, w in zip(psnr, ENCODE_PSNR)):
        fail(f"encoder: luma PSNR {psnr} differs from the CPU run's "
             f"{list(ENCODE_PSNR)}")

    # transcode on the default device (the card)
    path_b = SCRATCH / "transcoded.h4m"
    path_b.unlink(missing_ok=True)
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["transcode", str(path_a), str(path_b), "--gops", "IP"])
    transcode_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"cli transcode: exit {rc}: {err.getvalue().strip()}")
    clip_b = path_b.read_bytes()
    info_b = Demuxer(clip_b).info
    if (info_b.cfg, info_b.video_frames, info_b.usec_per_frame) != \
            (cfg, 2, info.usec_per_frame):
        fail(f"cli transcode: {info_b.cfg}, {info_b.video_frames} frames, "
             f"{info_b.usec_per_frame} us a frame")
    want_b = oracle_csums(oracle, path_b)
    if session_csums(cfg, clip_b, dev) != want_b or len(want_b) != 2:
        fail(f"cli transcode: the result through the session on {dev} "
             f"differs from oracle --csum")
    print(f"cli transcode on {dev}: {err.getvalue().strip()}; geometry, "
          f"frame count and usec_per_frame kept, session csum == oracle on "
          f"both frames")
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in kernels}

    # times (after the counts were read)
    best_ms = cuda_ms(lambda: on_card.best(resid))
    cpu_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        on_cpu.best(resid)
        cpu_s.append(time.perf_counter() - t0)
    build_s = []
    for device in (dev, "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        NestSearch(nest, device)
        torch.cuda.synchronize()
        build_s.append(time.perf_counter() - t0)
    print(f"time nest search best B={len(resid)} x {len(on_card.C)} "
          f"candidates: {best_ms:.4f} ms a call on {dev} (CUDA events, "
          f"median of 20, the upload and the three downloads inside), "
          f"{1e3 * statistics.median(cpu_s):.1f} ms on the CPU (host clock, "
          f"median of 3); construction {1e3 * build_s[0]:.2f} ms on {dev}, "
          f"{1e3 * build_s[1]:.2f} ms on the CPU [{tag}]")
    print("time encode 640x480, search on the card: " + ", ".join(
        f"{f['ftype']} frame {f['s']:.3f} s (host motion search "
        f"{f.get('motion', 0.0):.3f} s in {f.get('motion_calls', 0)} calls, "
        f"NestSearch.best {f.get('best', 0.0):.3f} s in "
        f"{f.get('best_calls', 0)} calls)" for f in spent)
          + f"; cli transcode (decode on the card, the sampled host search, "
          f"[\"IP\"]) {transcode_s:.3f} s [{tag}]")
    return launches


CPU_STEPS = 3  # the first steps, replayed on the CPU from the same weights
PARAM_BOUND = 1.6e-2  # max abs, tests/test_torch_train.py's Adam bound
SOAK_SEEDS = (5000, 6)  # scripts/soak_device_torch.py: base seed, cases


def phase_train(dev, cfg, clips: dict, kernels: list, tag: str) -> tuple:
    """Phase 5e: the training path on the card. The default ViT and the
    mean-RGB probe of `examples/train_vit_torch.py` train for two epochs on
    the 8 streams through `FrameBatchLoader(image_size=224)`; the first
    steps are replayed on the CPU; then, after the counts were read, the
    times and the soak. Returns (the launch counts of the two epochs, the
    decode steps they ran, the first two losses, epoch 2's train_fps)."""
    import torch

    from examples.train_vit_torch import (loss_fn, make_optimizer,
                                          make_probe, train_step, weight_of)
    from hvqm4_tpu_torch.data import FrameBatchLoader
    from hvqm4_tpu_torch.models.vit import ViTConfig
    from hvqm4_tpu_torch.pipeline import VideoEmbedPipeline
    from scripts.soak_device_torch import run as soak

    vcfg = ViTConfig()
    streams = [clips[n] for n in STREAM_CLIPS]

    def loader():
        return FrameBatchLoader(cfg, streams, image_size=vcfg.image_size,
                                device=dev)

    def cpu_copy(model, head):  # a copy, also where dev is the CPU
        return ({k: v.to("cpu", copy=True)
                 for k, v in model.state_dict().items()},
                *(t.detach().to("cpu", copy=True) for t in head))

    def opt_copy(opt):  # Adam's state, moved to the CPU
        sd = opt.state_dict()
        return {"param_groups": copy.deepcopy(sd["param_groups"]),
                "state": {i: {k: v.to("cpu", copy=True) for k, v in st.items()}
                          for i, st in sd["state"].items()}}

    model, head = make_probe(vcfg, dev, seed=0)
    opt = make_optimizer(model, head)

    # epoch 1: the first batches, and the weights and Adam's state before
    # and after each of their steps, kept for the CPU; the gradients of
    # step 2 (step 1 trains only the zero head)
    losses, batches, before, after = [], [], [], []
    for t, (images, valid) in enumerate(loader()):
        weight = weight_of(valid, dev)
        if t < CPU_STEPS:
            batches.append((images.cpu(), weight.cpu()))
            before.append((cpu_copy(model, head), opt_copy(opt)))
        losses.append(train_step(model, head, opt, images, weight))
        if t == 1:
            dead = sorted(n for n, p in model.named_parameters()
                          if p.grad is None or not bool(p.grad.any()))
            b2 = sorted(n for n, _p in model.named_parameters()
                        if n.endswith(".b2"))
            if dead != b2 or any(model.get_parameter(n).grad is not None
                                 for n in b2):
                fail(f"train step 2: leaves without a gradient {dead}, want "
                     f"exactly the never-added b2 {b2} (grad None)")
        if t < CPU_STEPS:
            after.append(cpu_copy(model, head))
    steps1 = len(losses)

    # epoch 2, timed: the host clock over the epoch, CUDA events between
    # the loader, forward, backward and opt.step of every step
    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    spans, frames, it = [], 0, iter(loader())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        marks = [event()]
        batch = next(it, None)
        if batch is None:
            break
        images, valid = batch
        weight = weight_of(valid, dev)
        marks.append(event())
        opt.zero_grad(set_to_none=True)  # what train_step does, timed apart
        loss = loss_fn(model, *head, images, weight)
        marks.append(event())
        loss.backward()
        marks.append(event())
        opt.step()
        marks.append(event())
        losses.append(loss.detach())
        spans.append(marks)
        frames += sum(valid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in kernels}
    steps = steps1 + len(spans)

    hist = torch.stack(losses).cpu()
    first, second = float(hist[0]), float(hist[steps1:].mean())
    if not bool(torch.isfinite(hist).all()):
        fail(f"train: a loss is not finite: {hist.tolist()}")
    if not second < first:
        fail(f"train: epoch 2's mean loss {second} is not below the first "
             f"step's {first}")
    print(f"train on {dev}: default ViT ({vcfg.image_size}x"
          f"{vcfg.image_size}, patch {vcfg.patch_size}, dim {vcfg.dim}, "
          f"depth {vcfg.depth}, {vcfg.heads} heads) + mean-RGB probe, Adam "
          f"1e-3, {N_STREAMS} streams, 2 epochs of {steps1} and "
          f"{len(spans)} steps: every loss finite, first {first:.6f}, epoch "
          f"2 mean {second:.6f}, last {float(hist[-1]):.6f}; step 2 gave "
          f"every ViT leaf but the never-added b2 a non-zero gradient")

    # the first batches through train_step on the CPU: each step from the
    # card's weights and Adam state before it, then all of them from the
    # start. Adam's first steps move an element by about lr whatever the
    # size of its gradient, so where a near-zero gradient's sign differs
    # the runs part by 2 lr an element and step; chained, that moves the
    # ViT and the later losses, so the loss bound holds step by step.
    def cpu_steps(state, steps):
        cpu_model, cpu_head = make_probe(vcfg, "cpu", params=state[0])
        cpu_opt = make_optimizer(cpu_model, cpu_head)
        cpu_opt.load_state_dict(state[1])
        return ([float(train_step(cpu_model, cpu_head, cpu_opt, im, w))
                 for im, w in steps], cpu_copy(cpu_model, cpu_head))

    def param_diff(a, b):
        return max(float((x.float() - y.float()).abs().max())
                   for x, y in zip([*a[0].values(), *a[1:]],
                                   [*b[0].values(), *b[1:]]))

    card = [float(x) for x in hist[:CPU_STEPS]]
    rel, diff = [], []
    for t in range(CPU_STEPS):
        (cpu_loss,), got = cpu_steps(before[t], batches[t:t + 1])
        rel.append(abs(card[t] - cpu_loss) / abs(cpu_loss))
        diff.append(param_diff(after[t], got))
    chained, got = cpu_steps(before[0], batches)
    chained_diff = param_diff(after[-1], got)
    print(f"train card vs CPU, {CPU_STEPS} steps on the same batches: "
          f"losses on the card {[round(x, 6) for x in card]}; each step from "
          f"the card's weights and Adam state: losses relative "
          f"{', '.join(f'{x:.3e}' for x in rel)} (bound 2e-2), parameters "
          f"max abs {', '.join(f'{x:.3e}' for x in diff)} (bound "
          f"{PARAM_BOUND}); chained from the same start: losses on the CPU "
          f"{[round(x, 6) for x in chained]}, parameters max abs "
          f"{chained_diff:.3e} (bound {PARAM_BOUND})")
    if not (max(rel) <= 2e-2 and max(diff + [chained_diff]) <= PARAM_BOUND):
        fail(f"train: the card and the CPU differ (losses {rel}, "
             f"parameters {diff}, chained {chained_diff})")

    # times (after the counts were read)
    parts = [[m[i].elapsed_time(m[i + 1]) for m in spans] for i in range(4)]
    split = ", ".join(f"{what} {statistics.mean(p):.3f}" for what, p in zip(
        ("loader", "forward", "backward", "opt.step"), parts))
    print(f"time train epoch 2 {N_STREAMS} streams: {frames} frames in "
          f"{wall:.4f} s = {frames / wall:.1f} train_fps, "
          f"{1e3 * wall / len(spans):.3f} ms a step; CUDA events, mean ms a "
          f"step: {split} [{tag}]")
    weight = weight_of(valid, dev)  # with images: epoch 2's last batch
    res = profile(lambda: train_step(model, head, opt, images, weight))
    if res is None:
        print(f"profile train step: launches not measured (the profiler "
              f"recorded no CUDA activity) [{tag}]")
    else:
        rows = res[1]
        copies = sum(c for _us, c, key in rows
                     if "memcpy" in key.lower() or "memset" in key.lower())
        total = sum(c for _us, c, _key in rows)
        print(f"profile train step (batch {N_STREAMS}): {total} device "
              f"launches, {total - copies} kernels and {copies} copies or "
              f"fills; device {sum(r[0] for r in rows) / 1e3:.3f} ms [{tag}]")
    syncs = implicit_syncs(lambda: train_step(model, head, opt, images,
                                              weight_of(valid, dev)))
    print(f"train: host synchronisations nobody asked for in one train step "
          f"(torch's sync debug mode): {syncs}")

    def epoch():
        for images, valid in loader():
            train_step(model, head, opt, images, weight_of(valid, dev))

    device_profile(epoch, f"train epoch 3 (as epoch 2, {N_STREAMS} streams, "
                   f"under the profiler)", tag)

    def embed_run():
        pipe = VideoEmbedPipeline(cfg, streams, vcfg, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(sum(valid) for _e, _m, valid in pipe.run())
        torch.cuda.synchronize()
        return n, time.perf_counter() - t0

    embed_run()  # warm
    n, embed_s = embed_run()
    print(f"time embed beside train {N_STREAMS} streams: embed_fps "
          f"{n / embed_s:.1f} (VideoEmbedPipeline, same ViT config, "
          f"inference) against train_fps {frames / wall:.1f} [{tag}]")

    base, cases = SOAK_SEEDS
    descs = soak(cases, base, dev, log=lambda s: None)
    for d in descs:
        print(f"soak on {dev}: {d}: every stream == the oracle's bytes")
    return launches, steps, card[:2], frames / wall



SHARDED_MESH = (2, 2)  # dp, tp: phase 5f's 4 ranks on the one card (gloo)
SHARDED_EPOCHS = 2  # of training on each mesh; train_fps is the last's
# the collectives phase 5f tries with gloo on CUDA tensors (the design
# needs all_reduce alone)
GLOO_PROBES = ("all_reduce", "broadcast", "all_gather_into_tensor",
               "reduce_scatter_tensor")


def probe_collectives(dev) -> list:
    """The `GLOO_PROBES` the process group runs on a CUDA tensor of `dev`;
    every rank tries each in the same order."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size()
    x = torch.ones(4 * world, device=dev)
    calls = {"all_reduce": lambda: dist.all_reduce(x),
             "broadcast": lambda: dist.broadcast(x, 0),
             "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                 torch.empty(4 * world * world, device=dev), x),
             "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                 torch.empty(4, device=dev), x)}
    ok = []
    for name in GLOO_PROBES:
        try:
            with warnings.catch_warnings():  # the _tensor forms' deprecation
                warnings.simplefilter("ignore", FutureWarning)
                calls[name]()
            torch.cuda.synchronize(dev)
            ok.append(name)
        except RuntimeError:
            pass
    return ok


def all_reduce_ms(numel: int, group, dev, reps: int = 10) -> float:
    """Host ms of one f32 all-reduce of `numel` elements on `dev` over
    `group`, synchronised, mean of `reps` after one warm-up."""
    import torch
    import torch.distributed as dist

    x = torch.ones(numel, device=dev)
    dist.all_reduce(x, group=group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(x, group=group)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def sharded_rank(dev, dp: int, tp: int, cfg, streams: list, want: list,
                 epochs: int) -> dict:
    """One rank of phase 5f on a ("dp", "tp") mesh: the sharded decode
    (`MultiStreamDecoder(sharding=…)`, csums), `VideoEmbedPipeline(mesh=…)`
    and `epochs` of training (`FrameBatchLoader(mesh=…)`, `train_step`
    with the "dp" group), all counted; then, uncounted, the unsharded
    pipeline on this rank's own streams for the embedding gate."""
    import torch
    import torch.distributed as dist

    from examples.train_vit_torch import (make_optimizer, make_probe,
                                          train_step, weight_of)
    from hvqm4_tpu_torch.data import FrameBatchLoader
    from hvqm4_tpu_torch.kernels import _build
    from hvqm4_tpu_torch.models.vit import ViTConfig, shard_vit_params
    from hvqm4_tpu_torch.parallel.dist import make_mesh
    from hvqm4_tpu_torch.parallel.multistream import (MultiStreamDecoder,
                                                      shard_streams)
    from hvqm4_tpu_torch.pipeline import VideoEmbedPipeline

    t_start = time.perf_counter()
    mesh = make_mesh(dp, tp, dev.type)
    shard = shard_streams(mesh, "dp")
    n = len(streams) // dp
    lo = shard.index * n
    vcfg = ViTConfig()
    collectives = probe_collectives(dev)
    kernels = _build.kernels()
    for k in kernels:
        k.launches = 0
    ms = MultiStreamDecoder(cfg, streams, dev, sharding=shard)
    got = arena_csums(ms, ms.run_pipelined())
    steps = {"decode": int(ms.stats["steps"])}
    embs = [(e.cpu().numpy(), v) for e, _m, v in VideoEmbedPipeline(
        cfg, streams, vcfg, device=dev, mesh=mesh).run()]
    steps["embed"] = len(embs)
    model, head = make_probe(vcfg, dev, seed=0)
    shard_vit_params(model, mesh, "tp")
    opt = make_optimizer(model, head)
    group = mesh.get_group("dp")
    losses, walls = [], []
    for _ in range(epochs):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for images, valid in FrameBatchLoader(
                cfg, streams, image_size=vcfg.image_size, device=dev,
                mesh=mesh):
            losses.append(train_step(model, head, opt, images,
                                     weight_of(valid, dev), group))
        torch.cuda.synchronize()
        dist.barrier()
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in kernels}
    steps["train"] = len(losses)
    # what one step's collectives cost here: a tp all-reduce of one
    # block's activations (4 a block where tp > 1: 2 forward, 2 backward)
    # and the dp all-reduce of the gradients and the loss
    grads = 1 + sum(p.numel() for p in model.parameters()
                    if p.grad is not None) + 3 * vcfg.dim + 3
    sizes = {"tp": (n * vcfg.n_patches * vcfg.dim,
                    4 * vcfg.depth if tp > 1 else 0),
             "dp": (grads, 1)}
    coll_ms = {axis: (4 * numel / 1e6, all_reduce_ms(
        numel, mesh.get_group(axis), dev), per_step)
        for axis, (numel, per_step) in sizes.items()}
    ref = [e.cpu().numpy() for e, _m, _v in VideoEmbedPipeline(
        cfg, streams[lo:lo + n], vcfg, device=dev).run()]
    gate = [within_vit_gate(e, r) for (e, _v), r in zip(embs, ref)]
    return {"rank": dist.get_rank(), "streams": (lo, lo + n),
            "csum_ok": all(got[j] == want[lo + j] for j in range(n)),
            "frames": sum(map(len, got)), "launches": launches,
            "steps": steps, "losses": torch.stack(losses).cpu().tolist(),
            "walls": walls, "collectives": collectives,
            "all_reduce_ms": coll_ms,
            "embed_gate": (max(d for d, _c in gate), min(c for _d, c in gate)),
            "valid_all": all(all(v) for _e, v in embs),
            "leaked": sorted(m for m in sys.modules if m.split(".")[0] in
                             ("hvqm4_tpu", "jax", "jaxlib")),
            "seconds": time.perf_counter() - t_start}


def phase_sharded(cfg, clips: dict, want: dict, single: tuple,
                  tag: str) -> dict:
    """Phase 5f: the sharded path at full width, 4 ranks of a dp=2 x tp=2
    mesh on the one card through gloo, then world size 1 through nccl.
    `single` is phase 5e's (first two losses, train_fps). Gates every
    rank; returns the launch counts summed over the ranks of both runs."""
    from hvqm4_tpu_torch.parallel.dist import launch

    t0 = time.perf_counter()
    streams = [clips[n] for n in STREAM_CLIPS]
    csums = [want[n] for n in STREAM_CLIPS]
    dp, tp = SHARDED_MESH
    total: dict = collections.Counter()
    for backend, dp_, tp_ in (("gloo", dp, tp), ("nccl", 1, 1)):
        t1 = time.perf_counter()
        out = launch(sharded_rank, dp_ * tp_, dp_, tp_, cfg, streams, csums,
                     SHARDED_EPOCHS, device="cuda", backend=backend)
        spent = time.perf_counter() - t1
        where = f"dp={dp_} tp={tp_}, {dp_ * tp_} rank(s) on one card, {backend}"
        for r in out:
            steps = r["steps"]
            if not r["csum_ok"] or r["frames"] != 28 * N_STREAMS // dp_:
                fail(f"sharded ({where}) rank {r['rank']}: streams "
                     f"{r['streams']} differ from the oracle")
            if r["leaked"]:
                fail(f"sharded rank {r['rank']} imported {r['leaked']}")
            d, cos = r["embed_gate"]
            if not (d <= 2e-2 and cos >= 0.9999 and r["valid_all"]):
                fail(f"sharded ({where}) rank {r['rank']}: embeddings max abs "
                     f"{d}, cosine {cos} against the unsharded model")
            rel = [abs(a - b) / abs(b) for a, b in zip(r["losses"], single[0])]
            if max(rel) > 1e-3:
                fail(f"sharded ({where}) rank {r['rank']}: first losses "
                     f"{r['losses'][:2]} against one device's {single[0]}")
            decoded = steps["decode"] + steps["embed"] + steps["train"]
            for sym, n in (("hvqm4_intra_synth_acc", 3 * decoded),
                           ("hvqm4_inter_combine", 3 * decoded),
                           ("hvqm4_yuv_to_rgb",
                            steps["embed"] + steps["train"]),
                           ("hvqm4_intra_synth_noacc", 0)):
                if r["launches"][sym] != n:
                    fail(f"sharded rank {r['rank']}: {sym} launched "
                         f"{r['launches'][sym]} times, want {n}")
            total.update(r["launches"])
            print(f"sharded {where}, rank {r['rank']} (streams "
                  f"{r['streams'][0]}-{r['streams'][1] - 1}): {r['frames']} "
                  f"frames csum == oracle; embeddings max abs {d:.3e}, "
                  f"cosine {cos:.7f} against the unsharded model on its "
                  f"streams; losses {[round(x, 6) for x in r['losses'][:2]]}"
                  f" (one device {[round(x, 6) for x in single[0]]}, "
                  f"relative {max(rel):.2e}); launches {r['launches']} over "
                  f"{steps} steps; {r['seconds']:.1f} s in the rank; "
                  f"collectives on CUDA tensors: {r['collectives']}")
        losses = out[0]["losses"]
        if not all(r["losses"] == losses for r in out):
            fail(f"sharded ({where}): the ranks' loss histories differ")
        wall = out[0]["walls"][-1]
        coll = out[0]["all_reduce_ms"]
        step_ms = 1e3 * wall / (len(losses) // SHARDED_EPOCHS)
        print(f"time sharded collectives ({where}), rank 0, f32 on CUDA "
              f"tensors, mean of 10: " + ", ".join(
                  f"{a} all-reduce of {mb:.3f} MB {ms:.3f} ms" for a, (
                      mb, ms, _k) in coll.items())
              + f"; a train step's {coll['tp'][2]} tp and 1 dp of them: "
              f"{sum(ms * k for _mb, ms, k in coll.values()):.1f} ms of its "
              f"{step_ms:.1f} ms [{tag}]")
        print(f"time sharded train ({where}), epoch {len(out[0]['walls'])} "
              f"of the default ViT on {N_STREAMS} streams: "
              f"{28 * N_STREAMS} frames in {wall:.4f} s = "
              f"{28 * N_STREAMS / wall:.1f} train_fps of {dp_ * tp_} rank(s) "
              f"on one card, beside one device's {single[1]:.1f} train_fps "
              f"without a process group (phase 5e); the launch {spent:.1f} s "
              f"[{tag}]")
    print(f"phase 5f (sharded): {time.perf_counter() - t0:.1f} s [{tag}]")
    return dict(total)


def phase_serve(dev, cfg, clips: dict, oracle: Path, kernels: list,
                tag: str) -> dict:
    """Phase 6: the port's decode service on the card. Checks every reply,
    takes the launch counts right after the checked requests, then times
    requests, the ViT and the resize; returns the counts."""
    import torch

    from hvqm4_tpu_torch import serve
    from hvqm4_tpu_torch.ops.csc import resize_bilinear
    from hvqm4_tpu_torch.utils.hashing import fnv1a

    modes = {"yuv": serve.MODE_YUV, "rgb": serve.MODE_RGB,
             "embed": serve.MODE_EMBED}
    srv = serve.DecodeServer(("127.0.0.1", 0), device=dev)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address
    try:
        replies = {}
        for name, data in clips.items():
            frames, hashes = oracle_frames(oracle, name, cfg)
            for mode, m in modes.items():
                t0 = time.perf_counter()
                chunks = serve.decode_remote(host, port, data, mode=m)
                replies[name, mode] = chunks
                print(f"serve {name} {mode}: {len(chunks)} chunks, first "
                      f"request {time.perf_counter() - t0:.4f} s [{tag}]")
            if [f"{fnv1a(c):08x}" for c in replies[name, "yuv"]] != hashes:
                fail(f"serve {name} yuv: FNV-1a differs from oracle --hash")
            if replies[name, "rgb"] != [ref_rgb(f, cfg) for f in frames]:
                fail(f"serve {name} rgb: differs from the integer formula "
                     f"on the oracle's frames")
            emb = [np.frombuffer(c, "<f4") for c in replies[name, "embed"]]
            vcfg, model = srv._vit
            if len(emb) != len(frames) or any(
                    e.shape != (vcfg.dim,) or not np.isfinite(e).all()
                    for e in emb):
                fail(f"serve {name} embed: want {len(frames)} finite "
                     f"{vcfg.dim}-vectors")
            cpu_model = copy.deepcopy(model).to("cpu")
            for i in (0, len(frames) - 1):
                want = cpu_embedding(cpu_model, frames[i], cfg, vcfg)
                d = float(np.abs(emb[i] - want).max())
                cos = float(emb[i] @ want / np.linalg.norm(emb[i])
                            / np.linalg.norm(want))
                print(f"serve {name} embed frame {i}: card vs CPU max abs "
                      f"{d:.3e}, cosine {cos:.7f}")
                # a gate for gross errors (frame, resize, weights on the
                # card): faults of the bf16 dtype flow hide inside it and
                # are held part by part in tests/test_torch_vit.py
                if not (d <= 2e-2 and cos >= 0.9999):
                    fail(f"serve {name} embed frame {i}: max abs {d} > 2e-2 "
                         f"or cosine {cos} < 0.9999 against the CPU ViT")
            print(f"serve {name}: yuv FNV-1a == oracle --hash, rgb == integer "
                  f"formula on the oracle's frames, embed within tolerance")

        jobs = [(CLIPS[0], "yuv"), (CLIPS[1], "rgb"), (CLIPS[0], "embed"),
                (CLIPS[1], "yuv")]
        with serve.MuxClient(host, port) as mc:
            ids = [mc.submit(clips[n], modes[m]) for n, m in jobs]
            for (n, m), rid in reversed(list(zip(jobs, ids))):
                if mc.result(rid, timeout=300) != replies[n, m]:
                    fail(f"serve mux {n} {m}: differs from the single-shot "
                         f"reply")
        metrics = serve.fetch_metrics(host, port)
        want_modes = {m: 2 + sum(j[1] == m for j in jobs) for m in modes}
        if metrics["by_mode"] != want_modes or metrics["errors"] != 0:
            fail(f"serve metrics: by_mode {metrics['by_mode']} errors "
                 f"{metrics['errors']}, want {want_modes} and 0")
        print(f"serve mux: {len(jobs)} mixed requests over one connection "
              f"== single-shot replies; metrics by_mode {metrics['by_mode']}")
        cli_remote(host, port, oracle, cfg)
        batched_serve(dev, clips, replies, tag)
        torch.cuda.synchronize()
        launches = {k.symbol: k.launches for k in kernels}

        for name, data in clips.items():
            for mode, m in modes.items():
                lat = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    serve.decode_remote(host, port, data, mode=m)
                    lat.append(time.perf_counter() - t0)
                print(f"time serve {name} {mode}: request latency median "
                      f"{statistics.median(lat):.4f} s of "
                      f"{[round(x, 4) for x in lat]} (28 frames) [{tag}]")
        retail = clips[CLIPS[1]]
        device_profile(lambda: serve.decode_remote(host, port, retail,
                                                   mode=serve.MODE_EMBED),
                       f"serve {CLIPS[1]} embed request (28 frames)", tag)
        vcfg, model = srv._vit
        img = torch.rand((1, vcfg.image_size, vcfg.image_size, 3),
                         generator=torch.Generator().manual_seed(0)).to(dev)
        rgb = torch.from_numpy(np.frombuffer(
            replies[CLIPS[1], "rgb"][0], np.uint8).reshape(480, 640, 3)
            .copy()).to(dev)
        with torch.inference_mode():
            print(f"time vit: {cuda_ms(lambda: model(img)):.4f} ms per frame "
                  f"(224x224, dim {vcfg.dim}, depth {vcfg.depth}, batch 1); "
                  f"device only {fmt_us(device_us_per_call(lambda: model(img)))} "
                  f"[{tag}]")
            resize = lambda: resize_bilinear(rgb, 224, 224)  # noqa: E731
            print(f"time resize_bilinear 480x640 -> 224x224: "
                  f"{cuda_ms(resize):.4f} ms per frame; device only "
                  f"{fmt_us(device_us_per_call(resize))} [{tag}]")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    return launches


def cli_remote(host: str, port: int, oracle: Path, cfg) -> None:
    """`cli remote` against the running server: one clip in YUV, hashed
    against `oracle --hash`, and the metrics snapshot."""
    from hvqm4_tpu_torch import cli
    from hvqm4_tpu_torch.utils.hashing import fnv1a

    name = CLIPS[1]
    _frames, hashes = oracle_frames(oracle, name, cfg)
    out = SCRATCH / "remote.yuv"
    with contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["remote", f"{host}:{port}",
                       str(REPO / "testdata" / name), str(out)])
    data = out.read_bytes() if rc == 0 else b""
    fb = cfg.frame_bytes
    got = [f"{fnv1a(data[i:i + fb]):08x}" for i in range(0, len(data), fb)]
    if rc != 0 or got != hashes:
        fail(f"cli remote {name}: exit {rc}, {len(got)} frames; FNV-1a "
             f"differs from oracle --hash")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["remote", f"{host}:{port}", "--metrics"])
    metrics = json.loads(buf.getvalue())
    if rc != 0 or metrics["requests_total"] < 1 or metrics["errors"] != 0:
        fail(f"cli remote --metrics: exit {rc}, {metrics}")
    print(f"cli remote {name}: {len(got)} frames, FNV-1a == oracle --hash; "
          f"--metrics: requests_total {metrics['requests_total']}, by_mode "
          f"{metrics['by_mode']}")


def batched_serve(dev, clips: dict, replies: dict, tag: str) -> None:
    """Phase 6's batching server: four concurrent requests, both clips in
    YUV and RGB and one truncated clip, against the unbatched replies
    (checked against the oracle above)."""
    import torch

    from hvqm4_tpu_torch import serve
    from hvqm4_tpu_torch.kernels.csc import YUV_TO_RGB

    srv = serve.DecodeServer(("127.0.0.1", 0), device=dev,
                             batch_window_s=0.25, max_batch=4)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    truncated = clips[CLIPS[0]][:-30]
    jobs = [(CLIPS[0], "yuv"), (CLIPS[1], "rgb"), (CLIPS[1], "yuv"),
            ("truncated", "yuv")]
    modes = {"yuv": serve.MODE_YUV, "rgb": serve.MODE_RGB}
    out = {}

    def req(i, name, mode):
        data = truncated if name == "truncated" else clips[name]
        try:
            out[i] = serve.decode_remote(*srv.server_address, data,
                                         mode=modes[mode], timeout=300)
        except RuntimeError as e:
            out[i] = e

    csc_before = YUV_TO_RGB.launches
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=req, args=(i, n, m))
                   for i, (n, m) in enumerate(jobs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        metrics = serve.fetch_metrics(*srv.server_address)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    for i, (name, mode) in enumerate(jobs[:3]):
        if out.get(i) != replies[name, mode]:
            fail(f"serve batched {name} {mode}: differs from the checked "
                 f"unbatched reply")
    if not isinstance(out.get(3), RuntimeError):
        fail(f"serve batched: the truncated clip did not fail ({out.get(3)})")
    nb, nr = metrics["batches"], metrics["batched_requests"]
    if nr not in (3, 4) or not 1 <= nb < nr or metrics["errors"] != 1:
        fail(f"serve batched: batches {nb}, batched_requests {nr}, errors "
             f"{metrics['errors']}; want coalescing and one error")
    if YUV_TO_RGB.launches == csc_before:
        fail("serve batched: the RGB reply never launched yuv_to_rgb")
    print(f"serve batched: {len(jobs)} concurrent requests in {wall:.4f} s; "
          f"yuv == oracle --hash, rgb == integer formula (== the checked "
          f"replies), the truncated clip failed alone; {nr} requests in "
          f"{nb} batch(es), yuv_to_rgb launched "
          f"{YUV_TO_RGB.launches - csc_before} times [{tag}]")


def profile(fn):
    """One call of `fn` under torch.profiler: (window in us, rows of
    (device us, count, kernel name)), or None when the profiler recorded
    no CUDA activity. User annotations (`Optimizer.step#Adam.step`) span
    kernels on the device's timeline and are left out, so that nothing is
    counted twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    return (wall_us, rows) if rows else None


def device_profile(fn, what: str, tag: str) -> None:
    """Device time by kernel and the device's busy share over one call of
    `fn`. The profiler's own host cost lengthens the window, so the busy
    share it gives is a lower bound."""
    res = profile(fn)
    if res is None:
        print(f"profile {what}: device time not measured (the profiler "
              f"recorded no CUDA activity) [{tag}]")
        return
    wall_us, rows = res
    busy = sum(r[0] for r in rows)
    print(f"profile {what}: window {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms = {100 * busy / wall_us:.1f}%, idle "
          f"{100 - 100 * busy / wall_us:.1f}% [{tag}]")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"  {us / 1e3:9.3f} ms x{count:<5d} {key[:90]}")


def device_us_per_call(fn, flush: L2Flush | None = None, calls: int = 20):
    """Device time in us of one call of `fn` (all its kernels), from the
    profiler over `calls` calls; None when the profiler saw no device. With
    `flush`, each call follows a flush, whose rows are left out; a window
    that does not show every flush lost activity and does not count. The
    profiler now and then records no CUDA activity in a window, so a
    window that shows none is taken once more."""

    def run():
        for _ in range(calls):
            if flush is not None:
                flush()
            fn()

    for _ in range(2):
        res = profile(run)
        if res is None:
            continue
        rows = res[1]
        if flush is not None:
            if sum(c for _us, c, key in rows if flush.ROW in key) != calls:
                continue
            rows = [r for r in rows if flush.ROW not in r[2]]
        return sum(us for us, _count, _key in rows) / calls
    return None


def fmt_us(us) -> str:
    return "not measured" if us is None else f"{us:.2f} us"


# Phase 8: `bench_torch.py`'s total budget inside the smoke (the bench takes
# about 2 minutes on one H100), and each instrument with its arguments and
# the keys its last line must carry
BENCH_BUDGET_S = 420
BENCH_JOBS = ("hash", "retail_hash", "link", "device", "retail_device",
              "pipeline", "retail_pipeline")  # the jobs that touch the card
INSTRUMENTS = (
    (("device_sweep_torch.py", "8"),
     ("full_ms_per_step", "device_fps", "compute_ms_per_step", "compute_fps",
      "upload_ms_per_step", "upload_fps", "upload_gbps", "mb_per_step",
      "steps_per_dispatch", "backend")),
    (("compute_ceiling_torch.py", "2"),
     ("compute_only_fps_samples", "compute_only_fps_best", "streams",
      "frames_per_pass", "backend")),
    (("profile_split_torch.py", "8"),
     ("plan_ms_per_step", "xfer_ms_per_step", "step_ms_per_step", "sync_ms",
      "kib_per_step", "fps", "backend")),
    (("soak_throughput_torch.py", "--minutes", "0.5"),
     ("fps_median", "fps_head3", "fps_tail3", "fps_min", "fps_max",
      "stable", "passes", "backend")))


def run_group(cmd: list, timeout: float, env=None) -> tuple:
    """Run `cmd` from the checkout in a process group of its own: (rc,
    stdout, stderr, seconds). On the timeout the whole group is killed
    (the bench's phase subprocesses too) and the phase fails."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"{' '.join(cmd[1:])} did not end within {timeout:.0f} s")
    return proc.returncode, out, err, time.perf_counter() - t0


def check_bench_line(line: dict, frames: dict) -> None:
    """Phase 8's gates on `bench_torch.py`'s result line. `frames` is each
    clip's frame count by key prefix ("" heavy, "retail_"), so every job's
    decode steps (dispatched steps x K, K dividing the 28 frames) are
    known: the hash 1 run, the device phase 1 warm pass + its timed
    passes, the pipeline 1 warm and 1 timed run."""
    if line.get("phase_failures"):
        fail(f"bench_torch.py phase failures: {line['phase_failures']}")
    if line.get("backend") != "cuda":
        fail(f"bench_torch.py ran on {line.get('backend')!r}, not cuda")
    for key in ("bitexact", "retail_bitexact", "device_replay_bitexact",
                "retail_device_replay_bitexact"):
        if line.get(key) is not True:
            fail(f"bench_torch.py {key} is {line.get(key)!r}, not true")
    for key in ("value", "device_fps", "retail_device_fps", "plan_fps"):
        if not line.get(key, 0) > 0:
            fail(f"bench_torch.py {key} is {line.get(key)!r}, not above 0")
    counts = line.get("kernel_launches", {})
    if sorted(counts) != sorted(BENCH_JOBS):
        fail(f"bench_torch.py counted jobs {sorted(counts)}, want "
             f"{sorted(BENCH_JOBS)}")
    for job, c in counts.items():
        phase = job.removeprefix("retail_")
        prefix = job[:-len(phase)]
        n = frames[prefix]
        steps = {"hash": n, "link": 0, "pipeline": 2 * n,
                 "device": (1 + line.get(prefix + "device_passes", 0)) * n
                 }[phase]
        want = {"decode_steps": steps, "intra_synth_acc": 3 * steps,
                "inter_combine": 3 * steps, "intra_synth_noacc": 0,
                "yuv_to_rgb": 0}
        if c != want:
            fail(f"bench_torch.py {job}: launches {c}, want {want}")


def phase_bench(frames: dict, tag: str) -> None:
    """Phase 8: `bench_torch.py` end to end at its defaults under
    `BENCH_BUDGET_S` (`check_bench_line`), then each of its four
    instruments; every result is printed with the card's name and power
    limit."""
    env = dict(os.environ, HVQM4_BENCH_BUDGET_S=str(BENCH_BUDGET_S))
    rc, out, err, secs = run_group([sys.executable, "bench_torch.py"],
                                   BENCH_BUDGET_S + 180, env)
    lines = out.strip().splitlines()
    if rc != 0 or len(lines) != 1:
        fail(f"bench_torch.py: rc {rc}, {len(lines)} stdout lines, want 0 "
             f"and 1:\n{out[-2000:]}\n{err[-3000:]}")
    line = json.loads(lines[0])
    check_bench_line(line, frames)
    print(f"bench_torch.py: {secs:.1f} s (budget {BENCH_BUDGET_S} s); "
          f"value (pipeline, heavy, {line['streams']} streams) "
          f"{line['value']} fps, retail {line['retail_pipeline_fps']}; "
          f"device_fps heavy ({line['device_streams']} streams, K=1) best "
          f"{line['device_fps']} median {line['device_fps_median']}, retail "
          f"({line['retail_device_streams']} streams, K=28) best "
          f"{line['retail_device_fps']} median "
          f"{line['retail_device_fps_median']}; plan_fps "
          f"{line['plan_fps']}, retail {line['retail_plan_fps']}; "
          f"link_h2d_gbps {line['link_h2d_gbps']}, rtt "
          f"{line['link_rtt_ms']} ms; oracle_fps {line['oracle_fps']}, "
          f"retail {line['retail_oracle_fps']}; bitexact, replay-bitexact "
          f"both clips; launches 3 x decode steps in every job [{tag}]")
    print(f"bench_torch.py line: {json.dumps(line)}")
    for args, keys in INSTRUMENTS:
        rc, out, err, secs = run_group(
            [sys.executable, f"scripts/{args[0]}", *args[1:]], 300)
        if rc != 0:
            fail(f"{' '.join(args)}: rc {rc}:\n{err[-3000:]}")
        res = json.loads(out.strip().splitlines()[-1])
        missing = [k for k in keys if k not in res]
        if missing or res["backend"] != "cuda":
            fail(f"{' '.join(args)}: keys {missing} missing or backend "
                 f"{res.get('backend')!r}: {res}")
        print(f"{' '.join(args)}: {json.dumps(res)} ({secs:.1f} s) [{tag}]")


# Phase 9: random clips at full width from the port's generator
# (`tools/encoder_torch.make_clip`), each of `TOOLS_GOPS`: three 4:2:0
# streams for the arena decoder (what, make_clip keywords), one 4:4:4 clip
# at version 1.5 for the session; and the fuzz battery's mutants
# (`scripts/fuzz_battery_torch.py`: mutants over its six bases, base seed)
TOOLS_SIZE = (640, 480)
TOOLS_GOPS = ["IPB", "IP"]
TOOLS_STREAMS = (
    ("slices 8", {"seed": 9101, "slices": 8}),
    ("mv_extreme", {"seed": 9102, "mv_extreme": True}),
    # dc_shift 7 scales every DC delta, escaped ones included, by 128
    ("2 audio channels, dc_shift 7",
     {"seed": 9103, "audio_channels": 2, "dc_shift": 7}),
)
TOOLS_SESSION = {"seed": 9104}
FUZZ = (60, 11000)
FUZZ_TIMEOUT_S = 300


def _make_clip(cfg, gops: list, kwargs: dict) -> bytes:
    from tools.encoder_torch import make_clip

    return make_clip(cfg, gops, **kwargs)


def generate_clips(jobs: list) -> list:
    """`make_clip(cfg, gops, **kwargs)` of each job, one worker process a
    job (the generator is pure Python)."""
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(len(jobs)) as pool:
        return pool.starmap(_make_clip, jobs)


def fuzz_child(device: str = "cuda") -> None:
    """Phase 9b, in a process of its own (a CUDA fault poisons its
    process). The mutants of `scripts/fuzz_battery_torch.py` (`FUZZ`) that
    the oracle decodes with rc 0, that keep their base's shape and that the
    port's planner plans whole go, a base's together as streams, through
    the arena decoder on `device` at K = 1 and 2. Every stream's frames
    must equal the golden decoder's (`refdec`, on the CPU, from the same
    plans) byte for byte, and `oracle --csum` wherever the golden decode
    does. Each base's mutants are named on stderr before they reach the
    device. Prints one JSON line: the counts, the mutants whose golden
    decode parts from the oracle, and the kernels' launches."""
    import tempfile

    import torch

    from hvqm4_tpu_torch import refdec
    from hvqm4_tpu_torch.container import ContainerError, Demuxer
    from hvqm4_tpu_torch.kernels import _build
    from hvqm4_tpu_torch.native import NativePlanner, PlannerError
    from hvqm4_tpu_torch.parallel.multistream import MultiStreamDecoder
    from hvqm4_tpu_torch.utils.hashing import batch_csum
    from scripts.fuzz_battery_torch import base_mutants

    t0 = time.perf_counter()
    n, base_seed = FUZZ
    subprocess.run(["make", "-s", "-C", str(REPO / "oracle")], check=True)
    oracle = REPO / "oracle" / "hvqm4_oracle"
    kernels = _build.kernels()
    for k in kernels:
        k.launches = 0
    counts = collections.Counter()
    parts, decode_steps = [], 0
    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "m.h4m"
        for bi, _spec, cfg, muts in base_mutants(n, base_seed):
            where = (f"base {bi} (clip seed {base_seed + bi}, mutation seed "
                     f"{base_seed * 7 + bi})")
            taken = []  # (index, mutant, golden frames, their csums, oracle's)
            for i, data in enumerate(muts):
                path.write_bytes(data)
                res = subprocess.run([str(oracle), "--csum", str(path),
                                      "/dev/null"], capture_output=True,
                                     text=True)
                if res.returncode != 0:
                    counts["oracle_rejects"] += 1
                    continue
                want = [ln.split("csum=")[1] for ln in res.stdout.splitlines()
                        if "csum=" in ln]
                try:
                    demux = Demuxer(data)
                    if demux.info.cfg != cfg:
                        counts["shape_changed"] += 1
                        continue
                    planner = NativePlanner(cfg)
                    for r in demux.video_records():
                        planner.plan_frame(r.frame_char, r.payload)
                except (ContainerError, PlannerError):
                    counts["planner_rejects"] += 1
                    continue
                try:
                    golden = [b"".join(p.tobytes() for p in f)
                              for f in refdec.decode_clip(cfg, data)]
                    gsums = [f"{bytes_csum(f):08x}" for f in golden]
                    if gsums != want:
                        parts.append(f"{where} mutant {i}: golden csums "
                                     f"{gsums} vs oracle {want}")
                except ValueError as e:  # e.g. a P frame with no reference
                    golden = gsums = None
                    parts.append(f"{where} mutant {i}: the golden decoder "
                                 f"refuses ({e}); the oracle decodes it")
                taken.append((i, data, golden, gsums, want))
            if not taken:
                continue
            print(f"fuzz: {where}: mutants {[t[0] for t in taken]} to "
                  f"{device}", file=sys.stderr, flush=True)
            for k in (1, 2):
                ms = MultiStreamDecoder(cfg, [t[1] for t in taken], device,
                                        steps_per_dispatch=k)
                frames = [[] for _ in taken]
                sums = [[] for _ in taken]
                for planes, _metas, valid in ms.run_pipelined():
                    cs = batch_csum(*planes).cpu().tolist()
                    host = [p.cpu().numpy() for p in planes]
                    for j, ok in enumerate(valid):
                        if ok:
                            frames[j].append(b"".join(h[j].tobytes()
                                                      for h in host))
                            sums[j].append(f"{cs[j]:08x}")
                decode_steps += int(ms.stats["steps"]) * k
                for j, (i, _data, golden, gsums, want) in enumerate(taken):
                    if golden is not None and frames[j] != golden:
                        raise AssertionError(
                            f"fuzz {where} mutant {i}, K={k}: {device} "
                            f"frames differ from the golden decode")
                    if gsums == want and sums[j] != want:
                        raise AssertionError(
                            f"fuzz {where} mutant {i}, K={k}: {device} "
                            f"csums differ from oracle --csum")
            counts["on_device"] += len(taken)
            counts["frames"] += sum(len(t[4]) for t in taken)
    if device != "cpu":
        torch.cuda.synchronize()
    print(json.dumps({"mutants": n // 6 * 6, **counts, "parts": parts,
                      "decode_steps": decode_steps,
                      "launches": {k.symbol: k.launches for k in kernels},
                      "seconds": time.perf_counter() - t0}))


def bytes_csum(frame: bytes) -> int:
    """`oracle --csum` of one frame's YUV bytes (planes concatenated)."""
    import torch

    from hvqm4_tpu_torch.utils.hashing import frame_csum

    flat = torch.frombuffer(bytearray(frame), dtype=torch.uint8)
    return int(frame_csum([flat.view(1, -1)]))


def phase_tools(dev, oracle: Path, kernels: list, tag: str) -> dict:
    """Phase 9: (a) `TOOLS_STREAMS`, 640x480 clips of `make_clip`, through
    the arena decoder on the card as 3 streams at K = 1 and 2, and
    `TOOLS_SESSION` at 4:4:4 version 1.5 through `DecoderSession`: every
    frame's csum equal to `oracle --csum`; `intra_synth_acc` and
    `inter_combine` launch 3 x the arena's decode steps and
    `intra_synth_noacc` not at all, and the session launches
    `intra_synth_noacc` 3 x its I frames, the other two 3 x its P and B
    frames. (b) `fuzz_child` in its own process, started first and run
    beside (a): rc 0 and its line. Returns the phase's launches, the
    child's included."""
    import torch

    from hvqm4_tpu_torch.config import SeqConfig
    from hvqm4_tpu_torch.parallel.multistream import MultiStreamDecoder
    from hvqm4_tpu_torch.session import DecoderSession
    from hvqm4_tpu_torch.utils.hashing import frame_csum, oracle_csums

    t_phase = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.fuzz_child()"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        cfg = SeqConfig(*TOOLS_SIZE)
        cfg444 = SeqConfig(*TOOLS_SIZE, 1, 1, version="1.5")
        t0 = time.perf_counter()
        *streams, sclip = generate_clips(
            [(cfg, TOOLS_GOPS, kw) for _what, kw in TOOLS_STREAMS]
            + [(cfg444, TOOLS_GOPS, TOOLS_SESSION)])
        print(f"tools: make_clip of {len(streams) + 1} {cfg.width}x"
              f"{cfg.height} clips "
              f"{TOOLS_GOPS} in {time.perf_counter() - t0:.1f} s (one "
              f"process each): {[len(c) for c in (*streams, sclip)]} B")
        SCRATCH.mkdir(parents=True, exist_ok=True)
        want = []
        for i, data in enumerate((*streams, sclip)):
            path = SCRATCH / f"tools{i}.h4m"
            path.write_bytes(data)
            want.append(oracle_csums(oracle, path))
        for k in kernels:
            k.launches = 0
        substeps = 0
        for k in (1, 2):
            ms = MultiStreamDecoder(cfg, streams, dev, steps_per_dispatch=k)
            got = arena_csums(ms, ms.run_pipelined())
            for j, (what, kw) in enumerate(TOOLS_STREAMS):
                if got[j] != want[j] or not got[j]:
                    fail(f"tools: arena K={k} stream {j} ({what}, seed "
                         f"{kw['seed']}) differs from the oracle")
            substeps += int(ms.stats["steps"]) * k
            print(f"tools: arena on {dev}, K={k}: {len(streams)} random "
                  f"{cfg.width}x{cfg.height} streams "
                  f"({', '.join(w for w, _ in TOOLS_STREAMS)})"
                  f", {int(ms.stats['frames'])} frames, csum == oracle on "
                  f"every frame")
        torch.cuda.synchronize()
        arena = {k.symbol: k.launches for k in kernels}
        for sym, n in (("hvqm4_intra_synth_acc", 3 * substeps),
                       ("hvqm4_inter_combine", 3 * substeps),
                       ("hvqm4_intra_synth_noacc", 0),
                       ("hvqm4_yuv_to_rgb", 0)):
            if arena[sym] != n:
                fail(f"tools: {sym} launched {arena[sym]} times on the "
                     f"arena, want {n} ({substeps} decode steps)")
        for k in kernels:
            k.launches = 0
        got = [f"{int(frame_csum(f.planes)):08x}"
               for f in DecoderSession(cfg444, dev).decode_clip(sclip)]
        if got != want[-1]:
            fail("tools: the 4:4:4 v1.5 clip through the session differs "
                 "from the oracle")
        torch.cuda.synchronize()
        session = {k.symbol: k.launches for k in kernels}
        n_i = sum(g.count("I") for g in TOOLS_GOPS)
        n_pb = sum(map(len, TOOLS_GOPS)) - n_i
        for sym, n in (("hvqm4_intra_synth_noacc", 3 * n_i),
                       ("hvqm4_intra_synth_acc", 3 * n_pb),
                       ("hvqm4_inter_combine", 3 * n_pb),
                       ("hvqm4_yuv_to_rgb", 0)):
            if session[sym] != n:
                fail(f"tools: {sym} launched {session[sym]} times in the "
                     f"session, want {n}")
        print(f"tools: session on {dev}, 4:4:4 v1.5 {cfg.width}x{cfg.height} "
              f"(seed {TOOLS_SESSION['seed']}): {len(got)} frames, csum == "
              f"oracle; launches {session}")
        try:
            out, err = child.communicate(timeout=FUZZ_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"tools: the fuzz child did not end within "
                 f"{FUZZ_TIMEOUT_S} s")
    finally:
        if child.poll() is None:
            os.killpg(child.pid, signal.SIGKILL)
            child.communicate()
    lines = out.strip().splitlines()
    if child.returncode != 0 or not lines:
        fail(f"tools: the fuzz child: rc {child.returncode}:\n"
             f"{err[-3000:]}")
    res = json.loads(lines[-1])
    for part in res["parts"]:
        print(f"tools: fuzz finding (the golden decoder parts from the "
              f"oracle; planner shared by both packages): {part}")
    fz = res["launches"]
    for sym, n in (("hvqm4_intra_synth_acc", 3 * res["decode_steps"]),
                   ("hvqm4_inter_combine", 3 * res["decode_steps"]),
                   ("hvqm4_intra_synth_noacc", 0)):
        if fz[sym] != n:
            fail(f"tools: fuzz {sym} launched {fz[sym]} times, want {n}")
    print(f"tools: fuzz on {dev} in a child process: {res['mutants']} "
          f"mutants, oracle rejects {res.get('oracle_rejects', 0)}, shape "
          f"changed {res.get('shape_changed', 0)}, planner rejects "
          f"{res.get('planner_rejects', 0)}; {res.get('on_device', 0)} "
          f"through the arena at K = 1 and 2 ({res.get('frames', 0)} frames "
          f"each), no CUDA fault, frames == the golden decode, csum == oracle"
          f" where the golden decode is; golden parts from the oracle on "
          f"{len(res['parts'])}; launches {fz} ({res['seconds']:.1f} s)")
    print(f"phase 9 (tools): {time.perf_counter() - t_phase:.1f} s [{tag}]")
    return {sym: arena[sym] + session[sym] + fz[sym] for sym in arena}


def main() -> int:
    t_start = time.perf_counter()
    if not (REPO / "hvqm4_tpu_torch").is_dir():
        fail("hvqm4_tpu_torch/ is not beside this script: run it from a "
             "checkout of the repository")
    import torch

    # phase 1: the card
    if not torch.cuda.is_available():
        fail("CUDA is not available; this check runs on the card only")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    tag = card
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # phase 2: builds
    from hvqm4_tpu_torch.config import SeqConfig
    from hvqm4_tpu_torch.kernels import _build
    from hvqm4_tpu_torch.native import NativePlanner

    t0 = time.perf_counter()
    lib = _build.build()
    print(f"build kernels (nvcc sm_90a): {time.perf_counter() - t0:.1f} s "
          f"-> {lib.relative_to(REPO)}")
    print(lib.with_suffix(".log").read_text().strip())
    t0 = time.perf_counter()
    subprocess.run(["make", "-s", "-C", str(REPO / "oracle")], check=True)
    print(f"build oracle: {time.perf_counter() - t0:.1f} s")
    cfg = SeqConfig(640, 480)
    t0 = time.perf_counter()
    NativePlanner(cfg)
    print(f"build native planner: {time.perf_counter() - t0:.1f} s")
    oracle = REPO / "oracle" / "hvqm4_oracle"

    # phase 3: each kernel against its plain version
    err = phase_kernels(dev)

    # phases 4-5: the decode path, counted
    from hvqm4_tpu_torch.utils.hashing import oracle_csums

    clips = {name: (REPO / "testdata" / name).read_bytes() for name in CLIPS}
    want = {name: oracle_csums(oracle, REPO / "testdata" / name)
            for name in CLIPS}
    kernels = _build.kernels()
    for k in kernels:
        k.launches = 0
    phase_session(dev, clips, oracle, want)
    phase_lockstep(cfg, clips, dev, want)
    torch.cuda.synchronize()
    decode_launches = {k.symbol: k.launches for k in kernels}
    print(f"launches on the decode path (phases 4-5): {decode_launches}")
    for sym, count in decode_launches.items():
        if count == 0 and sym != "hvqm4_yuv_to_rgb":
            fail(f"{sym} never launched on the decode path")

    # phase 5b: the arena decoder, counted
    for k in kernels:
        k.launches = 0
    substeps = phase_arena(cfg, clips, dev, want)
    torch.cuda.synchronize()
    arena_launches = {k.symbol: k.launches for k in kernels}
    print(f"launches on the arena path (phase 5b, {substeps} decode steps): "
          f"{arena_launches}")
    for sym, n in (("hvqm4_intra_synth_acc", 3 * substeps),
                   ("hvqm4_inter_combine", 3 * substeps),
                   ("hvqm4_intra_synth_noacc", 0)):
        if arena_launches[sym] != n:
            fail(f"{sym} launched {arena_launches[sym]} times on the arena "
                 f"path, want {n}")

    # phase 5c: the consumer paths on the arena decoder, counted
    for k in kernels:
        k.launches = 0
    consumer_launches = phase_consumers(dev, cfg, clips, oracle, kernels)
    steps = len(want[CLIPS[0]])
    runs = 5  # the loader three ways, the pipeline at plan_ahead 1 and 2
    print(f"launches on the consumer paths (phase 5c, {runs} runs of {steps} "
          f"steps): {consumer_launches}")
    for sym, n in (("hvqm4_yuv_to_rgb", runs * steps),
                   ("hvqm4_intra_synth_acc", 3 * runs * steps),
                   ("hvqm4_inter_combine", 3 * runs * steps),
                   ("hvqm4_intra_synth_noacc", 0)):
        if consumer_launches[sym] != n:
            fail(f"{sym} launched {consumer_launches[sym]} times on the "
                 f"consumer paths, want {n}")

    # phase 5d: the encoder side, counted: the session decodes one I and
    # one P frame (3 planes each) of the encoded clip, of the same clip
    # inside `cli transcode` and of the transcoded one
    for k in kernels:
        k.launches = 0
    encoder_launches = phase_encoder(dev, cfg, clips, oracle, kernels, tag)
    print(f"launches on the encoder side (phase 5d, 3 session decodes of "
          f"[\"IP\"]): {encoder_launches}")
    for sym, n in (("hvqm4_intra_synth_noacc", 9),
                   ("hvqm4_intra_synth_acc", 9),
                   ("hvqm4_inter_combine", 9), ("hvqm4_yuv_to_rgb", 0)):
        if encoder_launches[sym] != n:
            fail(f"{sym} launched {encoder_launches[sym]} times on the "
                 f"encoder side, want {n}")

    # phase 5e: the training path on the arena decoder, counted
    for k in kernels:
        k.launches = 0
    train_launches, train_steps, *single = phase_train(dev, cfg, clips,
                                                        kernels, tag)
    print(f"launches on the training path (phase 5e, {train_steps} steps): "
          f"{train_launches}")
    for sym, n in (("hvqm4_yuv_to_rgb", train_steps),
                   ("hvqm4_intra_synth_acc", 3 * train_steps),
                   ("hvqm4_inter_combine", 3 * train_steps),
                   ("hvqm4_intra_synth_noacc", 0)):
        if train_launches[sym] != n:
            fail(f"{sym} launched {train_launches[sym]} times on the "
                 f"training path, want {n}")

    # phase 5f: the sharded path, counted in each rank
    sharded_launches = phase_sharded(cfg, clips, want, single, tag)
    print(f"launches on the sharded path (phase 5f, summed over the ranks): "
          f"{sharded_launches}")

    # phase 6: the decode service, counted
    for k in kernels:
        k.launches = 0
    serve_launches = phase_serve(dev, cfg, clips, oracle, kernels, tag)
    print(f"launches on the serve path (phase 6): {serve_launches}")
    for sym, count in serve_launches.items():
        if count == 0:
            fail(f"{sym} never launched on the serve path")

    # phase 7: times, with the clocks the card runs at as they start
    print("clocks at phase 7 (sm, mem, power draw): " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    times = phase_times(dev, cfg, clips, tag)

    # phase 8: the bench and its instruments, each in its own processes
    phase_bench({"": len(want[CLIPS[0]]), "retail_": len(want[CLIPS[1]])},
                tag)

    # phase 9: the tools' random clips and fuzz mutants, counted
    tools_launches = phase_tools(dev, oracle, kernels, tag)
    print(f"launches on the tools phase (phase 9, the fuzz child included): "
          f"{tools_launches}")

    sources = {"hvqm4_intra_synth_noacc": "intra.cu",
               "hvqm4_intra_synth_acc": "intra.cu",
               "hvqm4_inter_combine": "inter.cu",
               "hvqm4_yuv_to_rgb": "csc.cu"}
    rows = []
    for k in kernels:
        name = k.symbol.removeprefix("hvqm4_")
        t = times[name]
        # no single PyTorch call computes any of these functions, so no
        # library call is timed beside them
        rows.append({"name": name, "route": "cuda",
                     "source": f"hvqm4_tpu_torch/kernels/csrc/{sources[k.symbol]}",
                     "replaces": k.replaces,
                     "launches": (decode_launches[k.symbol]
                                  + arena_launches[k.symbol]
                                  + consumer_launches[k.symbol]
                                  + encoder_launches[k.symbol]
                                  + train_launches[k.symbol]
                                  + sharded_launches.get(k.symbol, 0)
                                  + serve_launches[k.symbol]
                                  + tools_launches[k.symbol]),
                     "max_abs_err": err[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_us"] / 1e3, "bound_by": "bytes",
                     "library_ms": None, "bound_us": t["bound_us"],
                     "device_us": t["device_us"]})
    # the port runs without JAX: nothing of it may have been imported
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("hvqm4_tpu", "jax", "jaxlib"))
    if leaked:
        fail(f"modules of JAX or of the JAX package were imported: {leaked}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s end to end, "
          f"the builds included [{tag}]")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
