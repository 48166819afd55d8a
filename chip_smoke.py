#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. card: CUDA must be available (no CPU fallback); prints the card's name
   and power limit as nvidia-smi reports them.
2. build: the CUDA kernels (nvcc, sm_90a), the C oracle and the C++ planner,
   with their build seconds and nvcc's register/shared-memory report.
3. kernels vs plain: every CUDA entry point against its plain PyTorch
   version on the card, on random plans at the 640x480 block grids with
   N=8 streams, both nest orientations, per-block and per-MB vector grids.
   Exact equality.
4. session: testdata/ref640.h4m and retail640.h4m (28 frames each) through
   `DecoderSession` on cuda; every frame's on-device csum must equal
   `oracle --csum`, and retail640's FNV-1a hashes `oracle --hash`.
5. lock-step: 8 streams (4x each clip) through `multi_frame_step`; every
   frame of every stream must equal the oracle's csum.
6. launches and times: every kernel must have launched during phases 4-5;
   kernel and plain times (CUDA events, 3 warm-ups, median of 20), session
   and lock-step frame rates, host planning timed separately.

The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
CLIPS = ("ref640.h4m", "retail640.h4m")
N_STREAMS = 8
GRIDS_640 = ((120, 160), (60, 80))  # luma and 4:2:0 chroma block grids


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median device time of one call, from CUDA events around it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
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


def max_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max())


def phase_kernels(dev) -> dict:
    """Phase 3: each kernel against its plain version, exact."""
    import torch

    from hvqm4_tpu_torch.convert import plan_to_torch
    from hvqm4_tpu_torch.kernels.inter import inter_combine, inter_combine_plain
    from hvqm4_tpu_torch.kernels.intra import intra_synth, intra_synth_plain

    rng = np.random.default_rng(2024)
    err = {"intra_synth_noacc": 0, "intra_synth_acc": 0, "inter_combine": 0}
    cases = [((120, 160), (38, 70), (120, 160)),
             ((120, 160), (70, 38), (60, 80)),
             ((60, 80), (38, 70), (30, 40)),
             ((60, 80), (70, 38), (60, 80))]
    for (bh, bw), nest_shape, grid in cases:
        plan = plan_to_torch(random_plan(rng, bh, bw, N_STREAMS, grid), dev)
        nest = torch.from_numpy(rng.integers(
            0, 256, (N_STREAMS, *nest_shape), dtype=np.uint8)).to(dev)
        ref0, ref1 = (torch.from_numpy(rng.integers(
            0, 256, (N_STREAMS, bh * 4, bw * 4), dtype=np.uint8)).to(dev)
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
        print(f"kernels vs plain: grid {bh}x{bw} nest {nest_shape[0]}x"
              f"{nest_shape[1]} vectors {grid[0]}x{grid[1]} N={N_STREAMS}: "
              f"max_abs_err {err}")
    for name, e in err.items():
        if e != 0:
            fail(f"{name} differs from its plain version (max_abs_err {e})")
    return err


def phase_session(dev, clips: dict, oracle: Path, want_csums: dict) -> None:
    """Phase 4: DecoderSession on the card against the C oracle."""
    from hvqm4_tpu_torch.host import Demuxer, fnv1a
    from hvqm4_tpu_torch.session import DecoderSession
    from hvqm4_tpu_torch.utils.hashing import frame_csum

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
    from hvqm4_tpu_torch.host import NativePlanner
    from hvqm4_tpu_torch.parallel.multistream import decode_lockstep
    from hvqm4_tpu_torch.utils.hashing import batch_csum

    got = [[] for _ in range(N_STREAMS)]
    for frames, valid in decode_lockstep(
            cfg, [clips[n] for n in STREAM_CLIPS], dev,
            planner_factory=NativePlanner):
        cs = batch_csum(*frames).cpu().tolist()
        for j in range(N_STREAMS):
            if valid[j]:
                got[j].append(f"{cs[j]:08x}")
    for j, name in enumerate(STREAM_CLIPS):
        if got[j] != want[name]:
            fail(f"lock-step stream {j} ({name}) differs from the oracle")
    print(f"lock-step on {dev}: {N_STREAMS} streams, "
          f"{sum(map(len, got))} frames, csum == oracle on every frame")


def lockstep_steps(cfg, clips: dict, dev) -> list:
    """The host half of lock-step decode, done ahead for timing: every
    step's stacked inputs, already on the card, with its frame count."""
    from hvqm4_tpu_torch.convert import stack_plans
    from hvqm4_tpu_torch.host import NativePlanner
    from hvqm4_tpu_torch.parallel.multistream import plan_steps

    return [(stack_plans(cfg, plans, dev), sum(p is not None for p in plans))
            for plans in plan_steps(cfg, [clips[n] for n in STREAM_CLIPS],
                                    planner_factory=NativePlanner)]


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


def phase_times(dev, cfg, clips: dict, tag: str) -> dict:
    """Phase 6 timings: kernels vs plain at the 640x480 grids with N=8,
    then the session and lock-step frame rates."""
    import torch

    from hvqm4_tpu_torch.convert import plan_to_torch
    from hvqm4_tpu_torch.host import Demuxer
    from hvqm4_tpu_torch.kernels.inter import inter_combine, inter_combine_plain
    from hvqm4_tpu_torch.kernels.intra import intra_synth, intra_synth_plain
    from hvqm4_tpu_torch.session import DecoderSession

    rng = np.random.default_rng(7)
    times = {}
    for bh, bw in GRIDS_640:
        plan = plan_to_torch(random_plan(rng, bh, bw, N_STREAMS, (bh, bw)),
                             dev)
        nest = torch.from_numpy(rng.integers(
            0, 256, (N_STREAMS, 38, 70), dtype=np.uint8)).to(dev)
        ref = torch.from_numpy(rng.integers(
            0, 256, (N_STREAMS, bh * 4, bw * 4), dtype=np.uint8)).to(dev)
        px, acc = intra_synth(plan, nest, want_acc=True)
        pairs = {
            "intra_synth_noacc": (lambda: intra_synth(plan, nest, False),
                                  lambda: intra_synth_plain(plan, nest, False)),
            "intra_synth_acc": (lambda: intra_synth(plan, nest, True),
                                lambda: intra_synth_plain(plan, nest, True)),
            "inter_combine": (
                lambda: inter_combine(plan, px, acc, ref, ref),
                lambda: inter_combine_plain(plan, px, acc, ref, ref)),
        }
        for name, (kern, plain) in pairs.items():
            # plain, kernel, kernel, plain: the two halves bracket drift
            p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kern), cuda_ms(kern),
                              cuda_ms(plain))
            k, p = min(k1, k2), min(p1, p2)
            times.setdefault(name, (k, p))  # the luma grid goes in the JSON
            print(f"time {name} grid {bh}x{bw} N={N_STREAMS}: kernel "
                  f"{k:.4f} ms, plain {p:.4f} ms ({p / k:.1f}x) per call; "
                  f"device only: kernel {device_us_per_call(kern)}, plain "
                  f"{device_us_per_call(plain)} [{tag}]")

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
    print(f"time lock-step {N_STREAMS} streams: {frames} frames; host "
          f"planning+stacking+upload {host_s:.4f} s ({frames / host_s:.1f} "
          f"fps), device steps {dev_s:.4f} s ({frames / dev_s:.1f} fps) "
          f"[{tag}]")

    device_profile(lambda: run_lockstep(cfg, steps, dev),
                   f"lock-step device steps ({frames} frames)", tag)
    retail = clips["retail640.h4m"]
    device_profile(lambda: sum(1 for _ in DecoderSession(
        cfg, dev).decode_clip(retail)), "session retail640.h4m (28 frames)",
        tag)
    return times


def profile(fn):
    """One call of `fn` under torch.profiler: (window in us, rows of
    (device us, count, kernel name)), or None when the profiler recorded
    no CUDA activity."""
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
            and e.self_device_time_total > 0]
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


def device_us_per_call(fn, calls: int = 20) -> str:
    """Device time of one call of `fn` (all its kernels), from the
    profiler over `calls` calls."""
    res = profile(lambda: [fn() for _ in range(calls)])
    if res is None:
        return "not measured"
    return f"{sum(r[0] for r in res[1]) / calls:.2f} us"


def main() -> int:
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
    from hvqm4_tpu_torch.host import NativePlanner, SeqConfig
    from hvqm4_tpu_torch.kernels import _build

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

    # phases 4-5: the main path, counted
    from hvqm4_tpu_torch.host import oracle_csums

    clips = {name: (REPO / "testdata" / name).read_bytes() for name in CLIPS}
    want = {name: oracle_csums(oracle, REPO / "testdata" / name)
            for name in CLIPS}
    kernels = _build.kernels()
    for k in kernels:
        k.launches = 0
    phase_session(dev, clips, oracle, want)
    phase_lockstep(cfg, clips, dev, want)
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in kernels}
    print(f"launches on the main path: {launches}")
    for sym, count in launches.items():
        if count == 0:
            fail(f"{sym} never launched on the main path")

    # phase 6: times
    times = phase_times(dev, cfg, clips, tag)

    sources = {"hvqm4_intra_synth_noacc": "intra.cu",
               "hvqm4_intra_synth_acc": "intra.cu",
               "hvqm4_inter_combine": "inter.cu"}
    rows = []
    for k in kernels:
        name = k.symbol.removeprefix("hvqm4_")
        ms, plain_ms = times[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"hvqm4_tpu_torch/kernels/csrc/{sources[k.symbol]}",
                     "replaces": k.replaces, "launches": launches[k.symbol],
                     "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms})
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
