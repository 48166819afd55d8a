"""The port's bench (`bench_torch.py`) against the JAX package's `bench.py`.

The byte table of a planned pass equals the JAX bench's key for key and
byte for byte; every phase keeps its field contract on the CPU
(`HVQM4_BENCH_FORCE_CPU=1`, testdata/i320.h4m at 2 streams); the K=28
tail window hashes bit-exact; `main` prints its one line under a budget
that fits nothing; the result line's keys are `bench.py`'s less the
tunnel-only ones; and the bench and its four instruments run with JAX,
the JAX package and `bench.py` blocked.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import bench
import bench_torch
from hvqm4_tpu.config import SeqConfig as JaxSeqConfig
from hvqm4_tpu.native import NativePlanner as JaxNativePlanner
from hvqm4_tpu.parallel import multistream as jms
from hvqm4_tpu.utils.hashing import oracle_csums as jax_oracle_csums
from hvqm4_tpu_torch.container import Demuxer
from hvqm4_tpu_torch.parallel.multistream import MultiStreamDecoder

from .conftest import REPO

I320 = REPO / "testdata" / "i320.h4m"
I320_FRAMES = 4
# every phase on the CPU at the tiny clip; the device phase to a few passes;
# one intra-op thread, so that the subprocesses of concurrent test workers
# do not spin against each other's thread pools
CPU_ENV = {"HVQM4_BENCH_FORCE_CPU": "1", "HVQM4_BENCH_STREAMS": "2",
           "HVQM4_BENCH_CLIP": str(I320), "HVQM4_BENCH_DEVICE_S": "1",
           "HVQM4_BENCH_PHASE_S": "3", "OMP_NUM_THREADS": "1"}
KERNELS = {"intra_synth_noacc", "intra_synth_acc", "inter_combine",
           "yuv_to_rgb"}
SPLIT_KEYS = {"dequeue", "wait", "upload", "dispatch", "other",
              "worker_plan", "worker_assemble", "worker_stage"}

# bench.py's result line (`main`, bench.py:710-800): the keys it always
# prints, its attributability keys, and those of both that are tunnel-only
BENCH_KEYS = {
    "metric", "clip", "value", "unit", "vs_baseline", "device_fps",
    "device_vs_baseline", "oracle_fps", "streams", "planner", "bitexact",
    "bitexact_streams", "bitexact_frames", "backend", "retail_pipeline_fps",
    "retail_device_fps", "retail_oracle_fps", "retail_vs_baseline",
    "retail_device_vs_baseline", "retail_bitexact", "plan_fps",
    "plan_vs_baseline", "retail_plan_fps", "retail_plan_vs_baseline",
    "device_median_vs_baseline", "retail_device_median_vs_baseline"}
BENCH_ATTRIBUTION = {
    pfx + key for pfx in ("", "retail_") for key in (
        "device_fps_samples", "device_fps_spread", "device_passes",
        "device_pass_mb", "device_streams", "pipeline_split_ms_per_frame",
        "device_fps_median", "device_ramp_gbps",
        "device_bytes_per_frame_by_field", "device_upload_only_fps",
        "device_transfer_bound_pct", "device_packed_staging",
        "device_replay_bitexact", "device_mb_per_frame",
        "device_link_ceiling_fps")} | {
    "link_h2d_gbps", "link_h2d_gbps_samples", "link_rtt_ms"}
TUNNEL_ONLY = {pfx + key for pfx in ("", "retail_") for key in (
    "device_ramp_gbps", "device_upload_only_fps",
    "device_transfer_bound_pct")} | {"local_archive", "salvage"}
PORT_KEYS = {"gpu", "budget_s"}
PORT_ATTRIBUTION = {"plan_ahead", "kernel_launches"}
JOBS = ["plan", "retail_plan", "hash", "retail_hash", "link", "device",
        "retail_device", "pipeline", "retail_pipeline"]


def run_bench(*args, **env) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, str(REPO / "bench_torch.py"), *args], cwd=REPO,
        env=dict(os.environ, **CPU_ENV, **env), capture_output=True,
        text=True, timeout=300)


def one_line(res: subprocess.CompletedProcess) -> dict:
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, res.stdout
    return json.loads(lines[0])


@pytest.fixture(scope="module")
def phases() -> dict:
    """Each phase's line, run once as `python bench_torch.py --phase X`."""
    return {p: one_line(run_bench("--phase", p))
            for p in ("plan", "link", "hash", "device", "pipeline")}


def jax_plan_pass(data: bytes, n: int, k: int) -> dict:
    """bench.py's device-phase planning loop (bench.py:193-211) on the JAX
    package's decoder: the summed byte table, the frames, the pass's MB
    and the wire payload a frame."""
    cfg = Demuxer(data).info.cfg
    ms = jms.MultiStreamDecoder(
        JaxSeqConfig(cfg.width, cfg.height, cfg.h_samp, cfg.v_samp),
        [data] * n, planner_factory=JaxNativePlanner, steps_per_dispatch=k)
    fields, frames, sizes = {}, 0, []
    while any(ms.active):
        buf, _metas, valid = ms.plan_step()
        for key, v in bench._step_byte_fields(ms, buf).items():
            fields[key] = fields.get(key, 0) + v
        sizes.append(ms.snapshot_step(buf)["sizes"])
        ms._cur ^= 1
        frames += int(np.sum(valid))
    recs = ms.streams[0].records
    return {"byte_fields": fields, "frames": frames,
            "pass_mb": sum(s8 + s32 * 4 for s8, s32 in sizes) / 1e6,
            "wire_pf": sum(len(p) for _b, _c, p in recs) / max(len(recs), 1)}


@pytest.mark.parametrize("clip,n,k", [("i320.h4m", 2, 1),
                                      ("i320.h4m", 2, 28),
                                      ("ref640.h4m", 16, 1)])
def test_byte_table_matches_jax_bench(clip, n, k):
    """Planning only: the port's per-field upload bytes, summed over the
    clip, equal the JAX bench's exactly, and so do the device phase's
    frames, MB a pass and wire payload a frame."""
    data = (REPO / "testdata" / clip).read_bytes()
    want = jax_plan_pass(data, n, k)
    cfg = Demuxer(data).info.cfg
    got = bench_torch.plan_pass(
        MultiStreamDecoder(cfg, [data] * n, "cpu", steps_per_dispatch=k))
    assert got["byte_fields"] == want["byte_fields"]
    assert (got["frames"], got["pass_mb"], got["wire_pf"]) == \
        (want["frames"], want["pass_mb"], want["wire_pf"])
    assert len(got["bufs"]) == len(got["valid"])


def test_phase_plan_matches_jax_bench(phases, monkeypatch):
    out = phases["plan"]
    assert set(out) == {"plan_fps", "plan_frames", "planner"}
    assert out["plan_fps"] > 0 and out["planner"] == "native"
    monkeypatch.setenv("HVQM4_BENCH_CLIP", str(I320))
    monkeypatch.delenv("HVQM4_STEPS_PER_DISPATCH", raising=False)
    assert out["plan_frames"] == bench.phase_plan(2)["plan_frames"] == \
        2 * I320_FRAMES


def test_phase_link(phases):
    out = phases["link"]
    assert set(out) == {"link_h2d_gbps", "link_h2d_gbps_samples",
                        "link_rtt_ms", "kernel_launches"}
    assert out["link_h2d_gbps"] > 0 and len(out["link_h2d_gbps_samples"]) == 3
    assert out["link_h2d_gbps"] == max(out["link_h2d_gbps_samples"])
    assert out["link_rtt_ms"] >= 0
    assert out["kernel_launches"] == dict.fromkeys(KERNELS | {"decode_steps"},
                                                   0)


def test_phase_hash_matches_jax_bench(phases, oracle_bin):
    out = phases["hash"]
    assert out["bitexact"] is True and out["bitexact_streams"] == 2
    # the JAX bench's bitexact_frames: the oracle's digests of the clip
    assert out["bitexact_frames"] == len(jax_oracle_csums(oracle_bin, I320)) \
        == I320_FRAMES
    # the CPU takes the plain versions: no kernel launches
    assert out["kernel_launches"] == {"decode_steps": I320_FRAMES,
                                      **dict.fromkeys(KERNELS, 0)}


def test_phase_device(phases):
    out = phases["device"]
    assert out["device_replay_bitexact"] is True
    assert out["device_packed_staging"] is True
    assert out["device_fps"] > 0   # the best pass (samples keep 1 decimal)
    assert abs(out["device_fps"] - max(out["device_fps_samples"])) <= 0.06
    assert len(out["device_fps_samples"]) == out["device_passes"] >= 1
    assert out["device_fps_median"] > 0 and out["device_fps_spread"] >= 0
    assert out["device_streams"] == 2 and out["device_frames"] == 8
    fields = out["device_bytes_per_frame_by_field"]
    assert set(fields) == {"raw_pool", "dc_pool", "nest", "u8_align_pad",
                           "u8_tier_pad", "desc_pool", "mv2_pool",
                           "u32_tier_pad", "flags", "offs", "meta", "metacb",
                           "mv", "wire_payload"}
    assert fields["wire_payload"] > 0 and out["device_pass_mb"] > 0
    assert out["kernel_launches"]["decode_steps"] == \
        (1 + out["device_passes"]) * I320_FRAMES


def test_phase_pipeline(phases):
    out = phases["pipeline"]
    assert out["pipeline_fps"] > 0 and out["backend"] == "cpu"
    assert out["planner"] == "native" and out["plan_ahead"] == 2
    assert set(out["pipeline_split_ms_per_frame"]) == SPLIT_KEYS
    # the warm run and the timed one
    assert out["kernel_launches"]["decode_steps"] == 2 * I320_FRAMES


@pytest.mark.parametrize("phase,key", [("hash", "bitexact"),
                                       ("device", "device_replay_bitexact")])
def test_k28_tail_window_bit_exact(phase, key):
    """K=28 on a 4-frame clip: one dispatch of 4 steps and 24 steps of
    filler slots, which neither check may read as frames."""
    out = one_line(run_bench("--phase", phase,
                             HVQM4_STEPS_PER_DISPATCH="28"))
    assert out[key] is True
    passes = out.get("device_passes", 0)
    assert out["kernel_launches"]["decode_steps"] == 28 * (1 + passes)


def test_main_with_a_budget_that_fits_nothing():
    out = one_line(run_bench(HVQM4_BENCH_BUDGET_S="1"))
    assert out["phase_failures"] == dict.fromkeys(JOBS, "skipped: budget")
    assert set(out) == (BENCH_KEYS - TUNNEL_ONLY) | PORT_KEYS | \
        {"phase_failures"}
    assert out["budget_s"] == 1.0 and out["gpu"] is None
    assert out["oracle_fps"] > 0 and out["retail_oracle_fps"] > 0


def test_result_line_keys(phases):
    """Every phase's fields merged as `main` merges them: the line carries
    bench.py's keys and attributability keys less the tunnel-only ones,
    and the port's."""
    merged = {}
    for prefix, _clip, phase, _env in bench_torch.jobs(I320, I320):
        bench_torch.merge_phase(merged, prefix, phase, phases[phase])
    out = bench_torch.result_line(merged, {}, 100.0, 200.0, clip="320x240",
                                  streams=2, budget_s=1500.0, gpu=None)
    assert set(out) == ((BENCH_KEYS | BENCH_ATTRIBUTION) - TUNNEL_ONLY) | \
        PORT_KEYS | PORT_ATTRIBUTION
    assert out["bitexact"] is out["retail_bitexact"] is True
    assert out["device_replay_bitexact"] is True
    assert set(out["kernel_launches"]) == set(JOBS) - {"plan", "retail_plan"}
    assert out["device_link_ceiling_fps"] > 0 and out["value"] > 0


_NO_JAX = r"""
import os
import sys
sys.modules["jax"] = None        # any `import jax` now raises ImportError,
sys.modules["hvqm4_tpu"] = None  # and so do the JAX package
sys.modules["bench"] = None      # and its bench
import bench_torch
from scripts import (compute_ceiling_torch, device_sweep_torch,
                     profile_split_torch, soak_throughput_torch)
for phase in ("plan", "hash", "device", "pipeline"):
    assert bench_torch.PHASES[phase](2)
for mod, argv in ((device_sweep_torch, ["2", "--repeat", "1"]),
                  (compute_ceiling_torch, ["1"]), (profile_split_torch, ["2"]),
                  (soak_throughput_torch, ["--minutes", "0", "--streams", "2"])):
    sys.argv = [mod.__file__, *argv]
    mod.main()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "hvqm4_tpu", "bench"))
assert loaded == ["bench", "hvqm4_tpu", "jax"], loaded   # only the blockers
print("ok")
"""


def test_bench_and_instruments_never_import_jax():
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO),
                                  **CPU_ENV),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "ok"
