"""The port's training example, measurement scripts and soak, run as a user
runs them, on the CPU (`--device cpu`); and `utils.profiling.torch_trace`.

Each script is the counterpart of a JAX one (`scripts/bench_embed.py`,
`scripts/bench_train.py`, `scripts/soak_device.py`,
`examples/train_vit.py`, and `bench_torch.py`'s instruments
`scripts/device_sweep.py`, `compute_ceiling.py`, `profile_split.py` and
`soak_throughput.py`); the JSON lines keep the JAX scripts' keys.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hvqm4_tpu.config import SeqConfig
from hvqm4_tpu_torch.utils.profiling import torch_trace
from tools.encoder import make_clip

REPO = Path(__file__).resolve().parent.parent

# the keys of the JAX scripts' JSON lines (less their `backend`), and the
# port's additions
EMBED_KEYS = {"config", "streams", "clip", "vit", "frames", "embed_fps"}
TRAIN_KEYS = {"config", "streams", "clip", "vit", "frames", "train_fps",
              "decode_s", "train_s", "last_loss"}


def _run(*args, timeout=300, env=None) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO), **(env or {}))
    return subprocess.run([sys.executable, *map(str, args)], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


@pytest.fixture(scope="module")
def tiny_clip(tmp_path_factory) -> Path:
    path = tmp_path_factory.mktemp("clips") / "tiny.h4m"
    path.write_bytes(make_clip(SeqConfig(64, 48), ["IPBPB"], seed=3))
    return path


@pytest.mark.parametrize("script,keys,rate", [
    ("bench_embed_torch.py", EMBED_KEYS | {"device", "card"}, "embed_fps"),
    ("bench_train_torch.py",
     TRAIN_KEYS | {"device", "card", "ms_per_step"}, "train_fps")])
def test_bench_script_prints_one_json_line(tiny_clip, script, keys, rate):
    res = _run(REPO / "scripts" / script, 2, "--clip", tiny_clip,
               "--image-size", 32, "--device", "cpu")
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == keys
    assert out["streams"] == 2 and out["frames"] == 10
    assert out[rate] > 0 and out["device"] == "cpu" and out["card"] is None
    assert out["vit"] == "384d x6 p16 32px"
    if "train_s" in out:
        assert out["decode_s"] >= 0 and out["train_s"] > 0
        assert out["ms_per_step"] > 0 and out["last_loss"] >= 0


# `bench_torch.py`'s instruments: the JAX scripts' keys, with the port's
# `card` (and `backend`, the torch device type)
INSTRUMENTS = [
    (("device_sweep_torch.py", 2),
     {"streams", "steps", "frames", "steps_per_dispatch", "mb_per_step",
      "backend", "card", "full_ms_per_step", "device_fps",
      "compute_ms_per_step", "compute_fps", "upload_ms_per_step",
      "upload_fps", "upload_gbps"}),
    (("compute_ceiling_torch.py", 2),
     {"compute_only_fps_samples", "compute_only_fps_best", "streams",
      "frames_per_pass", "backend", "card"}),
    (("profile_split_torch.py", 2),
     {"streams", "steps", "frames", "steps_per_dispatch", "wall_s", "fps",
      "plan_ms_per_step", "xfer_ms_per_step", "step_ms_per_step", "sync_ms",
      "kib_per_step", "upload_mb_per_s", "backend", "card"}),
    (("soak_throughput_torch.py", "--minutes", 0.01, "--streams", 2),
     {"soak", "passes", "fps_median", "fps_head3", "fps_tail3", "fps_min",
      "fps_max", "stable", "backend", "card"})]


@pytest.mark.parametrize("args,keys", INSTRUMENTS,
                         ids=[a[0] for a, _k in INSTRUMENTS])
def test_bench_instrument_prints_its_keys(args, keys):
    """Each instrument on `--device cpu` at testdata/i320.h4m (4 frames), 2
    streams; the soak prints a line a pass before its summary."""
    env = {"HVQM4_BENCH_CLIP": str(REPO / "testdata" / "i320.h4m"),
           "HVQM4_BENCH_STREAMS": "2", "OMP_NUM_THREADS": "1"}
    res = _run(REPO / "scripts" / args[0], *args[1:], "--device", "cpu",
               env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(line) for line in res.stdout.strip().splitlines()]
    out = lines[-1]
    assert set(out) == keys
    assert out["backend"] == "cpu" and out["card"] is None
    if "soak" in out:
        assert out["passes"] == len(lines) - 1 >= 1 and out["fps_min"] > 0
        assert all(set(p) == {"pass", "fps", "frames", "rss_mb"} and
                   p["frames"] == 8 for p in lines[:-1])
    else:
        assert len(lines) == 1 and out["streams"] == 2
        assert min(v for k, v in out.items()
                   if k.endswith(("fps", "fps_best"))) > 0
        assert out.get("frames", out.get("frames_per_pass")) == 8


def test_soak_two_seeds_oracle_exact():
    if subprocess.run(["make", "-s", "-C", str(REPO / "oracle")],
                      capture_output=True).returncode != 0:
        pytest.skip("the C oracle does not build here")
    res = _run(REPO / "scripts" / "soak_device_torch.py", 2, 5000,
               "--device", "cpu")
    assert res.returncode == 0, res.stderr[-2000:]
    assert "PASS: 2 randomized device-path configs bit-exact vs oracle on " \
        "cpu" in res.stdout
    assert "[2/2] ok  seed=5001" in res.stdout


def test_train_example_loss_falls():
    res = _run(REPO / "examples" / "train_vit_torch.py", "--device", "cpu",
               "--streams", 2, "--epochs", 2)
    assert res.returncode == 0, res.stdout + res.stderr[-2000:]
    assert res.stdout.startswith("steps=16 first_loss=")
    assert res.stdout.rstrip().endswith("(single device)")


def test_train_example_takes_clips(tiny_clip):
    res = _run(REPO / "examples" / "train_vit_torch.py", "--device", "cpu",
               "--clip", tiny_clip, "--clip", tiny_clip, "--epochs", 2)
    assert res.returncode == 0, res.stdout + res.stderr[-2000:]
    assert res.stdout.startswith("steps=10 ")


def test_train_example_on_a_gloo_mesh(tiny_clip):
    """`--dp 2 --tp 2` on four gloo ranks of the CPU: rank 0 prints the JAX
    example's line, and the loss falls."""
    res = _run(REPO / "examples" / "train_vit_torch.py", "--device", "cpu",
               "--clip", tiny_clip, "--clip", tiny_clip, "--epochs", 2,
               "--dp", 2, "--tp", 2, "--backend", "gloo")
    assert res.returncode == 0, res.stdout + res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("steps=10 first_loss=")
    assert lines[0].endswith("(mesh dp=2 tp=2)")


def test_train_example_refuses_nccl_without_a_card_per_rank(tiny_clip):
    res = _run(REPO / "examples" / "train_vit_torch.py", "--device", "cpu",
               "--clip", tiny_clip, "--clip", tiny_clip, "--dp", 2,
               "--backend", "nccl")
    assert res.returncode == 1 and res.stdout == ""
    assert res.stderr.strip().splitlines() == [
        "train_vit_torch.py: backend 'nccl' needs a CUDA card per rank: 2 "
        "ranks on 0 card(s) of cpu; use backend 'gloo' for ranks that share "
        "a card or run on the CPU"]


def test_torch_trace_writes_a_trace(tmp_path):
    logdir = tmp_path / "trace"
    with torch_trace(str(logdir)):
        torch.ones(64).cumsum(0)
    trace = json.loads((logdir / "trace.json").read_text())
    assert any("cumsum" in ev.get("name", "")
               for ev in trace["traceEvents"])


@pytest.mark.parametrize("logdir", [None, ""])
def test_torch_trace_off_is_a_no_op(tmp_path, monkeypatch, logdir):
    monkeypatch.chdir(tmp_path)
    with torch_trace(logdir):
        assert not torch.autograd.profiler._is_profiler_enabled
    assert list(tmp_path.iterdir()) == []
