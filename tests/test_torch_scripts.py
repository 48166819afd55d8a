"""The port's training example, measurement scripts and soak, run as a user
runs them, on the CPU (`--device cpu`); and `utils.profiling.torch_trace`.

Each script is the counterpart of a JAX one (`scripts/bench_embed.py`,
`scripts/bench_train.py`, `scripts/soak_device.py`,
`examples/train_vit.py`); the JSON lines keep the JAX scripts' keys.
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


def _run(*args, timeout=300) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO))
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
