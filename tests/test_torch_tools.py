"""The port's tools against their JAX-package originals, on the CPU.

- `tools/encoder_torch.make_clip` writes `tools/encoder.make_clip`'s bytes
  over a grid of shapes, samplings, versions, slices, DC shifts, audio,
  extreme vectors, GOP lists and seeds, and regenerates
  testdata/ref640.h4m byte for byte with nothing of JAX loaded (through
  `bench_torch.load_clip`, which generates a missing clip as `bench.py`'s
  `ensure_clip` does);
- each tool's command line prints or writes what its original does at the
  same arguments: `encoder_torch.py`, `dump_payloads_torch.py`,
  `rd_sweep_torch.py` (search off, and on with `--device cpu`),
  `scripts/fuzz_battery_torch.py`; `make_retail_clip_torch.retail_frames`
  gives the original's frames;
- a small mirror of tests/test_fuzz.py's planner and demuxer cases on the
  port's `NativePlanner` and `Demuxer`, each decision and plan held against
  the JAX package's;
- the port's soak, `entry.dryrun_multichip` and the training example take
  the clips that their JAX counterparts make.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from hvqm4_tpu.config import SeqConfig as JaxSeqConfig
from hvqm4_tpu.container import ContainerError as JaxContainerError
from hvqm4_tpu.container import Demuxer as JaxDemuxer
from hvqm4_tpu.native import NativePlanner as JaxPlanner
from hvqm4_tpu.native import PlannerError as JaxPlannerError
from hvqm4_tpu_torch.config import SeqConfig
from hvqm4_tpu_torch.container import ContainerError, Demuxer
from hvqm4_tpu_torch.native import NativePlanner, PlannerError
from tools import encoder as jax_encoder
from tools import encoder_torch

from .conftest import REPO

# (w, h, sampling, version, gops, seed, slices, dc_shift, audio channels,
# mv_extreme): 4:2:0 and 4:4:4, versions 1.3 and 1.5, slices 1/3/6,
# dc_shift None (drawn per frame)/0/3, audio 0/1/2, mv_extreme both ways
GRID = [
    (32, 16, 2, "1.3", ["I"], 0, 1, None, 0, False),
    (32, 16, 1, "1.5", ["IPB"], 1, 1, 0, 1, False),
    (64, 48, 2, "1.3", ["IPBPB", "IPP"], 2, 3, None, 2, False),
    (64, 48, 2, "1.5", ["IPBPB", "IPP"], 3, 3, 3, 0, True),
    (64, 48, 1, "1.3", ["IBBP"], 4, 3, 0, 2, True),
    (48, 64, 2, "1.5", ["IPB", "IP"], 5, 2, None, 2, False),
    (48, 64, 1, "1.3", ["IPPP", "I"], 6, 1, 3, 1, True),
    (96, 80, 1, "1.3", ["IBBP"], 7, 1, 3, 0, False),
    (96, 80, 2, "1.5", ["IBBPBP", "IPP"], 8, 5, None, 1, True),
    (128, 96, 2, "1.3", ["IPPP"], 9, 6, None, 0, True),
    (128, 96, 2, "1.5", ["IPBPB"], 10, 6, 0, 2, False),
    (128, 96, 1, "1.5", ["IBPB", "IP"], 11, 6, 3, 1, False),
    (128, 96, 1, "1.3", ["I", "I", "IP"], 12, 3, 0, 2, True),
    (80, 32, 2, "1.3", ["IPBPBPBP"], 13, 2, 3, 0, False),
    (16, 16, 1, "1.5", ["IBP"], 14, 2, None, 1, True),
    (112, 64, 2, "1.3", ["IBBPBP", "IPPP", "IB" + "P" * 3], 15, 4, 0, 2,
     False),
]


@pytest.mark.parametrize("w,h,samp,version,gops,seed,slices,dc_shift,audio,"
                         "mv_extreme", GRID)
def test_make_clip_matches_jax(w, h, samp, version, gops, seed, slices,
                               dc_shift, audio, mv_extreme):
    kwargs = dict(seed=seed, slices=slices, dc_shift=dc_shift,
                  audio_channels=audio, mv_extreme=mv_extreme)
    ours = encoder_torch.make_clip(SeqConfig(w, h, samp, samp, version),
                                   gops, **kwargs)
    theirs = jax_encoder.make_clip(JaxSeqConfig(w, h, samp, samp, version),
                                   gops, **kwargs)
    assert ours == theirs
    assert Demuxer(ours).info.video_frames == sum(map(len, gops))


def test_make_clip_timing_and_audio_options_match_jax():
    kwargs = dict(seed=21, audio_channels=2, audio_rate=22050,
                  audio_samples_per_record=512, usec_per_frame=40000)
    assert (encoder_torch.make_clip(SeqConfig(64, 48), ["IPB"], **kwargs)
            == jax_encoder.make_clip(JaxSeqConfig(64, 48), ["IPB"],
                                     **kwargs))


@pytest.mark.parametrize("gops,slices,message", [
    (["PI"], 1, "every GOP must start with an I frame"),
    (["I"], 3, r"slice count must be in \[1, 2\]")])
def test_make_clip_refusals_match_jax(gops, slices, message):
    with pytest.raises(ValueError, match=message):
        encoder_torch.make_clip(SeqConfig(32, 16), gops, slices=slices)
    with pytest.raises(ValueError, match=message):
        jax_encoder.make_clip(JaxSeqConfig(32, 16), gops, slices=slices)


_REF640 = r"""
import pathlib
import sys
sys.modules["jax"] = None
sys.modules["hvqm4_tpu"] = None
sys.modules["tools.encoder"] = None
import bench_torch
path = pathlib.Path(sys.argv[1])
cfg, data = bench_torch.load_clip(path)
assert (cfg.width, cfg.height) == (640, 480) and path.read_bytes() == data
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "hvqm4_tpu")]
assert sorted(loaded) == ["hvqm4_tpu", "jax"], loaded  # the blockers alone
"""


def test_ref640_regenerated_by_the_port_alone(tmp_path):
    """`bench_torch.load_clip` generates a missing clip with `bench.py`'s
    arguments: the port's generator, with JAX, the JAX package and
    `tools/encoder.py` blocked, writes testdata/ref640.h4m byte for byte
    (3,781,173 B; about 40 s on one CPU core)."""
    path = tmp_path / "sub" / "ref640.h4m"
    res = subprocess.run([sys.executable, "-c", _REF640, str(path)],
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert path.read_bytes() == (REPO / "testdata" / "ref640.h4m").read_bytes()


def _run(*args, cwd=REPO, timeout=300) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *map(str, args)], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.parametrize("args", [
    [],
    ["--width", "64", "--height", "48", "--gops", "IPB,IP", "--seed", "5",
     "--audio-channels", "2", "--slices", "3"],
    ["--width", "48", "--height", "32", "--sampling", "444", "--version",
     "1.5", "--dc-shift", "3", "--gops", "IBBP"]])
def test_encoder_cli_matches_jax(tmp_path, args):
    runs = []
    for tool in ("encoder.py", "encoder_torch.py"):
        out = tmp_path / f"{tool}.h4m"
        res = _run(REPO / "tools" / tool, out, *args)
        assert res.returncode == 0, res.stderr[-2000:]
        runs.append((out.read_bytes(), res.stdout.replace(str(out), "OUT")))
    assert runs[0] == runs[1]


def test_dump_payloads_cli_matches_jax(tmp_path):
    runs = []
    for tool in ("dump_payloads.py", "dump_payloads_torch.py"):
        out = tmp_path / f"{tool}.bin"
        res = _run(REPO / "tools" / tool, REPO / "testdata" / "i320.h4m", out)
        assert res.returncode == 0, res.stderr[-2000:]
        runs.append((out.read_bytes(), res.stdout.replace(str(out), "OUT")))
    assert runs[0] == runs[1]
    assert runs[0][1] == "wrote OUT: 4 frames, 320x240\n"


@pytest.mark.parametrize("search", [[], ["--tpu-search"]])
def test_rd_sweep_table_matches_jax(search):
    """The printed table (bytes, bpp, PSNR, mode histograms) at each
    lambda; with the search on, the port's runs on `--device cpu`."""
    args = ["--width", 64, "--height", 48, "--gops", "IPB", "--lambdas",
            "2,8", *search]
    theirs = _run(REPO / "tools" / "rd_sweep.py", *args)
    ours = _run(REPO / "tools" / "rd_sweep_torch.py", *args,
                *(["--device", "cpu"] if search else []))
    assert theirs.returncode == ours.returncode == 0, ours.stderr[-2000:]
    assert ours.stdout == theirs.stdout
    assert len(ours.stdout.splitlines()) == 3


def test_rd_sweep_search_without_a_card_is_one_line():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    res = _run(REPO / "tools" / "rd_sweep_torch.py", "--width", 32,
               "--height", 16, "--gops", "I", "--lambdas", "2",
               "--tpu-search")
    assert res.returncode == 1 and res.stdout == ""
    assert res.stderr.strip().splitlines() == [
        "rd_sweep_torch.py: device 'cuda' requested but CUDA is not "
        "available"]


def test_make_retail_clip_frames_and_gops_match_jax():
    from tools import make_retail_clip, make_retail_clip_torch

    assert make_retail_clip_torch.GOPS == make_retail_clip.GOPS
    n = sum(map(len, make_retail_clip.GOPS))
    ours = make_retail_clip_torch.retail_frames(SeqConfig(640, 480), n)
    theirs = make_retail_clip.retail_frames(JaxSeqConfig(640, 480), n)
    assert len(ours) == len(theirs) == 28
    for fo, ft in zip(ours, theirs):
        for a, b in zip(fo, ft):
            assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)


def test_make_retail_clip_help_matches_jax():
    # the same options and help, the usage wrapped at another width
    outs = [" ".join(_run(REPO / "tools" / tool, "--help").stdout.replace(
        tool, "T").split())
        for tool in ("make_retail_clip.py", "make_retail_clip_torch.py")]
    assert outs[0] == outs[1] and "--target-kb" in outs[0]


# a small mirror of tests/test_fuzz.py on the port's planner and demuxer


def _plan_or_reject(planner, error, fchar, payload):
    try:
        return planner.plan_frame(fchar, payload)
    except error:
        return None


def _same_plans(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    for x, y in zip((a, *a.planes), (b, *b.planes)):
        for f in dataclasses.fields(x):
            if f.name == "planes":
                continue
            u, v = getattr(x, f.name), getattr(y, f.name)
            if isinstance(u, np.ndarray):
                if not np.array_equal(u, v):
                    return False
            elif u != v:
                return False
    return True


def test_native_planner_rejects_random_payloads_as_jax():
    ours, theirs = NativePlanner(SeqConfig(64, 48)), \
        JaxPlanner(JaxSeqConfig(64, 48))
    rng = np.random.default_rng(0)
    rejected = 0
    for _ in range(200):
        payload = rng.integers(0, 256, size=int(rng.integers(0, 400)),
                               dtype=np.uint8).tobytes()
        a = _plan_or_reject(ours, PlannerError, "I", payload)
        b = _plan_or_reject(theirs, JaxPlannerError, "I", payload)
        assert _same_plans(a, b)
        rejected += a is None
    assert rejected > 150  # nearly all random blobs are invalid


@pytest.mark.parametrize("kwargs,seed", [
    ({}, 3), ({"slices": 3, "audio_channels": 2}, 8)])
def test_native_planner_survives_bitflips_as_jax(kwargs, seed):
    """Mutated payloads of a clip (and of a sliced clip with audio): the
    port's planner decodes or raises `PlannerError`, never crashes, and
    decides and plans as the JAX package's planner does."""
    cfg = SeqConfig(64, 48)
    clip = encoder_torch.make_clip(cfg, ["IPBPB", "IPP"], seed=seed, **kwargs)
    payloads = [(r.frame_char, r.payload)
                for r in Demuxer(clip).video_records()]
    ours, theirs = NativePlanner(cfg), JaxPlanner(JaxSeqConfig(64, 48))
    rng = np.random.default_rng(seed)
    rejected = 0
    for _ in range(300):
        fchar, payload = payloads[int(rng.integers(0, len(payloads)))]
        p = bytearray(payload)
        for _ in range(int(rng.integers(1, 8))):
            p[int(rng.integers(0, len(p)))] = int(rng.integers(0, 256))
        a = _plan_or_reject(ours, PlannerError, fchar, bytes(p))
        b = _plan_or_reject(theirs, JaxPlannerError, fchar, bytes(p))
        assert _same_plans(a, b)
        rejected += a is None
    assert rejected > 50


def test_demuxer_rejects_corrupt_headers_as_jax():
    from scripts.fuzz_battery_torch import mutate

    clip = encoder_torch.make_clip(SeqConfig(64, 48), ["I"], seed=4)
    rng = np.random.default_rng(2)
    rejected = 0
    for _ in range(200):
        mutated = mutate(clip, rng, int(rng.integers(1, 6)))
        try:
            ours = [(r.media_type, r.frame_char, r.payload)
                    for r in Demuxer(mutated).records()]
        except ContainerError:
            ours = None
        try:
            theirs = [(r.media_type, r.frame_char, r.payload)
                      for r in JaxDemuxer(mutated).records()]
        except JaxContainerError:
            theirs = None
        assert ours == theirs
        rejected += ours is None
    assert rejected > 5


def test_fuzz_battery_matches_jax():
    """`fuzz_battery_torch.py 60`: rc 0 and the PASS line, every line the
    JAX battery prints on the same mutants."""
    ours = _run(REPO / "scripts" / "fuzz_battery_torch.py", 60)
    assert ours.returncode == 0, ours.stderr[-2000:]
    assert ours.stdout.splitlines()[-1] == (
        "PASS: 60 mutants, oracle sanitizer-clean, planner decode-or-reject")
    theirs = _run(REPO / "scripts" / "fuzz_battery.py", 60)
    assert theirs.returncode == 0, theirs.stderr[-2000:]
    assert ours.stdout == theirs.stdout


def test_fuzz_battery_bases_match_jax():
    from scripts import fuzz_battery, fuzz_battery_torch

    assert len(fuzz_battery_torch.BASES) == len(fuzz_battery.BASES) == 6
    for a, b in zip(fuzz_battery_torch.BASES, fuzz_battery.BASES):
        a, b = dict(a), dict(b)
        assert dataclasses.asdict(a.pop("cfg")) == \
            dataclasses.asdict(b.pop("cfg"))
        assert a == b


# the clips of the soak, the dry run and the training example


class _Drawn(Exception):
    pass


@pytest.mark.parametrize("seed", [5000, 5001, 5002, 5003, 5004, 5005, 7777])
def test_soak_draws_the_jax_soaks_clips(monkeypatch, seed):
    """`scripts/soak_device_torch.case_clips(seed)` gives the streams, the
    geometry, K and the planner threads that `scripts/soak_device.py`'s
    `one_case(seed)` draws: the JAX soak runs until its decoder is built,
    which captures them."""
    from scripts import soak_device
    from scripts.soak_device_torch import case_clips

    drawn = {}

    def capture(cfg, clips, planner_factory, steps_per_dispatch):
        drawn.update(cfg=cfg, clips=clips, k=steps_per_dispatch,
                     threads=os.environ["HVQM4_PLANNER_THREADS"])
        raise _Drawn

    monkeypatch.setenv("HVQM4_PLANNER_THREADS", "0")
    monkeypatch.setattr(soak_device, "MultiStreamDecoder", capture)
    with pytest.raises(_Drawn):
        soak_device.one_case(None, seed)
    cfg, clips, threads, k, desc = case_clips(seed)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(drawn["cfg"])
    assert clips == drawn["clips"]
    assert (str(threads), k) == (drawn["threads"], drawn["k"])
    assert desc.startswith(f"seed={seed} {cfg.width}x{cfg.height} ")


def test_train_example_clips_match_jax():
    """`examples/train_vit_torch.make_clips`, the example's clips without
    `--clip`, are `examples/train_vit.py`'s."""
    from examples.train_vit_torch import make_clips

    jcfg = JaxSeqConfig(64, 48)
    assert make_clips(SeqConfig(64, 48), 3) == [
        jax_encoder.make_clip(jcfg, ["IPBPB", "IPP"], seed=s)
        for s in range(3)]


@pytest.mark.parametrize("dp,budget_s", [(2, 200), (2, 480), (4, 480),
                                         (1, 100)])
def test_dryrun_clips_match_jax(dp, budget_s):
    """`entry.dryrun_clips` gives `__graft_entry__.dryrun_multichip`'s
    clips: 64x48, two streams a "dp" shard of ["IPBPB", "IPP"], or one of
    ["IPB", "IP"] under a budget below 300 s, stream s of seed s."""
    from hvqm4_tpu_torch.entry import dryrun_clips

    cfg, clips = dryrun_clips(dp, budget_s)
    small = budget_s < 300
    gops = ["IPB", "IP"] if small else ["IPBPB", "IPP"]
    n = dp if small else 2 * dp
    assert (cfg.width, cfg.height) == (64, 48)
    assert clips == [jax_encoder.make_clip(JaxSeqConfig(64, 48), gops, seed=s)
                     for s in range(n)]


def test_fuzz_mutants_through_the_arena_match_golden(capsys):
    """`chip_smoke.fuzz_child`, the card's half of the fuzz battery, on the
    CPU: the mutants that the oracle decodes and the planner plans whole
    go through the arena decoder at K = 1 and 2, and every frame equals
    the golden decoder's; none parts from the oracle."""
    import json

    import chip_smoke

    chip_smoke.fuzz_child("cpu")
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["mutants"] == 60 and res["parts"] == []
    assert res["on_device"] == 25 and res["oracle_rejects"] == 35
    assert res["decode_steps"] == 53
