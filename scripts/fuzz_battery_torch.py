"""Extended one-off fuzz battery of the port (superset of the in-suite
fuzz tests' sizes).

The counterpart of `scripts/fuzz_battery.py`, on the port's own host
modules: mutated clips from varied bases (shapes x slices x audio x version
x dc_shift), made by the port's generator `tools/encoder_torch.py`, are fed
to BOTH independent implementations:
  - the ASan/UBSan C oracle (must exit 0/1, never a sanitizer abort)
  - the port's demuxer + C++ planner (`container.Demuxer`,
    `native.NativePlanner`; must decode or raise
    ContainerError/PlannerError, never crash or hang)

    python scripts/fuzz_battery_torch.py [n_mutants] [base_seed]

Host only; no JAX and nothing of the JAX package. The same `BASES`,
`mutate` and seeds as the JAX battery, so both batteries feed the oracle
the same mutants. Results are printed per base; any finding reproduces
from (base description, seed printed on failure). `chip_smoke.py` takes
these mutants to the card: those the oracle decodes and the planner plans
whole go through the arena decoder there.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from hvqm4_tpu_torch.config import SeqConfig  # noqa: E402
from hvqm4_tpu_torch.container import ContainerError, Demuxer  # noqa: E402
from hvqm4_tpu_torch.native import NativePlanner, PlannerError  # noqa: E402
from tools.encoder_torch import make_clip  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]

BASES = [
    dict(cfg=SeqConfig(64, 48), gops=["IPB"], audio_channels=1),
    dict(cfg=SeqConfig(64, 48), gops=["IPBPB", "IPP"], slices=3,
         audio_channels=2),
    dict(cfg=SeqConfig(32, 16), gops=["I"]),
    dict(cfg=SeqConfig(96, 80, 1, 1), gops=["IBBP"], dc_shift=3),
    dict(cfg=SeqConfig(128, 96), gops=["IPPP"], slices=6, mv_extreme=True),
    dict(cfg=SeqConfig(48, 64, version="1.5"), gops=["IPB", "IP"],
         audio_channels=2, slices=2),
]


def mutate(data: bytes, rng, n_mut: int) -> bytes:
    buf = bytearray(data)
    for _ in range(n_mut):
        buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
    return bytes(buf)


def base_mutants(n: int, base_seed: int):
    """Yield, base by base, (base index, base spec without cfg, cfg, its
    `n // len(BASES)` mutants), in the JAX battery's order and from its
    seeds."""
    per_base = n // len(BASES)
    for bi, spec in enumerate(BASES):
        spec = dict(spec)
        cfg = spec.pop("cfg")
        clip = make_clip(cfg, seed=base_seed + bi, **spec)
        rng = np.random.default_rng(base_seed * 7 + bi)
        yield bi, spec, cfg, [mutate(clip, rng, int(rng.integers(1, 14)))
                              for _ in range(per_base)]


def planner_probe(cfg: SeqConfig, data: bytes) -> None:
    """Demux + plan every video record (the host attack surface)."""
    try:
        d = Demuxer(data)
        if d.info.cfg != cfg:
            return  # header mutation changed the sequence shape: fine
        pl = NativePlanner(cfg)
        for r in d.video_records():
            pl.plan_frame(r.frame_char, r.payload)
    except (ContainerError, PlannerError, ValueError):
        pass  # clean rejection is the contract


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    base_seed = int(sys.argv[2]) if len(sys.argv) > 2 else 11000
    subprocess.run(["make", "-s", "-C", str(REPO / "oracle"), "asan"],
                   check=True)
    asan = REPO / "oracle" / "hvqm4_oracle_asan"
    per_base = n // len(BASES)
    with tempfile.TemporaryDirectory() as td:
        p = pathlib.Path(td) / "m.h4m"
        for bi, spec, cfg, muts in base_mutants(n, base_seed):
            for i, mutated in enumerate(muts):
                p.write_bytes(mutated)
                res = subprocess.run(
                    [str(asan), "--audio", str(pathlib.Path(td) / "a.pcm"),
                     str(p), "/dev/null"],
                    capture_output=True, timeout=60)
                assert res.returncode in (0, 1), (
                    f"ORACLE base={bi} iter={i}: rc={res.returncode}\n"
                    + res.stderr.decode()[:2000])
                planner_probe(cfg, mutated)
            print(f"base {bi + 1}/{len(BASES)}: {per_base} mutants clean "
                  f"({cfg.width}x{cfg.height} {spec})", flush=True)
    print(f"PASS: {per_base * len(BASES)} mutants, oracle sanitizer-clean, "
          f"planner decode-or-reject")


if __name__ == "__main__":
    main()
