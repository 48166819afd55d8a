#!/usr/bin/env bash
# Validation battery of the PyTorch port: what a CI job for the port runs.
# The counterpart of scripts/ci.sh.
#   scripts/ci_torch.sh          # everything but the benchmark on the card
#   scripts/ci_torch.sh bench    # also bench_torch.py (one JSON line)
#
# The CPU tests (tests/test_torch_*.py) hold the port against the JAX
# package, so they need JAX: run them where JAX is installed
# (JAX_PLATFORMS=cpu). On the machine with the card, which has no JAX,
# run the card's tests alone, without tests/conftest.py (it imports JAX):
#   python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
# and `python3 chip_smoke.py`.
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== oracle (-O2 + ASan/UBSan) =="
make -s -C oracle
make -s -C oracle asan

echo "== the port's native planner build =="
python - <<'PY'
from hvqm4_tpu_torch.native import build
print(build())
PY

echo "== the port's tests (CPU; holds the port against JAX) =="
JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py -q

echo "== sanitizer spot-run on a sliced clip of the port's generator =="
out="$(mktemp -d)"
trap 'rm -rf "$out"' EXIT
python - "$out/ci_sliced.h4m" <<'PY'
import sys
from hvqm4_tpu_torch.config import SeqConfig
from tools.encoder_torch import make_clip
open(sys.argv[1], 'wb').write(
    make_clip(SeqConfig(128, 96), ['IPBPB'], seed=90, slices=4))
PY
oracle/hvqm4_oracle_asan "$out/ci_sliced.h4m" /dev/null
echo "sanitizer clean"

if [[ "${1:-}" == "bench" ]]; then
  echo "== benchmark on the card =="
  python bench_torch.py
fi
echo "CI OK"
