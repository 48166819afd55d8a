"""The host half that the port shares with `hvqm4_tpu`, in one place.

Container demux, the C++ and Python entropy planners, the plan schema, the
NumPy golden decoder (the JAX package's session with `backend="numpy"`) and
the oracle digests are reused by import, not copied: none of these modules
imports JAX. Every module of the port, and `chip_smoke.py`, takes them from
here, so the port's dependency on the JAX package's host code is this one
seam.
"""

from __future__ import annotations

import subprocess

from hvqm4_tpu.config import MAX_BASES, MEDIA_VIDEO, SeqConfig  # noqa: F401
from hvqm4_tpu.container import ContainerError, Demuxer, Record  # noqa: F401
from hvqm4_tpu.native import NativePlanner
from hvqm4_tpu.planner import Planner, PlannerError  # noqa: F401
from hvqm4_tpu.plans import FramePlan, PlanePlan  # noqa: F401
from hvqm4_tpu.session import DecoderSession as GoldenSession  # noqa: F401
from hvqm4_tpu.utils.hashing import _K, fnv1a, oracle_csums  # noqa: F401
from hvqm4_tpu.utils.profiling import StageTimer  # noqa: F401


def make_planner(cfg: SeqConfig):
    """The C++ planner, or the Python one (identical plans, far slower) on
    a host where the C++ planner cannot be built with g++."""
    try:
        return NativePlanner(cfg)
    except (OSError, subprocess.CalledProcessError):
        return Planner(cfg)
