"""The host half that the port shares with `hvqm4_tpu`, in one place.

Container demux, the C++ and Python entropy planners, the plan schema, the
NumPy golden decoder (the JAX package's session with `backend="numpy"`),
the oracle digests, the Y4M header and the decode service's wire protocol,
admission, auth, multiplexing, metrics and clients (`hvqm4_tpu.serve`,
whose `DecodeServer` is re-exported as `BaseDecodeServer`) are reused by
import, not copied: none of these modules imports JAX. Every module of the port, and `chip_smoke.py`, takes them from
here, so the port's dependency on the JAX package's host code is this one
seam.
"""

from __future__ import annotations

import subprocess

from hvqm4_tpu.cli import _y4m_header  # noqa: F401
from hvqm4_tpu.config import MAX_BASES, MEDIA_VIDEO, SeqConfig  # noqa: F401
from hvqm4_tpu.container import ContainerError, Demuxer, Record  # noqa: F401
from hvqm4_tpu.native import NativePlanner
from hvqm4_tpu.planner import Planner, PlannerError  # noqa: F401
from hvqm4_tpu.plans import FramePlan, PlanePlan  # noqa: F401
from hvqm4_tpu.serve import (MODE_EMBED, MODE_METRICS,  # noqa: F401
                             MODE_METRICS_PROM, MODE_RGB, MODE_YUV,
                             STATUS_AUTH, STATUS_BUSY, STATUS_ERROR,
                             STATUS_OK, BusyError, MuxClient, decode_remote,
                             fetch_metrics)
from hvqm4_tpu.serve import DecodeServer as BaseDecodeServer  # noqa: F401
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
