"""Ranks, the ("dp", "tp") device mesh and the tensor-parallel collectives.

The JAX package gets these from `jax.sharding` and XLA: one process drives
a `Mesh` of devices, `shard_map` lays the streams over its "dp" axis, and
the SPMD partitioner inserts the ViT's all-reduces over "tp"
(`hvqm4_tpu/models/vit.py:114-121`). The port runs one process per rank
instead, as PyTorch does:

- `launch(fn, world, *args, device=..., backend=...)` starts `world` ranks
  with torch.multiprocessing's "spawn", joins them in one process group
  (TCP rendezvous on 127.0.0.1 at a free port), calls `fn(device, *args)`
  in each and returns the results by rank. A rank's exception is raised
  again in the caller, and the other ranks are stopped.
- `make_mesh(dp, tp, device_type)` is the `DeviceMesh` with dims
  ("dp", "tp"), the counterpart of `Mesh(devices.reshape(dp, tp),
  ("dp", "tp"))`: rank r sits at (r // tp, r % tp).
- `copy_to_tp` and `reduce_from_tp` are Megatron's pair of
  `autograd.Function`s around a tensor-parallel product: identity forward
  and all-reduce of the gradient backward, and the reverse.

The backend is the caller's choice: `nccl` needs a card per rank (it
refuses two ranks on one device), `gloo` serves the CPU and ranks that
share a card. Where the choice cannot serve the ranks, `check_backend`
raises one line; nothing switches to another backend or to the CPU.
"""

from __future__ import annotations

import datetime
import multiprocessing.connection as mpc
import os
import pickle
import socket
import traceback

import torch
import torch.distributed as dist

# a rank that waits this long in one collective raises, so a deadlock fails
# the run instead of hanging it
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def default_backend(device) -> str:
    """`nccl` for CUDA ranks, `gloo` for CPU ranks."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(device, world: int, backend: str) -> None:
    """Raise one line unless `world` ranks on `device` can use `backend`."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is "
                           f"not available")
    if backend == "nccl":
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        if world > cards:
            raise ValueError(
                f"backend 'nccl' needs a CUDA card per rank: {world} ranks on "
                f"{cards} card(s) of {dev.type}; use backend 'gloo' for ranks "
                f"that share a card or run on the CPU")
    elif backend != "gloo":
        raise ValueError(f"unsupported backend {backend!r}")


def rank_device(device, rank: int) -> torch.device:
    """Rank `rank`'s device: `cuda:(rank % cards)` for a CUDA device, else
    the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is "
                           f"not available")
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(dp: int, tp: int, device_type: str):
    """The ("dp", "tp") `DeviceMesh` over the process group's dp*tp ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=("dp", "tp"))


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along the mesh's dim named `axis`."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankError(RuntimeError):
    """A rank's traceback, the cause of the exception `launch` raises."""


def _rank_main(fn, rank: int, world: int, port: int, device, backend: str,
               args: tuple, conn) -> None:
    """One rank: join the group, run `fn`, send ("ok", result) or ("err",
    exception, traceback) through `conn` as plain pickle bytes (tensors in
    a result are copied, not shared)."""
    joined = False
    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:  # CPU ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                timeout=COLLECTIVE_TIMEOUT)
        joined = True
        msg = ("ok", fn(dev, *args))
    except BaseException as e:  # reported to the caller, which raises it
        tb = traceback.format_exc()
        try:
            pickle.dumps(e)
        except Exception:
            e = RuntimeError(f"{type(e).__name__}: {e}")
        msg = ("err", e, tb)
    try:
        conn.send_bytes(pickle.dumps(msg))
    finally:
        conn.close()
        if joined:
            dist.destroy_process_group()


def launch(fn, world: int, *args, device="cuda", backend: str | None = None):
    """Run `fn(device, *args)` on `world` ranks, one process each, joined in
    one process group; return the results, by rank.

    `fn` and `args` are pickled into the ranks (`fn` by its import path);
    `device` is the rank's `rank_device`. `backend` defaults to
    `default_backend(device)`; `check_backend` runs first. A rank that
    raises, or dies without a result, stops every rank, and its exception
    is raised here with the rank's traceback as its cause."""
    backend = backend or default_backend(device)
    check_backend(device, world, backend)
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs, conns = [], []
    try:
        for rank in range(world):
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_rank_main, daemon=True,
                            args=(fn, rank, world, port, device, backend,
                                  args, send))
            p.start()
            send.close()
            procs.append(p)
            conns.append(recv)
        results: list = [None] * world
        pending = set(range(world))
        while pending:
            mpc.wait([conns[r] for r in pending]
                     + [procs[r].sentinel for r in pending])
            for r in sorted(pending):
                if not (conns[r].poll() or not procs[r].is_alive()):
                    continue
                try:
                    msg = pickle.loads(conns[r].recv_bytes())
                except EOFError:
                    procs[r].join()
                    raise RuntimeError(
                        f"rank {r} of {world} exited with code "
                        f"{procs[r].exitcode} before it reported") from None
                if msg[0] == "err":
                    raise msg[1] from RankError(
                        f"rank {r} of {world} failed:\n{msg[2]}")
                results[r] = msg[1]
                pending.discard(r)
        for p in procs:
            p.join()
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
        for c in conns:
            c.close()


def _all_reduce_f32(x, group):
    """Sum `x` over `group` in f32 (whatever its dtype), back in its dtype."""
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_f32(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x, group):
    """Identity forward; backward, the gradient summed over `group` (the
    tensor-parallel ranks each hold a slice of the next product's weights,
    so each sees only its slice's share of `x`'s gradient)."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x, group):
    """`x` summed over `group` forward (each rank holds a partial product);
    identity backward."""
    return _ReduceFromTP.apply(x, group)
