"""The sharded step's five exchange sites over a process group, and the
transport the process mesh's leader and followers speak.

The reference's ``shard_map`` body (``flowsentryx_tpu/parallel/step.py``)
calls five collectives per step: ``axis_index``, ``pmax`` of the batch
clock, ``all_to_all`` of the flow partials to their owners and of the
verdicts back, ``psum`` of the counts and ``all_gather`` of the K-slot
compactions.  On a process mesh (:mod:`.mesh`, one process per shard)
they are ``torch.distributed`` collectives here, one function per site;
on a one-process mesh they are the tensor ops of :mod:`.step`.  Either
way each call reports itself through :func:`_note`, so
:func:`recording_exchanges` (and ``fsx audit``'s census of one call per
site per step body) counts both alike.

Exactness across processes: every value that crosses a process either
moves as its bytes (``all_to_all``, ``all_gather``, ``broadcast``) or
is reduced by an operation whose result does not depend on the order of
its operands (an int64 sum, a float32 max).  Each site says which.

Card tensors go to the collectives as they are.  Under NCCL they are
ordered on the step's stream, so a captured step graph holds them.
Gloo, a host library, takes card tensors for all five sites and copies
them through host memory itself (the card's 2-rank leg, two processes
on one card where NCCL refuses a duplicate GPU: ``chip_smoke.py``
``mesh_processes``), so no site stages them here.

Every wait is bounded: under gloo by ``tuning.MESH_TIMEOUT_S`` (the
group's timeout), under NCCL by the group's own watchdog, since a timed
host wait would block the host inside a capture.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import threading
import time

import torch
import torch.distributed as dist

from flowsentryx_tpu_torch.sync import tuning

# -- the exchange record (``fsx audit``'s census) --------------------------

#: Per thread: the exchange calls being recorded (:func:`recording_exchanges`).
_TLS = threading.local()


def _numels(x) -> list[int]:
    if isinstance(x, torch.Tensor):
        return [x.numel()]
    if isinstance(x, (list, tuple)):
        return [n for v in x for n in _numels(v)]
    return []


def _note(site: str, *operands) -> None:
    """One call of exchange ``site`` over the shards' ``operands``: into
    this thread's record, if one is open."""
    calls = getattr(_TLS, "calls", None)
    if calls is not None:
        calls.append((site, _numels(operands)))


@contextlib.contextmanager
def recording_exchanges(calls: list):
    """Append ``(site, per-shard operand sizes)`` to ``calls`` for each
    exchange this thread makes in the ``with`` body."""
    prev = getattr(_TLS, "calls", None)
    _TLS.calls = calls
    try:
        yield calls
    finally:
        _TLS.calls = prev


# -- moving tensors through the group --------------------------------------


class PeerLost(RuntimeError):
    """A collective of the process mesh failed: a peer died, or did not
    answer within the group's timeout.  The engine's health ladder
    reads it as FAILED (``health`` is set on the way out of
    ``Engine.run``)."""

    health: dict | None = None


def _run(mesh, call) -> None:
    """Start one collective (``call()`` returns its work) and wait for
    it.  Gloo's wait is a host wait, bounded by the group's timeout (a
    dead peer raises).  NCCL's orders the step's stream after the
    collective and returns at once; a timed NCCL wait would block the
    host, which a graph capture refuses, and the group's watchdog bounds
    the collective itself.  A failure raises :class:`PeerLost`."""
    try:
        work = call()
        if mesh.backend == "nccl":
            work.wait()  # noqa: stream-ordered, bounded by NCCL's watchdog
        else:
            work.wait(datetime.timedelta(seconds=tuning.MESH_TIMEOUT_S))
    except RuntimeError as e:
        raise PeerLost(f"process mesh rank {mesh.rank}: a collective "
                       f"failed: {e}") from e


# -- the five exchange sites -------------------------------------------------

#: This process's calls of the five sites and their host wall (the card
#: phase reads the exchange's host ms per batch; ``reset_times`` zeroes).
TIMES = {"calls": 0, "host_s": 0.0}


def reset_times() -> None:
    TIMES.update(calls=0, host_s=0.0)


def _site(fn):
    """One exchange site: each call is noted (:func:`_note`) and timed
    into :data:`TIMES`."""
    name = fn.__name__

    @functools.wraps(fn)
    def run(mesh, *operands):
        _note(name, *operands)
        t = time.perf_counter()
        try:
            return fn(mesh, *operands)
        finally:
            TIMES["calls"] += 1
            TIMES["host_s"] += time.perf_counter() - t

    return run


@_site
def axis_index(mesh) -> int:
    """This shard's id: the rank."""
    return mesh.rank


@_site
def all_to_all(mesh, *bufs: torch.Tensor):
    """Each buffer ``[n_dst, C, ...]`` (row ``o`` goes to owner ``o``) ->
    ``[n_src, C, ...]`` (row ``s`` came from source ``s``): one exchange
    for all the buffers.  ``all_to_all_single``'s equal splits are in
    rank order, so the result is exactly row ``rank`` of the one-process
    transpose.  Bytes only: keys, f32 partials and verdicts cross as
    their bits."""
    out = []
    for b in bufs:
        src = b.contiguous()
        dst = torch.empty_like(src)
        _run(mesh, lambda: dist.all_to_all_single(
            dst, src, group=mesh.group, async_op=True))
        out.append(dst)
    return tuple(out) if len(out) > 1 else out[0]


def _all_reduce(mesh, x: torch.Tensor, op) -> torch.Tensor:
    buf = x.reshape(-1).clone()
    _run(mesh, lambda: dist.all_reduce(buf, op=op, group=mesh.group,
                                       async_op=True))
    return buf.reshape(x.shape)


@_site
def psum(mesh, x: torch.Tensor) -> torch.Tensor:
    """The shards' sum of an integer count: an int64 ``all_reduce``,
    exact in any order."""
    if x.dtype != torch.int64:
        raise TypeError(f"psum carries int64 counts, got {x.dtype}")
    return _all_reduce(mesh, x, dist.ReduceOp.SUM)


@_site
def pmax(mesh, x: torch.Tensor) -> torch.Tensor:
    """The shards' max: a max returns one of its operands unrounded, so
    the f32 clock is the same bits in any order."""
    return _all_reduce(mesh, x, dist.ReduceOp.MAX)


@_site
def all_gather(mesh, x: torch.Tensor) -> torch.Tensor:
    """The shards' values, concatenated in rank order.  Bytes only."""
    return torch.cat(gather(mesh, x))


# -- the leader/follower transport (no step exchange: not recorded) ----------


def gather(mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's ``x`` (one shape on every rank), in rank order, on
    every rank.  Bytes only."""
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    _run(mesh, lambda: dist.all_gather(parts, src, group=mesh.group,
                                       async_op=True))
    return parts


def broadcast(mesh, x: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``x`` into ``x`` on every rank (in place; returned).
    Bytes only.  Under NCCL a host ``x`` crosses through the card."""
    if mesh.backend == "nccl" and x.device.type != "cuda":
        buf = x.to(mesh.device)
    else:
        buf = x.contiguous()
    _run(mesh, lambda: dist.broadcast(buf, 0, group=mesh.group,
                                      async_op=True))
    if buf is not x and mesh.rank:
        x.copy_(buf)
    return x
