"""CUDA graphs: the port's counterpart of ``jax.jit`` for the serving
step and for each megastep rung.

The reference makes each step one dispatch with ``jax.jit``
(``flowsentryx_tpu/ops/fused.py:753-766``) and a backlog of N batches one
dispatch with a jitted ``lax.scan`` per rung (``:799-879``).  Eagerly the
port's step is ~420 device ops, each enqueued by the host; a
:class:`StepGraph` captures the whole step (or the N steps of a rung)
once and replays it with one launch.

Capture follows ``torch.cuda.graph``'s rules: a few warm-up runs on a
side stream with an ALL-MASKED input (``n_valid = 0``, which changes no
table row and no counter; the first one under
``torch.cuda.set_sync_debug_mode("error")``, so a hidden host sync names
itself instead of breaking the capture), then the capture.  What a
caller must respect:

* **Static input and outputs.**  A dispatch copies its batch into
  :attr:`StepGraph.input` and replays; :attr:`StepGraph.out` and
  :attr:`StepGraph.keep` are overwritten by the next replay, so anything
  read after that (the wire's host copy, the block arrays an overflowed
  wire falls back to) must be copied out right after the replay, on the
  same stream.
* **Addresses are fixed at capture.**  The table, stats and params
  tensors are captured by address: the owner must never rebind them.
* **Params are read by address too.**  The float scorers read their
  params tensors, and ``score_int8`` reads its weights, scalars and
  output table from the engine's :class:`~.kernels.ScorePack` buffer,
  whose address is the only thing the kernel node holds.  New params are
  copied INTO those tensors and that buffer on the replay stream
  (``Engine.hot_swap``): a replay enqueued after the copy scores with
  them, and no graph is captured again.  What the step derives from the
  params on the host at capture (the wire's input observer, the leaves'
  shapes) must not change; ``models/registry.py::validate_swap`` refuses
  a swap that would change it.
* **Launch counting.**  A kernel wrapper counts a launch in its host
  code, which runs once, at capture.  The warm-ups and the capture count
  into dicts of their own thread (:func:`~.kernels.counting_into`): the
  capture's counts become :attr:`StepGraph.launches`, which each
  :meth:`replay` adds to ``kernels.LAUNCHES``, the warm-ups' are kept as
  :attr:`StepGraph.warmup_launches`, and a capture on another thread
  never touches the counts that replays add meanwhile.
* **Capture beside serving** (a tiered warm's background fill,
  ``Engine.warm(tiered=True)``).  The warm-ups run on ``warm_state``, a
  scratch table and stats of the live shapes, so no read-modify-write
  of the live state races the replays on the step's stream; the capture
  itself executes nothing and records the live tensors' addresses.  The
  first warm-up's sync check (``sync_check``) changes a process-wide
  mode, so a background capture skips it: the foreground capture of the
  same base step has already proved it free of host syncs.  Entering
  ``torch.cuda.graph`` synchronizes the device, which stalls only the
  capturing thread.

Each graph keeps its own memory pool.  Where torch can keep the graph
before instantiating it (``CUDAGraph(keep_graph=True)``), its node count
is read with libcuda's ``cuGraphGetNodes`` (:attr:`StepGraph.nodes`,
else None): a launch costs in proportion to it.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Callable

import torch

from flowsentryx_tpu_torch.ops import fused, kernels

#: Warm-up runs of the eager function before a capture.
WARMUPS = 3

#: Graphs captured in this process (a swap or a restore must add none).
CAPTURES = 0
_CAPTURES_LOCK = threading.Lock()


def _new_graph() -> tuple[torch.cuda.CUDAGraph, bool]:
    """A graph that keeps its ``cudaGraph_t`` past the capture where
    this torch can (so its nodes can be counted), else a plain one."""
    try:
        return torch.cuda.CUDAGraph(keep_graph=True), True
    except TypeError:
        return torch.cuda.CUDAGraph(), False


def _node_count(graph: torch.cuda.CUDAGraph) -> int | None:
    """Nodes of a kept, not yet instantiated graph (``cuGraphGetNodes``)."""
    try:
        raw = graph.raw_cuda_graph()
        n = ctypes.c_size_t(0)
        rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
            ctypes.c_void_p(int(raw)), None, ctypes.byref(n))
        return int(n.value) if rc == 0 else None
    except (AttributeError, OSError, RuntimeError, TypeError):
        return None


class StepGraph:
    """One captured ``fn(table, stats, params, raw) -> (table, stats,
    out)`` over a static ``[*in_shape]`` int32 input on the card; with
    ``slots=True`` the function takes the input's leading slices as
    separate arguments, ``fn(table, stats, params, *raws)`` (a drain-ring
    round, :mod:`..fused.device_loop`).

    ``out`` is the step's :class:`~.fused.StepOutput` (or the round's
    ``RingOutput``) of static tensors; ``keep`` is
    :func:`~.fused.block_record` of it (block arrays and clock as one
    flat buffer, so one copy per dispatch preserves them).  ``warm_state``
    is the ``(table, stats)`` the warm-ups run on (default the live
    ones); ``sync_check`` runs the first warm-up under
    ``set_sync_debug_mode("error")``.  A failed capture raises; there is
    no eager fallback.  ``capture_s`` is the wall of warm-ups and
    capture, ``nodes`` the graph's node count (None where not read)."""

    def __init__(self, fn: Callable, table, stats, params,
                 in_shape: tuple[int, ...], slots: bool = False,
                 warm_state: tuple | None = None, sync_check: bool = True):
        dev = table.key_rows.device
        if dev.type != "cuda":
            raise ValueError(f"StepGraph: CUDA graphs need a CUDA table, "
                             f"got {dev}")
        t0 = time.perf_counter()
        self.input = torch.zeros(in_shape, dtype=torch.int32, device=dev)

        def call(tb, st):
            if slots:
                return fn(tb, st, params, *self.input.unbind(0))
            return fn(tb, st, params, self.input)

        wt, ws = warm_state if warm_state is not None else (table, stats)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        #: Kernel launches of the eager warm-ups (real launches, kept out
        #: of ``kernels.LAUNCHES``: they serve no traffic).
        self.warmup_launches = dict.fromkeys(kernels.LAUNCHES, 0)
        with torch.cuda.stream(side), kernels.counting_into(
                self.warmup_launches):
            if sync_check:
                prev = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    call(wt, ws)
                finally:
                    torch.cuda.set_sync_debug_mode(prev)
            for _ in range(WARMUPS - int(sync_check)):
                call(wt, ws)
        torch.cuda.current_stream(dev).wait_stream(side)
        global CAPTURES
        with _CAPTURES_LOCK:
            CAPTURES += 1
        self.graph, kept = _new_graph()
        #: Kernel launches one replay holds, per wrapper.
        self.launches = dict.fromkeys(kernels.LAUNCHES, 0)
        # thread-local: another thread's CUDA calls (the dispatch and
        # sink threads' launches and event waits) must not invalidate
        # this capture
        with kernels.counting_into(self.launches), torch.cuda.graph(
                self.graph, capture_error_mode="thread_local"):
            _, _, self.out = call(table, stats)
            self.keep = fused.block_record(self.out)
        self.nodes = None
        if kept:
            self.nodes = _node_count(self.graph)
            self.graph.instantiate()
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> None:
        """Launch the graph on the current stream and count its kernels."""
        self.graph.replay()
        for name, n in self.launches.items():
            kernels.LAUNCHES[name] += n
