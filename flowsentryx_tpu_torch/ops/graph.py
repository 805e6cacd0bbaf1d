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
* **No garbage collection inside a capture.**  The cyclic collector is
  off while a graph is captured: a finalizer it would run on the
  capturing thread (an earlier engine's graph or buffers) makes CUDA
  calls that invalidate the capture.

Each graph keeps its own memory pool.  Where torch can keep the graph
before instantiating it (``CUDAGraph(keep_graph=True)``), its nodes are
read with libcuda (:attr:`StepGraph.census`: kernels, memcpy nodes by
direction, memsets, host nodes; :attr:`StepGraph.nodes` their count,
else None): a launch costs in proportion to the count, and ``fsx audit``
holds the census to the step's transfer and in-place contracts.
"""

from __future__ import annotations

import ctypes
import gc
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


class _Memcpy3D(ctypes.Structure):
    """``CUDA_MEMCPY3D`` (libcuda's memcpy node parameters)."""

    _fields_ = [
        ("srcXInBytes", ctypes.c_size_t), ("srcY", ctypes.c_size_t),
        ("srcZ", ctypes.c_size_t), ("srcLOD", ctypes.c_size_t),
        ("srcMemoryType", ctypes.c_int), ("srcHost", ctypes.c_void_p),
        ("srcDevice", ctypes.c_uint64), ("srcArray", ctypes.c_void_p),
        ("reserved0", ctypes.c_void_p), ("srcPitch", ctypes.c_size_t),
        ("srcHeight", ctypes.c_size_t),
        ("dstXInBytes", ctypes.c_size_t), ("dstY", ctypes.c_size_t),
        ("dstZ", ctypes.c_size_t), ("dstLOD", ctypes.c_size_t),
        ("dstMemoryType", ctypes.c_int), ("dstHost", ctypes.c_void_p),
        ("dstDevice", ctypes.c_uint64), ("dstArray", ctypes.c_void_p),
        ("reserved1", ctypes.c_void_p), ("dstPitch", ctypes.c_size_t),
        ("dstHeight", ctypes.c_size_t),
        ("WidthInBytes", ctypes.c_size_t), ("Height", ctypes.c_size_t),
        ("Depth", ctypes.c_size_t),
    ]


class _MemsetParams(ctypes.Structure):
    """``CUDA_MEMSET_NODE_PARAMS``."""

    _fields_ = [("dst", ctypes.c_uint64), ("pitch", ctypes.c_size_t),
                ("value", ctypes.c_uint), ("elementSize", ctypes.c_uint),
                ("width", ctypes.c_size_t), ("height", ctypes.c_size_t)]


#: ``CUgraphNodeType`` values the census names.
_KERNEL, _MEMCPY, _MEMSET, _HOST = 0, 1, 2, 3
#: ``CUmemorytype``: host, device, array, unified.
_MEM_HOST, _MEM_DEVICE, _MEM_UNIFIED = 1, 2, 4
_PTR_MEMORY_TYPE = 2   # CU_POINTER_ATTRIBUTE_MEMORY_TYPE


def _mem_end(cu, kind: int, host_ptr, dev_ptr: int) -> str:
    """``"h"`` or ``"d"``: which memory one end of a memcpy node is."""
    if kind == _MEM_DEVICE:
        return "d"
    if kind == _MEM_HOST:
        return "h"
    ptr = dev_ptr or (host_ptr or 0)
    t = ctypes.c_uint(0)
    rc = cu.cuPointerGetAttribute(ctypes.byref(t), _PTR_MEMORY_TYPE,
                                  ctypes.c_uint64(ptr))
    return "d" if rc == 0 and t.value == _MEM_DEVICE else "h"


def graph_census(graph: torch.cuda.CUDAGraph) -> dict | None:
    """Nodes of a kept, not yet instantiated graph by kind, read with
    libcuda (``cuGraphGetNodes``, ``cuGraphNodeGetType``,
    ``cuGraphMemcpyNodeGetParams``, ``cuGraphMemsetNodeGetParams``):
    ``nodes``, ``kernel``, ``memcpy_<src>2<dst>`` (``h``/``d``),
    ``memset``, ``host``, ``other``, and the largest memcpy and memset
    in bytes.  None where it cannot be read."""
    try:
        raw = ctypes.c_void_p(int(graph.raw_cuda_graph()))
        cu = ctypes.CDLL("libcuda.so.1")
        n = ctypes.c_size_t(0)
        if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
            return None
        nodes = (ctypes.c_void_p * n.value)()
        if n.value and cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
            return None
    except (AttributeError, OSError, RuntimeError, TypeError):
        return None
    out = {"nodes": int(n.value), "kernel": 0, "memset": 0, "host": 0,
           "other": 0, "max_memcpy_bytes": 0, "max_memset_bytes": 0}
    for node in nodes:
        kind = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value == _KERNEL:
            out["kernel"] += 1
        elif kind.value == _MEMCPY:
            p = _Memcpy3D()
            cu.cuGraphMemcpyNodeGetParams(ctypes.c_void_p(node),
                                          ctypes.byref(p))
            key = (f"memcpy_{_mem_end(cu, p.srcMemoryType, p.srcHost, p.srcDevice)}"
                   f"2{_mem_end(cu, p.dstMemoryType, p.dstHost, p.dstDevice)}")
            out[key] = out.get(key, 0) + 1
            nbytes = p.WidthInBytes * max(p.Height, 1) * max(p.Depth, 1)
            out["max_memcpy_bytes"] = max(out["max_memcpy_bytes"], nbytes)
        elif kind.value == _MEMSET:
            p = _MemsetParams()
            cu.cuGraphMemsetNodeGetParams(ctypes.c_void_p(node),
                                          ctypes.byref(p))
            nbytes = p.width * max(p.height, 1) * p.elementSize
            out["memset"] += 1
            out["max_memset_bytes"] = max(out["max_memset_bytes"], nbytes)
        elif kind.value == _HOST:
            out["host"] += 1
        else:
            out["other"] += 1
    return out


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
    capture, ``nodes`` the graph's node count and ``census`` its nodes by
    kind (None where not read)."""

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
        # no cyclic collection inside the capture: a finalizer run on
        # this thread there, an earlier graph's or buffer's, makes a CUDA
        # call that invalidates it
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with kernels.counting_into(self.launches), torch.cuda.graph(
                    self.graph, capture_error_mode="thread_local"):
                _, _, self.out = call(table, stats)
                self.keep = fused.block_record(self.out)
        finally:
            if gc_on:
                gc.enable()
        #: The kept graph's :func:`graph_census` (None where not read).
        self.census = graph_census(self.graph) if kept else None
        self.nodes = None if self.census is None else self.census["nodes"]
        if kept:
            self.graph.instantiate()
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> None:
        """Launch the graph on the current stream and count its kernels."""
        self.graph.replay()
        for name, n in self.launches.items():
            kernels.LAUNCHES[name] += n
