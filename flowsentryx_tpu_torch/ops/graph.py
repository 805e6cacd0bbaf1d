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
  code, which runs once, at capture.  The capture's counts are taken
  back and recorded as :attr:`StepGraph.launches`; each :meth:`replay`
  adds them again.

Each graph keeps its own memory pool.
"""

from __future__ import annotations

from typing import Callable

import torch

from flowsentryx_tpu_torch.ops import fused, kernels

#: Warm-up runs of the eager function before a capture.
WARMUPS = 3

#: Graphs captured in this process (a swap or a restore must add none).
CAPTURES = 0


class StepGraph:
    """One captured ``fn(table, stats, params, raw) -> (table, stats,
    out)`` over a static ``[*in_shape]`` int32 input on the card.

    ``out`` is the step's :class:`~.fused.StepOutput` of static tensors;
    ``keep`` is :func:`~.fused.block_record` of it (block arrays and
    clock as one flat buffer, so one copy per dispatch preserves them).
    A failed capture raises; there is no eager fallback."""

    def __init__(self, fn: Callable, table, stats, params,
                 in_shape: tuple[int, ...]):
        dev = table.key_rows.device
        if dev.type != "cuda":
            raise ValueError(f"StepGraph: CUDA graphs need a CUDA table, "
                             f"got {dev}")
        self.input = torch.zeros(in_shape, dtype=torch.int32, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn(table, stats, params, self.input)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
            for _ in range(WARMUPS - 1):
                fn(table, stats, params, self.input)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = dict(kernels.LAUNCHES)
        global CAPTURES
        CAPTURES += 1
        self.graph = torch.cuda.CUDAGraph()
        try:
            # thread-local: another thread's CUDA calls (another
            # engine's sink thread waiting on its events) must not
            # invalidate this capture
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                _, _, self.out = fn(table, stats, params, self.input)
                self.keep = fused.block_record(self.out)
        finally:
            #: Kernel launches one replay holds, per wrapper.
            self.launches = {k: kernels.LAUNCHES[k] - before[k]
                             for k in before}
            kernels.LAUNCHES.update(before)

    def replay(self) -> None:
        """Launch the graph on the current stream and count its kernels."""
        self.graph.replay()
        for name, n in self.launches.items():
            kernels.LAUNCHES[name] += n
