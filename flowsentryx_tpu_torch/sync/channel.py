"""The dispatch -> sink hand-off, as one small class.

Counterpart of ``flowsentryx_tpu/sync/channel.py``.
:class:`SinkChannel` is the condition-variable-guarded pipe between the
engine's dispatch thread and its sink thread: the queue, the count of
dispatched-but-unsunk BATCHES that the ``readback_depth`` backpressure
waits on, the stop flag and the crash slot.

The one crash path: a worker records its death through
:meth:`SinkChannel.complete`'s ``exc`` (or :meth:`record_exc` for a
failure outside any group), and the exception lands atomically with
the pending count, so a waiter woken by that notify can never see the
pipe drained and no crash for work that crashed.  The dispatch side
raises it through :meth:`check` as a :class:`WorkerCrash` naming the
worker; a strict ingest fleet's dead worker surfaces the same way.

Standard library only (the ingest fleet imports :class:`WorkerCrash`).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable

from flowsentryx_tpu_torch.sync import tuning


class WorkerCrash(RuntimeError):
    """A pipeline worker died; raised on the DISPATCH thread so the
    engine fails loudly instead of serving on with verdicts silently
    discarded."""


class SinkChannel:
    """Bounded hand-off queue with crash-coupled accounting.

    ``_q`` and ``_stop`` are touched only under ``cv``; ``_pending``,
    ``_exc`` and ``busy_s`` are written only under it, and the unlocked
    reads (:attr:`pending`, :meth:`crashed`) are single loads of values
    that only the holder of ``cv`` advances.  ``_pending`` counts
    batches, not entries: a group dispatch of ``g`` batches counts
    ``g``, or grouping would multiply the configured pipe depth."""

    def __init__(self, name: str = "worker"):
        self.name = name
        self.cv = threading.Condition()
        self._q: deque = deque()
        self._pending = 0
        self._stop = False
        self._exc: BaseException | None = None
        self.busy_s = 0.0

    # -- dispatch side --------------------------------------------------------

    def submit(self, item: Any, n_chunks: int) -> None:
        """Enqueue one item; ``_pending`` rises at submit, so the
        backpressure bound covers queued-but-unsunk work too."""
        with self.cv:
            self._q.append(item)
            self._pending += n_chunks
            self.cv.notify_all()

    def submit_many(self, items: list,
                    n_chunks: Callable[[Any], int]) -> None:
        """Enqueue several items under one lock acquisition."""
        if not items:
            return
        with self.cv:
            for it in items:
                self._q.append(it)
                self._pending += n_chunks(it)
            self.cv.notify_all()

    def wait_below(self, down_to: int,
                   quantum: float = tuning.BACKPRESSURE_WAIT_S,
                   on_wait: Callable[[], None] | None = None) -> None:
        """Block until at most ``down_to`` batches are pending or the
        worker crashed; :meth:`check` after this raises the crash.
        ``on_wait`` runs once per wake-up while still over depth (the
        engine's watchdog: a wedged but live worker records no crash);
        it may raise."""
        with self.cv:
            while self._pending > down_to and self._exc is None:
                self.cv.wait(quantum)
                if on_wait is not None:
                    on_wait()

    @property
    def pending(self) -> int:
        """Submitted-but-uncompleted batches."""
        return self._pending

    def crashed(self) -> BaseException | None:
        """The recorded worker exception, if any."""
        return self._exc

    def check(self) -> None:
        """Raise a recorded worker crash on the dispatch side."""
        exc = self._exc
        if exc is not None:
            raise WorkerCrash(
                f"engine {self.name} crashed: "
                f"{type(exc).__name__}: {exc}") from exc

    def request_stop(self) -> None:
        """Ask the worker to drain the queue and exit."""
        with self.cv:
            self._stop = True
            self.cv.notify_all()

    def reset(self) -> None:
        """Re-arm for a new worker; only while no worker is alive.  The
        queue and pending count are cleared: a crashed run's unsunk
        groups must not be sunk into the next run."""
        with self.cv:
            self._q.clear()
            self._pending = 0
            self._stop = False
            self._exc = None
            self.busy_s = 0.0

    # -- worker side ----------------------------------------------------------

    def try_pop(self, coalesce: Callable[[Any], bool] | None = None
                ) -> list | None:
        """Non-blocking pop of the oldest item, plus every following item
        ``coalesce`` accepts; None when the queue is empty."""
        with self.cv:
            if not self._q:
                return None
            group = [self._q.popleft()]
            if coalesce is not None:
                while self._q and coalesce(self._q[0]):
                    group.append(self._q.popleft())
            return group

    def pop(self, coalesce: Callable[[Any], bool] | None = None,
            quantum: float = tuning.POP_WAIT_S) -> list | None:
        """Blocking pop: wait for work, or None once stop was requested
        and the queue is drained (queued work always completes)."""
        with self.cv:
            while not self._q and not self._stop:
                self.cv.wait(quantum)
            if not self._q:
                return None
        # only this worker consumes, so the queue cannot have emptied
        return self.try_pop(coalesce)

    def complete(self, n_chunks: int, busy_s: float = 0.0,
                 exc: BaseException | None = None) -> None:
        """Account one finished group, and record its crash atomically
        with the pending decrement."""
        with self.cv:
            self.busy_s += busy_s
            self._pending -= n_chunks
            if exc is not None:
                self._exc = exc
            self.cv.notify_all()

    def record_exc(self, exc: BaseException) -> None:
        """Record a worker failure outside any group."""
        with self.cv:
            self._exc = exc
            self.cv.notify_all()

    def drained(self) -> bool:
        """True when nothing is queued."""
        with self.cv:
            return not self._q
