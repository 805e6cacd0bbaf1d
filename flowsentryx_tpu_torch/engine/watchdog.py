"""No-progress watchdog of the dispatch pipeline.

Counterpart of ``flowsentryx_tpu/engine/watchdog.py``, copied.  The
failure it exists for: batches are in flight (dispatched but unsunk)
and nothing completes, so a drain would hang with no diagnostic.  Two
stages, so that a throttled but live pipe is not killed:

* **soft trip** — one full ``stall_s`` with work in flight and no
  completion dumps every thread's stack to stderr and counts ``trips``
  (a DEGRADED reason of ``EngineReport.health`` if the pipe recovers);
* **hard trip** — a second full ``stall_s`` still without progress
  raises :class:`WatchdogStall` on the dispatch thread: the drain fails
  loudly instead of hanging a ``run()`` forever.

``note_progress`` runs in the sink section and stores one float;
``check`` runs on the dispatch thread (between the polls of every wait
on a CUDA event or on the sink thread).  It never changes results.
Standard library only.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback


class WatchdogStall(RuntimeError):
    """The dispatch pipeline made no progress for two full stall
    bounds with work in flight; per-thread stacks were dumped to
    stderr at both trips."""


def dump_thread_stacks(file=None, reason: str = "") -> None:
    """Write every live thread's current stack to ``file`` (stderr
    default) — the automated debugger-attach a hung drain needs,
    usable from any thread."""
    file = file if file is not None else sys.stderr
    frames = sys._current_frames()
    print(f"fsx watchdog: per-thread stacks ({reason})", file=file)
    for t in threading.enumerate():
        frame = frames.get(t.ident)
        print(f"--- thread {t.name!r} (daemon={t.daemon}, "
              f"alive={t.is_alive()}) ---", file=file)
        if frame is not None:
            traceback.print_stack(frame, file=file)
        else:
            print("  <no frame: exiting or not yet started>", file=file)
    file.flush()


class DispatchWatchdog:
    """Module-docstring detector.  ``stall_s == 0`` disables (every
    call becomes a no-op compare — null-path cost is one branch)."""

    def __init__(self, stall_s: float, name: str = "dispatch pipeline"):
        if stall_s < 0:
            raise ValueError(f"stall_s must be >= 0, got {stall_s}")
        self.stall_s = float(stall_s)
        self.name = name
        #: Soft trips (stacks dumped, pipe later recovered) — a
        #: DEGRADED reason in the health ladder.
        self.trips = 0
        #: The hard trip fired (WatchdogStall raised): the engine is
        #: failing loudly; shutdown must not wait unbounded on the
        #: wedged worker (``Engine._stop_sink_thread`` honours this).
        self.tripped = False
        self._last_progress = time.monotonic()
        self._soft_at: float | None = None

    # -- sink/launch side (single owner at a time; one float store) ----------

    def note_progress(self) -> None:
        """A batch group completed (sunk): re-arm the stall clock."""
        self._last_progress = time.monotonic()
        self._soft_at = None

    # -- dispatch side -------------------------------------------------------

    def check(self, busy: int) -> None:
        """Dispatch-loop poll: with ``busy`` batches in flight and no
        completion for ``stall_s``, soft-trip (dump stacks, count);
        for a further ``stall_s``, hard-trip (raise).  An idle pipe
        re-arms the clock — waiting on a quiet source is not a stall."""
        if not self.stall_s:
            return
        now = time.monotonic()
        if busy <= 0:
            self._last_progress = now
            self._soft_at = None
            return
        if now - self._last_progress < self.stall_s:
            return
        if self._soft_at is None:
            self._soft_at = now
            self.trips += 1
            dump_thread_stacks(
                reason=f"{self.name}: {busy} batch(es) in flight, no "
                       f"completion for {now - self._last_progress:.1f}s "
                       f"(stall bound {self.stall_s:.1f}s) — soft trip "
                       f"#{self.trips}; hard trip in {self.stall_s:.1f}s "
                       "unless the pipe recovers")
            return
        if now - self._soft_at >= self.stall_s:
            self.tripped = True
            dump_thread_stacks(
                reason=f"{self.name}: still no progress "
                       f"{now - self._last_progress:.1f}s after the soft "
                       "trip — hard trip, failing the drain loudly")
            raise WatchdogStall(
                f"{self.name} watchdog: {busy} batch(es) in flight and "
                f"no completion for {now - self._last_progress:.1f}s "
                f"(2x the {self.stall_s:.1f}s stall bound); per-thread "
                "stacks were dumped to stderr — refusing to hang the "
                "drain forever")

    def to_dict(self) -> dict:
        return {"stall_s": self.stall_s, "soft_trips": self.trips,
                "hard_tripped": self.tripped}
