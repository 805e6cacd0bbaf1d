"""Fault injectors: the campaign's registry of ways to hurt the stack.

Counterpart of ``flowsentryx_tpu/chaos/faults.py``.  Each injector
mutates REAL state — files on disk, sealed shm slots, process lifetimes
— through exactly the surface a real fault would use, so the code under
test cannot tell a campaign from an incident.  All randomness flows
through the caller's seeded ``numpy.random.Generator``: same seed, same
campaign, bit for bit, and the same offsets, bytes and stamps as the
reference's injectors draw from that seed.

The registry (:data:`FAULTS`) is documentation-as-data and holds all of
the reference's entries: ``fsx chaos --list`` prints it, and the
campaign artifact names each scenario's ``fault`` from it.  The network
faults hurt a :class:`~..cluster.transport.NetMailbox` at its raw send
seam (:class:`NetChaos`) or forge a peer's lying epoch
(:func:`stale_epoch_packets`).

This module imports numpy only, so ``fsx chaos --list`` imports no
torch: the slot-header words come from :mod:`..core.wire`.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np

from flowsentryx_tpu_torch.core import wire

#: fault name -> (fault class, one-line description)
FAULTS: dict[str, tuple[str, str]] = {
    "engine_kill": (
        "process-kill",
        "SIGKILL one supervised rank's process group mid-serve at a "
        "seed-scheduled point; the supervisor must respawn it from its "
        "checkpoint while survivors keep serving"),
    "crash_loop": (
        "process-crash-loop",
        "a rank that dies instantly every generation; the crash-loop "
        "discipline must back off and park it as failed within its "
        "sliding-window budget"),
    "ckpt_bitflip": (
        "storage-corruption",
        "flip seed-chosen bytes of the live checkpoint; load must "
        "refuse (CRC or structural) and restore must fall back to the "
        "retained .prev generation"),
    "ckpt_truncate": (
        "storage-truncation",
        "truncate the checkpoint at a seed-chosen fraction (incl. to "
        "0 bytes — the torn-at-create case); pre-boot validation must "
        "raise the named error, never a raw struct/IndexError"),
    "shm_bad_magic": (
        "shm-slot-corruption",
        "overwrite a sealed slot's wire-id word (the per-slot magic); "
        "the dequeue path must count + skip it without killing the "
        "drain"),
    "shm_seq_gap": (
        "shm-slot-corruption",
        "bump a sealed slot's sequence words; the gap must surface in "
        "the seq-gap counters, never as silent reordering"),
    "poison_batch": (
        "poisoned-batch",
        "rewrite a sealed slot's metadata out of the declared RANGE_* "
        "contracts (n_records > max_batch); the batch must be "
        "quarantined — counted + spooled — never dispatched"),
    "gossip_stall_flood": (
        "gossip-plane",
        "flood a pair mailbox past its slot count while the peer's "
        "merge tick is stalled; drops must be counted, the publisher "
        "must never block, delivered wires must still converge"),
    "clock_jump": (
        "time-fault",
        "feed the latency plane stamps from a monotonic clock that "
        "jumped backwards; negatives must be counted and percentiles "
        "stay finite"),
    "sink_wedge": (
        "pipeline-wedge",
        "wedge the verdict sink forever with batches in flight; the "
        "dispatch watchdog must dump stacks and fail the drain loudly "
        "within 2x its stall bound"),
    # -- network faults (the multi-host gossip leg) -------------------------
    "net_partition": (
        "network-partition",
        "drop every datagram between two gossip hosts mid-publish; "
        "the publisher must never block (fail-open), everything "
        "delivered BEFORE the cut must stay converged, and nothing "
        "may cascade"),
    "net_heal": (
        "network-partition",
        "heal a partition after verdicts were published into it; the "
        "anti-entropy resync must re-converge the canonical blacklist "
        "digests within a bounded number of gossip ticks"),
    "net_reorder": (
        "network-reorder",
        "deliver a peer's wire datagrams out of order; the bounded "
        "reorder buffer must restore per-peer sequence order without "
        "ever exceeding its window (evict-and-count past it, never "
        "stall, never grow)"),
    "net_duplicate": (
        "network-duplication",
        "deliver every wire datagram twice; duplicate suppression "
        "must count (rx_dup) and drop the copies — a verdict is never "
        "applied twice"),
    "net_loss_burst": (
        "network-loss",
        "silently drop a contiguous burst of wire datagrams; the "
        "sequence holes must be conceded and counted (rx_gap), the "
        "survivors delivered, and the resync must close the hole"),
    "net_stale_epoch": (
        "network-epoch",
        "a peer publishing wires under a lying epoch stamp (pre-"
        "reboot t0_wall); the rebased skew bound (RANGE_EPOCH_SKEW_S) "
        "must refuse-and-count them — a broken clock must never "
        "blacklist anyone at the wrong time"),
    # -- elastic-fleet faults (live shard rebalancing) ----------------------
    "handoff_kill_midship": (
        "rebalance-interrupt",
        "SIGKILL the donor mid-stream while it ships a shard span "
        "over the handoff mailbox; the recipient must refuse the "
        "unsealed stream (no STAGED ack, nothing inserted) and the "
        "donor's copy must still account every row exactly — the "
        "exact-conservation invariant at the worst interruption "
        "point"),
    "layout_flip_lost": (
        "rebalance-flip",
        "one rank never observes the committed layout generation "
        "(its flip 'message' lost); the handoff fence must NOT lift "
        "until every active rank acks the new generation — a "
        "partially-flipped fleet never serves a split route"),
    "adopt_half_dead": (
        "supervisor-adopt",
        "a replacement supervisor re-attaches (boot(adopt=True)) to "
        "a plane whose ranks are half dead; the adopt census must "
        "classify live/dead correctly, respawn ONLY the dead rank "
        "from its checkpoint, and never attach a second consumer to "
        "a span a live rank still drains"),
}


# -- file-level corruption ---------------------------------------------------

def flip_bytes(path: str | Path, rng: np.random.Generator,
               n_flips: int = 8) -> list[int]:
    """XOR-flip ``n_flips`` seed-chosen bytes in place (skipping the
    first 4 — a broken zip signature would only exercise the cheap
    structural refusal; deeper flips also exercise the CRC leg).
    Returns the offsets, for the artifact."""
    data = bytearray(Path(path).read_bytes())
    if len(data) <= 8:
        raise ValueError(f"{path}: too small to corrupt meaningfully")
    offs = sorted(int(o) for o in rng.integers(4, len(data), n_flips))
    for o in offs:
        data[o] ^= 0xFF
    Path(path).write_bytes(bytes(data))
    return offs


def truncate_file(path: str | Path, frac: float) -> int:
    """Truncate to ``frac`` of the current size (0.0 = the zero-byte
    torn-at-create file).  Returns the new size."""
    p = Path(path)
    new = int(p.stat().st_size * frac)
    with open(p, "r+b") as f:
        f.truncate(new)
    return new


# -- sealed-slot corruption (engine/shm.py SealedBatchQueue) -----------------

def _wait_readable(queue, n: int, timeout_s: float = 20.0) -> None:
    deadline = time.monotonic() + timeout_s
    while queue.readable() < n:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"queue never reached {n} sealed slot(s) "
                f"(readable={queue.readable()})")
        time.sleep(0.005)


def corrupt_sealed_slot(queue, kind: str, slot_back: int = 0,
                        seq_bump: int = 5) -> dict:
    """Mutate the header of a SEALED-but-unconsumed slot in place —
    the exact window a cosmic ray / torn writer corrupts in
    production.  SPSC-safe by construction: the producer only writes
    unsealed slots, the consumer has not reached this one yet, and the
    caller guarantees no concurrent dequeue (the campaign corrupts
    BEFORE handing the queue to the drain).

    ``kind``: ``bad_magic`` (wire-id word) or ``seq_gap`` (sequence
    words jump forward by ``seq_bump``); the well-formed-but-poisoned
    variant is :func:`poison_sealed_meta`.  Returns what was done,
    for the artifact."""
    _wait_readable(queue, slot_back + 1)
    t = int(queue._tail[0])
    cell = queue._cells[(t + slot_back) & (queue.slots - 1)]
    info: dict = {"kind": kind, "slot": slot_back}
    if kind == "bad_magic":
        info["was"] = int(cell[wire.BATCHQ_WIRE_ID_WORD])
        cell[wire.BATCHQ_WIRE_ID_WORD] = 0xDEAD
    elif kind == "seq_gap":
        seq = (int(cell[wire.BATCHQ_SEQ_LO_WORD])
               | (int(cell[wire.BATCHQ_SEQ_HI_WORD]) << 32))
        seq += seq_bump
        info["seq"] = seq
        cell[wire.BATCHQ_SEQ_LO_WORD] = seq & 0xFFFFFFFF
        cell[wire.BATCHQ_SEQ_HI_WORD] = (seq >> 32) & 0xFFFFFFFF
    else:
        raise ValueError(f"unknown slot-corruption kind {kind!r}")
    return info


def poison_sealed_meta(queue, words_per_record: int, max_batch: int,
                       slot_back: int = 0) -> dict:
    """Poison a sealed slot into a WELL-FORMED header whose metadata
    row violates the RANGE_* encoder contracts: both the header
    n_records and the metadata-row n are driven past ``max_batch``
    coherently (so the tear check passes and the range-contract check
    is what must catch it)."""
    _wait_readable(queue, slot_back + 1)
    t = int(queue._tail[0])
    cell = queue._cells[(t + slot_back) & (queue.slots - 1)]
    bad_n = max_batch + 7
    was = int(cell[wire.BATCHQ_N_RECORDS_WORD])
    cell[wire.BATCHQ_N_RECORDS_WORD] = bad_n
    meta_off = wire.BATCHQ_SLOT_HDR_WORDS + max_batch * words_per_record
    cell[meta_off] = bad_n
    return {"kind": "poison_n", "slot": slot_back, "was": was,
            "bad_n": bad_n}


# -- process faults ----------------------------------------------------------

def pick_kill_delay_s(rng: np.random.Generator,
                      lo: float = 0.05, hi: float = 0.25) -> float:
    """Seed-scheduled kill point for the supervisor's chaos hook."""
    return float(lo + (hi - lo) * rng.random())


# -- pipeline wedge ----------------------------------------------------------

class WedgeSink:
    """A verdict sink that wedges forever (until released) on its
    N-th apply — the stall the dispatch watchdog exists for.  ``apply``
    blocks on an Event, exactly like a sink stuck on a dead downstream
    transport; ``release()`` un-wedges so test teardown can drain the
    abandoned worker."""

    def __init__(self, wedge_after: int = 0):
        import threading

        self.wedge_after = wedge_after
        self.applies = 0
        self._evt = threading.Event()

    def apply(self, update) -> None:
        self.applies += 1
        if self.applies > self.wedge_after:
            self._evt.wait()  # wedged: no timeout by design

    def release(self) -> None:
        self._evt.set()


# -- clock faults ------------------------------------------------------------

def jumped_stamps(rng: np.random.Generator, n: int,
                  jump_s: float = 0.05) -> list[float]:
    """A monotone stamp series with one seed-placed BACKWARD jump —
    what a latency plane sees when a slot's seal stamp post-dates the
    sink's clock read (VM migration, NTP slew on a non-monotonic
    source, or plain header corruption)."""
    stamps = np.cumsum(rng.random(n) * 1e-3)
    k = int(rng.integers(1, n))
    stamps[k:] -= jump_s
    return [float(s) for s in stamps]


# -- network faults (cluster/transport.py NetMailbox) ------------------------

class NetChaos:
    """Deterministic network-fault injector for one
    :class:`~flowsentryx_tpu_torch.cluster.transport.NetMailbox`.

    It wraps the mailbox's raw ``_sendto`` seam, the one point every
    datagram leaves through, so the code under test runs its real send
    path and the fault happens where a network would inflict it: after a
    successful send.  A dropped packet returns True to the sender (loss
    in flight is invisible to a UDP publisher), unlike the mailbox's own
    ``tx_sock_drops``, which count local send failures.

    Modes (one at a time, installed by the scenario):

    * :meth:`partition` — drop everything until :meth:`heal`.
    * :meth:`duplicate` — deliver every packet twice.
    * :meth:`reorder` — hold ``depth`` packets, send them reversed.
    * :meth:`drop_burst` — drop sends ``[start, start+n)`` silently
      (0-indexed over this injector's sends).
    """

    def __init__(self, mbx):
        self.mbx = mbx
        self._real = mbx._sendto
        mbx._sendto = self._send
        self.mode = None
        self._depth = 0
        self._held: list[tuple[bytes, tuple]] = []
        self._burst: tuple[int, int] | None = None
        self.sent = 0
        self.dropped = 0
        self.duplicated = 0
        self.reordered = 0

    # -- mode selection -------------------------------------------------------

    def partition(self) -> None:
        self.mode = "drop"

    def heal(self) -> None:
        self.mode = None
        self._flush()

    def duplicate(self) -> None:
        self.mode = "dup"

    def reorder(self, depth: int = 4) -> None:
        self.mode = "reorder"
        self._depth = depth

    def drop_burst(self, start: int, n: int) -> None:
        self.mode = "burst"
        self._burst = (start, start + n)

    def uninstall(self) -> None:
        self._flush()
        self.mbx._sendto = self._real

    # -- the injected seam ----------------------------------------------------

    def _flush(self) -> None:
        held, self._held = self._held, []
        for payload, addr in held:
            self._real(payload, addr)

    def _send(self, payload: bytes, addr: tuple) -> bool:
        i = self.sent
        self.sent += 1
        if self.mode == "drop":
            self.dropped += 1
            return True  # the network ate it after a successful send
        if self.mode == "burst" and self._burst[0] <= i < self._burst[1]:
            self.dropped += 1
            return True
        if self.mode == "dup":
            self.duplicated += 1
            self._real(payload, addr)
            return self._real(payload, addr)
        if self.mode == "reorder":
            self._held.append((payload, addr))
            if len(self._held) >= self._depth:
                self.reordered += len(self._held)
                held, self._held = self._held, []
                for p, a in reversed(held):
                    self._real(p, a)
            return True
        return self._real(payload, addr)


def stale_epoch_packets(host: int, rank: int, t0_wall_ns: int,
                        skew_s: float, keys, untils,
                        k_max: int = 8,
                        start_seq: int = 1) -> list[bytes]:
    """Wire datagrams from a peer whose epoch stamp LIES by ``skew_s``
    seconds (a pre-reboot ``t0_wall``, a host without clock discipline):
    the fault ``RANGE_EPOCH_SKEW_S`` exists for.  The wire body is well
    formed; only the epoch is wrong."""
    from flowsentryx_tpu_torch.cluster import transport

    bogus_wall = t0_wall_ns - int(skew_s * 1e9)
    pkts = []
    keys = np.asarray(keys, np.uint32)
    untils = np.asarray(untils, np.float32)
    for j, lo in enumerate(range(0, len(keys), k_max)):
        ck, cu = keys[lo:lo + k_max], untils[lo:lo + k_max]
        w = np.zeros(2 * k_max + 4, np.uint32)
        w[:len(ck)] = ck
        w[k_max:k_max + len(cu)] = cu.view(np.uint32)
        w[2 * k_max] = len(ck)
        w[2 * k_max + 3] = np.float32(0.0).view(np.uint32)
        pkts.append(transport.pack_packet(
            wire.NET_KIND_WIRE, host, rank, start_seq + j, len(ck),
            bogus_wall, w))
    return pkts


def kill_process_group(pid: int) -> None:
    """SIGKILL a process group — the supervisor chaos hook's raw form
    for scenarios that bypass :meth:`ClusterSupervisor.kill`."""
    import signal

    try:
        os.killpg(pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        pass
