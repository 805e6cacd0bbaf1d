"""Live shard rebalancing: the shard assignment, the handoff mailbox, the
fences.

Counterpart of ``flowsentryx_tpu/cluster/rebalance.py``; every file it
writes (``layout.json``, ``handoff.json``, the handoff mailbox, the
staged spool) has the reference's bytes for the same calls, so a port
rank and a reference rank can share one plane.  Shard ownership is a
VERSIONED, migratable assignment: the fleet reshapes itself one shard
span at a time while the survivors keep serving.

numpy, mmap and sockets only: the supervisor imports this module, and
never torch.  The engine-side hooks run between run chunks, where the
engine has nothing in flight.

* :class:`ShardAssignment` — ``ring shard -> owning rank`` under a
  monotonically increasing **layout generation**, published as
  ``layout.json`` (atomic and durable, written by the supervisor only).
  Producers route a record to its owner's ring
  (:func:`assigned_ring_of`); engines judge a table row's owner with the
  same map (:func:`owner_rank_of_keys`).
* :class:`HandoffMailbox` — an SPSC shm queue of packed table rows on
  the gossip mailbox's geometry, sealed by a count + CRC trailer slot,
  so a short or torn stream is refused, never staged.
  :class:`NetHandoff` is its UDP twin (per-slot seq, duplicate
  suppression, cumulative acks, retransmit), proved on loopback.
* :class:`EngineRebalancer` — the engine's half of the handoff state
  machine, stepped between run chunks.  The supervisor's half is in
  ``supervisor.py``.

The handoff::

    supervisor                donor                    recipient
    ----------                -----                    ---------
    write handoff.json
    create mailbox
    stamp c_fence=id   -->    (serve >= 1 more chunk:
      on both parties          the sealed tail drains)
                              extract span rows
                              ship slots + SEAL
                              ack HP_SHIPPED   -->
                                                       drain mailbox
                                                       verify count+CRC
                                                       SPOOL staged .npz
                                                <--    ack HP_STAGED
    write layout.json (gen+1, atomic)
    stamp c_layout_gen=gen+1  -->
                              drop span rows           insert staged rows
                              ack HP_DROPPED           ack HP_INSERTED
                              c_layout_ack=gen+1       c_layout_ack=gen+1
    every live ack == gen+1:
    clear fences, delete handoff.json and the mailbox
    (the spool outlives the handoff until the recipient's next
     checkpoint covers the rows: :meth:`EngineRebalancer.note_checkpointed`)

Exact row conservation at every interruption: a death before the flip
aborts (nothing moved, the donor still owns the span); a donor death
after it is repaired by the donor's boot-time :meth:`~EngineRebalancer
.reconcile` (it drops the rows it no longer owns); a recipient death
after it by the spool, written before ``HP_STAGED`` and adopted at the
next boot (re-adoption is idempotent: duplicate keys drop).

While ``c_fence`` names a handoff, producers hold back new records of
the moving shards, so the span's rows do not change between extract and
flip; the donor keeps serving its other shards meanwhile, except while
it ships (a full mailbox blocks it until the recipient drains).

Every durable file goes through :mod:`..core.durable`'s filesystem seam
and every handoff mailbox through :func:`mailbox_cls`, so ``fsx crash``
(:mod:`flowsentryx_tpu_torch.crash`) runs this module's real protocol
over a simulated filesystem and mailbox.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import mmap
import os
import socket
import time
import zipfile
import zlib
from pathlib import Path

import numpy as np

from flowsentryx_tpu_torch.core import durable, wire
from flowsentryx_tpu_torch.engine.shm import RingNotReady, _require_tso
from flowsentryx_tpu_torch.sync import tuning

#: One packed table row on the handoff wire: the key word and the f32
#: state columns bit-cast to u32 (a byte-exact round trip).
ROW_WORDS = 1 + wire.NUM_TABLE_COLS


# -- paths (the naming contract between supervisor and engines) -------------

def layout_path(cluster_dir: str | Path) -> Path:
    return Path(cluster_dir) / "layout.json"


def handoff_json_path(cluster_dir: str | Path) -> Path:
    """The active handoff's descriptor (one handoff at a time,
    fleet-wide)."""
    return Path(cluster_dir) / "handoff.json"


def handoff_mailbox_path(cluster_dir: str | Path, handoff_id: int) -> str:
    return str(Path(cluster_dir) / f"handoff_{handoff_id}.mbx")


def staged_path(cluster_dir: str | Path, rank: int) -> Path:
    """The recipient's staging spool, written before ``HP_STAGED`` is
    acked, so a recipient killed after the flip still inserts the rows
    at its next boot."""
    return Path(cluster_dir) / f"handoff_staged_r{rank}.npz"


def _write_atomic(path: Path, data: str | bytes) -> None:
    """Publish a durable state file (``layout.json``, ``handoff.json``,
    the spool): written, fsynced, renamed and the directory fsynced, so
    it survives power loss once this returns."""
    durable.atomic_write(path, data.encode() if isinstance(data, str)
                         else data)


#: ``np.load`` errors that mean "this spool is damaged".
_SPOOL_DAMAGE = (OSError, EOFError, zipfile.BadZipFile, zlib.error,
                 KeyError, IndexError, ValueError)


def save_spool(path: Path, keys, states, *, handoff_id: int,
               to_gen: int) -> None:
    """Publish the recipient's staged spool atomically and durably.  It
    must be on disk, fsync included, before ``HP_STAGED`` is acked: the
    supervisor commits the flip on that ack, and a recipient that dies
    after the flip recovers the rows from this file."""
    buf = io.BytesIO()
    np.savez_compressed(buf, keys=np.asarray(keys, np.uint32),
                        states=np.asarray(states, np.float32),
                        handoff_id=np.uint64(handoff_id),
                        to_gen=np.uint64(to_gen))
    _write_atomic(path, buf.getvalue())


def load_spool(path: Path) -> dict | None:
    """The staged spool's contents, ``None`` when absent; a torn or
    corrupt file raises ``ValueError``."""
    path = Path(path)
    fs = durable.get_fs()
    if not fs.exists(path):
        return None
    try:
        with np.load(io.BytesIO(fs.read_bytes(path))) as z:
            return {"keys": np.asarray(z["keys"], np.uint32),
                    "states": np.asarray(z["states"], np.float32),
                    "handoff_id": int(z["handoff_id"]),
                    "to_gen": int(z["to_gen"])}
    except _SPOOL_DAMAGE as e:
        raise ValueError(
            f"staged spool {path} is torn or corrupt: "
            f"{type(e).__name__}: {e}") from e


def discard_uncommitted_spool(cluster_dir: str | Path,
                              rank: int) -> bool:
    """Unlink ``rank``'s staged spool only if it cannot be anyone's
    durable truth: torn, or staged for a flip that never committed
    (``to_gen`` past the committed generation).  A spool at or below the
    committed generation is the shipped rows' last durable copy until
    the recipient's next checkpoint.  True when a spool was removed."""
    spool = staged_path(cluster_dir, rank)
    fs = durable.get_fs()
    if not fs.exists(spool):
        return False
    asg = ShardAssignment.load(cluster_dir)
    gen = asg.generation if asg is not None else -1
    try:
        sp = load_spool(spool)
        if sp is not None and sp["to_gen"] <= gen:
            return False
    except ValueError:
        pass  # torn: nothing adoptable in it
    try:
        fs.unlink(spool)
    except OSError:
        return False
    return True


# -- shard assignment -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardAssignment:
    """``ring shard -> owning rank`` under one layout generation.

    ``owners[s]`` is the rank that drains shard ``s``'s records and owns
    its flows' table rows.  ``len(owners)`` is the fan-out width
    ``total_shards``, fixed for the fleet's lifetime (the ring files and
    the hash rule never change); only ownership moves."""

    generation: int
    owners: tuple[int, ...]

    def __post_init__(self):
        if self.generation < 0:
            raise ValueError("layout generation must be >= 0")
        if not self.owners:
            raise ValueError("an assignment needs >= 1 shard")

    @property
    def total_shards(self) -> int:
        return len(self.owners)

    @classmethod
    def initial(cls, total_shards: int, w: int,
                n_live: int) -> "ShardAssignment":
        """Generation 0 of a fleet provisioned at ``total_shards =
        max_engines * w`` with ``n_live`` engines booted: each live rank
        owns ``[r*w, (r+1)*w)`` and the spans of unspawned ranks fold
        onto the live ones round-robin."""
        if total_shards % w:
            raise ValueError(
                f"total_shards {total_shards} not a multiple of w {w}")
        if n_live < 1 or n_live * w > total_shards:
            raise ValueError(
                f"n_live {n_live} does not fit {total_shards} shards "
                f"at {w} per rank")
        owners = []
        for s in range(total_shards):
            r = s // w
            owners.append(r if r < n_live else r % n_live)
        return cls(generation=0, owners=tuple(owners))

    def spans_of(self, rank: int) -> tuple[int, ...]:
        return tuple(s for s, r in enumerate(self.owners) if r == rank)

    def reassign(self, shards, to_rank: int) -> "ShardAssignment":
        """The flip: ``shards`` move to ``to_rank`` under a new
        generation (a published layout never changes)."""
        shards = set(int(s) for s in shards)
        bad = [s for s in shards if not 0 <= s < self.total_shards]
        if bad:
            raise ValueError(f"shards {bad} outside "
                             f"[0, {self.total_shards})")
        owners = tuple(to_rank if s in shards else r
                       for s, r in enumerate(self.owners))
        return ShardAssignment(self.generation + 1, owners)

    def save(self, cluster_dir: str | Path) -> None:
        """Atomic publish (the supervisor is the only writer)."""
        _write_atomic(layout_path(cluster_dir), json.dumps({
            "generation": self.generation,
            "owners": list(self.owners),
        }) + "\n")

    @classmethod
    def load(cls, cluster_dir: str | Path) -> "ShardAssignment | None":
        p = layout_path(cluster_dir)
        fs = durable.get_fs()
        if not fs.exists(p):
            return None
        d = json.loads(fs.read_text(p))
        return cls(generation=int(d["generation"]),
                   owners=tuple(int(r) for r in d["owners"]))


def assigned_ring_of(shard: int, owners, w: int) -> int:
    """The ring a producer writes shard ``shard``'s records to: the
    owner's physical span (each rank drains its own ``w`` rings for
    good; ownership is what routes)."""
    return int(owners[int(shard)]) * w + int(shard) % w


def owner_rank_of_keys(keys, owners) -> np.ndarray:
    """Owning rank of each table key under an assignment (the engine's
    twin of the producers' routing: ``shard_of``, then the owners)."""
    owners = np.asarray(owners, np.int64)
    return owners[wire.shard_of(keys, len(owners)).astype(np.int64)]


# -- row packing and the conservation judge ---------------------------------

def pack_rows(keys, states) -> np.ndarray:
    """``[n, ROW_WORDS]`` u32 wire image of table rows (the key word,
    then the f32 state columns bit-cast)."""
    k = np.asarray(keys, np.uint32).reshape(-1)
    s = np.ascontiguousarray(states, np.float32).reshape(
        len(k), wire.NUM_TABLE_COLS)
    out = np.empty((len(k), ROW_WORDS), np.uint32)
    out[:, 0] = k
    out[:, 1:] = s.view(np.uint32)
    return out


def unpack_rows(packed) -> tuple[np.ndarray, np.ndarray]:
    p = np.ascontiguousarray(packed, np.uint32).reshape(-1, ROW_WORDS)
    return p[:, 0].copy(), p[:, 1:].copy().view(np.float32)


def rows_digest(keys, states) -> int:
    """CRC32 of the packed wire bytes in ship order (folded slot by slot
    on both sides, compared at SEAL)."""
    return zlib.crc32(pack_rows(keys, states).tobytes()) & 0xFFFFFFFF


def rows_conserved(pre: tuple, parts: list, *,
                   owners=None, part_ranks=None) -> dict:
    """The exact-row-conservation judge: the union of ``parts`` (each
    ``(keys, states)``) must equal the ``pre`` rows as a multiset of
    byte-exact rows, with no key in two parts; with ``owners`` and
    ``part_ranks``, every part's keys must also route to that part's
    rank."""
    def _raw(keys, states):
        p = pack_rows(keys, states)
        return p.view(np.uint8).reshape(len(p), -1)

    pre_raw = _raw(*pre)
    part_raws = [_raw(*p) for p in parts]
    post_raw = (np.concatenate(part_raws) if part_raws
                else np.empty((0, pre_raw.shape[1]), np.uint8))
    detail = []
    # a key present in two parts: two engines both claim the flow
    all_keys = np.concatenate(
        [np.asarray(p[0], np.uint32).reshape(-1) for p in parts]
    ) if parts else np.empty(0, np.uint32)
    dup = int(len(all_keys) - len(np.unique(all_keys)))
    if dup:
        detail.append(f"{dup} key(s) owned by more than one engine")
    if len(pre_raw) != len(post_raw):
        detail.append(
            f"row count {len(post_raw)} != pre-handoff {len(pre_raw)}")
    byte_equal = False
    if len(pre_raw) == len(post_raw):
        def _sorted(a):
            if not len(a):
                return a
            return a[np.lexsort(a.T[::-1])]
        byte_equal = bool(np.array_equal(_sorted(pre_raw),
                                         _sorted(post_raw)))
        if not byte_equal:
            detail.append("rows are not byte-identical to the "
                          "pre-handoff set")
    foreign = 0
    if owners is not None and part_ranks is not None:
        for (keys, _st), rank in zip(parts, part_ranks):
            keys = np.asarray(keys, np.uint32).reshape(-1)
            if len(keys):
                foreign += int(np.sum(
                    owner_rank_of_keys(keys, owners) != rank))
        if foreign:
            detail.append(f"{foreign} row(s) resident off their "
                          "assigned owner")
    ok = not dup and not foreign and byte_equal
    return {"ok": ok, "pre_rows": int(len(pre_raw)),
            "post_rows": int(len(post_raw)), "dup_keys": dup,
            "foreign_rows": foreign,
            "detail": "; ".join(detail) or "conserved"}


# -- the handoff mailbox (shm leg) ------------------------------------------

class HandoffMailbox:
    """SPSC shm queue of packed table rows, donor -> recipient: the
    gossip mailbox's 3-cache-line header and cursor protocol (one writer
    per cursor, the copy before the publish), with ``row_words`` in the
    header's 4th u64 so the two sides cannot disagree on the row
    format."""

    def __init__(self, path: str | Path):
        _require_tso()
        self.path = Path(path)
        with open(self.path, "r+b") as f:
            self._mm = mmap.mmap(f.fileno(), 0)
        hdr = np.frombuffer(self._mm, np.uint64, 4, 0)
        if int(hdr[0]) != wire.SHM_HANDOFF_MAGIC:
            raise RingNotReady(
                f"handoff mailbox magic not published yet in {self.path}")
        self.slots = int(hdr[1])
        self.slot_words = int(hdr[2]) // 4
        self.row_words = int(hdr[3])
        self.rows_per_slot = ((self.slot_words
                               - wire.HANDOFF_SLOT_HDR_WORDS)
                              // self.row_words)
        self._cells = np.frombuffer(
            self._mm, np.uint32, self.slots * self.slot_words,
            wire.SHM_HDR_SIZE,
        ).reshape(self.slots, self.slot_words)
        self._head = np.frombuffer(self._mm, np.uint64, 1,
                                   wire.SHM_HEAD_OFFSET)
        self._tail = np.frombuffer(self._mm, np.uint64, 1,
                                   wire.SHM_TAIL_OFFSET)

    @classmethod
    def create(cls, path: str | Path, slots: int = 64,
               rows_per_slot: int = 512,
               row_words: int = ROW_WORDS) -> "HandoffMailbox":
        """Create the mailbox file (the supervisor, before it stamps the
        fence, so neither side races a missing file).  Geometry first,
        magic last."""
        _require_tso()
        if slots < 2 or slots & (slots - 1):
            raise ValueError(
                f"slots must be a power of two >= 2, got {slots}")
        if rows_per_slot < 1:
            raise ValueError("rows_per_slot must be >= 1")
        slot_bytes = (wire.HANDOFF_SLOT_HDR_WORDS
                      + rows_per_slot * row_words) * 4
        nbytes = wire.SHM_HDR_SIZE + slots * slot_bytes
        path = Path(path)
        with open(path, "wb") as f:  # noqa: shm handoff mailbox (tmpfs), not durable state
            f.truncate(nbytes)
        with open(path, "r+b") as f:
            mm = mmap.mmap(f.fileno(), 0)
        hdr = np.frombuffer(mm, np.uint64, 4, 0)
        hdr[1] = slots
        hdr[2] = slot_bytes
        hdr[3] = row_words
        hdr[0] = wire.SHM_HANDOFF_MAGIC  # publish last
        del hdr
        mm.close()
        return cls(path)

    # -- producer (donor) side ----------------------------------------------

    def _publish(self, seq: int, kind: int, count: int,
                 payload: np.ndarray) -> bool:
        h = int(self._head[0])
        t = int(self._tail[0])
        if h - t >= self.slots:
            return False
        cell = self._cells[h & (self.slots - 1)]
        cell[0] = seq & 0xFFFFFFFF
        cell[1] = (seq >> 32) & 0xFFFFFFFF
        cell[2] = count
        cell[3] = kind
        cell[wire.HANDOFF_SLOT_HDR_WORDS:
             wire.HANDOFF_SLOT_HDR_WORDS + len(payload)] = payload
        self._head[0] = h + 1  # publish after the copy
        return True

    def publish_rows(self, packed: np.ndarray, seq: int) -> bool:
        """One ROWS slot of up to ``rows_per_slot`` packed rows; False
        when full (the shipper waits and retries: a handoff stream may
        not drop)."""
        n = len(packed)
        if n > self.rows_per_slot:
            raise ValueError(f"{n} rows > slot capacity "
                             f"{self.rows_per_slot}")
        return self._publish(seq, wire.HANDOFF_KIND_ROWS, n,
                             np.ascontiguousarray(packed,
                                                  np.uint32).reshape(-1))

    def publish_seal(self, seq: int, total: int, crc: int) -> bool:
        """The stream's trailer: the total row count (u64 split) and the
        CRC32 of every shipped payload byte in ship order."""
        payload = np.array([total & 0xFFFFFFFF,
                            (total >> 32) & 0xFFFFFFFF,
                            crc & 0xFFFFFFFF], np.uint32)
        return self._publish(seq, wire.HANDOFF_KIND_SEAL, 0, payload)

    # -- consumer (recipient) side ------------------------------------------

    def pop_slots(self, max_slots: int) -> list[tuple]:
        """``(seq, kind, count, payload u32 copy)`` of up to
        ``max_slots`` oldest slots, released after the copies."""
        t = int(self._tail[0])
        h = int(self._head[0])
        n = min(h - t, max_slots)
        out = []
        for j in range(n):
            cell = self._cells[(t + j) & (self.slots - 1)]
            seq = int(cell[0]) | (int(cell[1]) << 32)
            out.append((seq, int(cell[3]), int(cell[2]),
                        cell[wire.HANDOFF_SLOT_HDR_WORDS:].copy()))
        if n:
            self._tail[0] = t + n  # release after the copies
        return out

    def readable(self) -> int:
        return int(self._head[0]) - int(self._tail[0])


#: The mailbox class behind :func:`mailbox_cls` (swapped by
#: :func:`use_mailbox_cls`).
_MAILBOX_CLS = HandoffMailbox


def mailbox_cls():
    """The handoff mailbox class every protocol site creates and opens
    mailboxes through: :class:`HandoffMailbox` unless ``fsx crash``
    swapped a simulated one in (``cls.create(path, ...)`` and
    ``cls(path)``)."""
    return _MAILBOX_CLS


@contextlib.contextmanager
def use_mailbox_cls(cls):
    """Put ``cls`` behind :func:`mailbox_cls` for the ``with`` block;
    the previous class comes back on exit."""
    global _MAILBOX_CLS
    prev = _MAILBOX_CLS
    _MAILBOX_CLS = cls
    try:
        yield cls
    finally:
        _MAILBOX_CLS = prev


def ship_rows(mbx: HandoffMailbox, keys, states, *,
              timeout_s: float = tuning.HANDOFF_SHIP_TIMEOUT_S,
              on_slot=None) -> tuple[int, int]:
    """The donor's shipper: the span's rows in ROWS slots, then a SEAL
    with total and CRC.  A full mailbox waits, bounded by ``timeout_s``:
    the recipient refuses a gapped stream, so this seam may not drop.
    ``on_slot(i, n_slots)`` is the chaos hook.  Returns ``(total,
    crc)``."""
    packed = pack_rows(keys, states)
    total = len(packed)
    crc = 0
    per = mbx.rows_per_slot
    n_slots = (total + per - 1) // per
    deadline = time.monotonic() + timeout_s
    seq = 0
    for i in range(n_slots):
        chunk = packed[i * per:(i + 1) * per]
        crc = zlib.crc32(chunk.tobytes(), crc) & 0xFFFFFFFF
        seq += 1
        while not mbx.publish_rows(chunk, seq):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"handoff mailbox full for {timeout_s:.0f}s at "
                    f"slot {seq}/{n_slots} — recipient not draining")
            time.sleep(0.002)
        if on_slot is not None:
            on_slot(i, n_slots)
    seq += 1
    while not mbx.publish_seal(seq, total, crc):
        if time.monotonic() > deadline:
            raise TimeoutError("handoff mailbox full at SEAL")
        time.sleep(0.002)
    return total, crc


class HandoffReceiver:
    """The recipient's incremental drain: ROWS slots accumulate under
    the seq discipline (consecutive from 1; a gap or a duplicate marks
    the stream corrupt), count and CRC verified at SEAL.  ``done`` turns
    True at SEAL; ``ok`` says whether the stream verified."""

    def __init__(self):
        self._chunks: list[np.ndarray] = []
        self._next_seq = 1
        self._crc = 0
        self._rows = 0
        self.seq_gaps = 0
        self.done = False
        self.ok = False
        self.detail = ""

    def drain(self, mbx: HandoffMailbox, max_slots: int = 64) -> None:
        if self.done:
            return
        for seq, kind, count, payload in mbx.pop_slots(max_slots):
            if seq != self._next_seq:
                self.seq_gaps += 1
            self._next_seq = seq + 1
            if kind == wire.HANDOFF_KIND_SEAL:
                total = int(payload[0]) | (int(payload[1]) << 32)
                crc = int(payload[2])
                self.done = True
                if self.seq_gaps:
                    self.detail = (f"{self.seq_gaps} sequence gap(s) "
                                   "in the handoff stream")
                elif self._rows != total:
                    self.detail = (f"row count {self._rows} != sealed "
                                   f"total {total}")
                elif self._crc != crc:
                    self.detail = (f"stream CRC {self._crc:#010x} != "
                                   f"sealed {crc:#010x}")
                else:
                    self.ok = True
                return
            chunk = payload[:count * mbx.row_words]
            self._crc = zlib.crc32(chunk.tobytes(), self._crc) \
                & 0xFFFFFFFF
            self._rows += count
            self._chunks.append(chunk.reshape(count, mbx.row_words))

    def rows(self) -> tuple[np.ndarray, np.ndarray]:
        packed = (np.concatenate(self._chunks) if self._chunks
                  else np.empty((0, ROW_WORDS), np.uint32))
        return unpack_rows(packed)


# -- the UDP leg ------------------------------------------------------------

class NetHandoff:
    """The handoff's UDP transport: one datagram per slot, with a u64
    seq per slot, duplicate suppression at the receiver (a retransmitted
    slot is counted and skipped), cumulative acks back and the sender's
    retransmit of the unacked window on timeout.  A datagram is the shm
    slot image behind a 3-word header, so the SEAL/CRC check is the shm
    leg's.  Transport only: coordinating a handoff across hosts is not
    part of it."""

    _MAGIC = 0x46535848  # "FSXH"
    _HDR_WORDS = 3       # magic, seq lo, seq hi

    def __init__(self, bind=("127.0.0.1", 0)):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(bind)
        self.sock.setblocking(False)
        self.addr = self.sock.getsockname()
        self.rx_dup = 0
        self.retransmits = 0

    def close(self) -> None:
        self.sock.close()

    def _dgram(self, seq: int, slot: np.ndarray) -> bytes:
        hdr = np.array([self._MAGIC, seq & 0xFFFFFFFF,
                        (seq >> 32) & 0xFFFFFFFF], np.uint32)
        return hdr.tobytes() + np.ascontiguousarray(
            slot, np.uint32).tobytes()

    def send_stream(self, peer, slots: list[np.ndarray], *,
                    timeout_s: float = tuning.NET_HANDOFF_TIMEOUT_S,
                    rto_s: float = 0.05) -> None:
        """Ship every slot reliably: send the window, collect cumulative
        acks, retransmit past the RTO until all are acked or the time is
        up.  Slots are the shm leg's slot images, seq from 1."""
        deadline = time.monotonic() + timeout_s
        acked = 0
        n = len(slots)
        next_send = 0.0
        while acked < n:
            now = time.monotonic()
            if now > deadline:
                raise TimeoutError(
                    f"net handoff: peer acked {acked}/{n} slots in "
                    f"{timeout_s:.0f}s")
            if now >= next_send:
                if next_send:
                    self.retransmits += n - acked
                for i in range(acked, n):
                    self.sock.sendto(self._dgram(i + 1, slots[i]), peer)
                next_send = now + rto_s
            try:
                data, _ = self.sock.recvfrom(64)
            except BlockingIOError:
                time.sleep(0.001)
                continue
            w = np.frombuffer(data, np.uint32)
            if len(w) >= 3 and int(w[0]) == self._MAGIC:
                acked = max(acked, int(w[1]) | (int(w[2]) << 32))

    def recv_stream(self, n_slots: int, slot_words: int, *,
                    timeout_s: float = tuning.NET_HANDOFF_TIMEOUT_S
                    ) -> list[np.ndarray]:
        """Receive ``n_slots`` slots in order: out-of-order and
        duplicate datagrams are dropped (counted) and the cumulative ack
        makes the sender offer them again, so the stream delivered has
        no gap."""
        out: list[np.ndarray] = []
        deadline = time.monotonic() + timeout_s
        peer = None
        while len(out) < n_slots:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"net handoff: received {len(out)}/{n_slots} "
                    f"slots in {timeout_s:.0f}s")
            try:
                data, peer = self.sock.recvfrom(
                    4 * (self._HDR_WORDS + slot_words) + 64)
            except BlockingIOError:
                time.sleep(0.001)
                continue
            w = np.frombuffer(data, np.uint32)
            if len(w) < self._HDR_WORDS or int(w[0]) != self._MAGIC:
                continue
            seq = int(w[1]) | (int(w[2]) << 32)
            if seq == len(out) + 1:
                out.append(w[self._HDR_WORDS:].copy())
            else:
                self.rx_dup += 1
            ack = np.array([self._MAGIC, len(out) & 0xFFFFFFFF,
                            (len(out) >> 32) & 0xFFFFFFFF], np.uint32)
            self.sock.sendto(ack.tobytes(), peer)
        return out


# -- the checkpoint row reader (dead-span adoption) -------------------------

def load_ckpt_rows(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Occupied ``(keys, states)`` rows of a checkpoint npz without the
    engine's imports (the supervisor adopting a dead rank's span imports
    no torch).  Folds the checkpoint's integrity CRC byte for byte as
    ``engine/checkpoint.py`` does, so a corrupt snapshot is refused here
    too, never adopted."""
    path = Path(path)
    entries: dict[str, np.ndarray] = {}
    stored_crc = None
    with np.load(io.BytesIO(durable.get_fs().read_bytes(path))) as z:
        for name in z.files:
            if name == "integrity_crc32":
                stored_crc = int(z[name])
            else:
                entries[name] = np.asarray(z[name])
    if stored_crc is not None:
        crc = 0
        for name in sorted(entries):
            arr = np.ascontiguousarray(np.asarray(entries[name]))
            crc = zlib.crc32(name.encode(), crc)
            crc = zlib.crc32(arr.tobytes(), crc)
        if (crc & 0xFFFFFFFF) != stored_crc:
            raise ValueError(
                f"checkpoint {path} failed its integrity check "
                "(adoption refuses to ship garbage rows)")
    key = np.asarray(entries["table_key"], np.uint32)
    state = np.zeros((len(key), wire.NUM_TABLE_COLS), np.float32)
    for i, name in enumerate(wire.TABLE_COLUMN_NAMES):
        if f"table_{name}" in entries:
            state[:, i] = entries[f"table_{name}"]
    occ = key != 0
    return key[occ], state[occ]


# -- the engine's half of the state machine ---------------------------------

def _phase_of(ack: int, handoff_id: int) -> int:
    """This engine's acked phase for ``handoff_id`` from its
    ``c_handoff`` word (0 when the ack names another handoff)."""
    return ack % 8 if ack // 8 == handoff_id else 0


class EngineRebalancer:
    """The engine's half of the handoff protocol (module docstring),
    stepped between run chunks.  The ``eng`` given to :meth:`step` and
    :meth:`reconcile` has three quiescent methods:
    ``extract_span_rows(shards, total_shards)``, ``drop_span_rows(shards,
    total_shards)`` and ``adopt_rows(keys, states)``
    (``engine/engine.py``), and ``count_rebalance(name, n)``."""

    def __init__(self, cluster_dir: str | Path, rank: int, status,
                 *, crash_midship: bool = False):
        self.cluster_dir = Path(cluster_dir)
        self.rank = rank
        self.status = status
        #: chaos hook (spec ``handoff_crash_midship``): the donor dies
        #: hard halfway through its ship
        self.crash_midship = crash_midship
        self._acked_gen = int(status.ctl_get("c_layout_ack"))
        self._fence_seen: int | None = None
        self._receiver: HandoffReceiver | None = None
        self._staged: tuple | None = None  # (handoff dict, keys, states)
        self._mbx: HandoffMailbox | None = None
        #: the handoff id ``_mbx`` was opened for: each handoff has its
        #: own mailbox file, so a retry after an abort reopens
        self._mbx_hid = 0

    def _handoff(self, handoff_id: int) -> dict | None:
        p = handoff_json_path(self.cluster_dir)
        fs = durable.get_fs()
        if not fs.exists(p):
            return None
        try:
            d = json.loads(fs.read_text(p))
        except (OSError, ValueError):
            return None
        return d if d.get("id") == handoff_id else None

    def _ack(self, handoff_id: int, phase: int) -> None:
        self.status.ctl_set("c_handoff", handoff_id * 8 + phase)

    def reconcile(self, eng) -> dict:
        """Boot-time recovery (after ``restore``, before serving): adopt
        a committed but uninserted staged spool, and drop every row the
        committed assignment says this rank no longer owns.  Returns
        what it did."""
        out = {"adopted_rows": 0, "dropped_foreign": 0}
        asg = ShardAssignment.load(self.cluster_dir)
        if asg is None:
            return out
        spool = staged_path(self.cluster_dir, self.rank)
        try:
            sp = load_spool(spool)
            if sp is not None and sp["to_gen"] <= asg.generation:
                # the flip committed before this rank died: the rows are
                # its own.  The spool stays until a checkpoint covers
                # them (note_checkpointed); adopting twice drops the
                # duplicate keys
                inserted, dropped = eng.adopt_rows(sp["keys"],
                                                   sp["states"])
                out["adopted_rows"] = inserted
                eng.count_rebalance("rows_adopted", inserted)
                if dropped:
                    eng.count_rebalance("adopt_dropped", dropped)
        except (OSError, ValueError, KeyError):
            pass  # torn spool: the handoff aborts and retries
        mine = set(asg.spans_of(self.rank))
        foreign = [s for s in range(asg.total_shards) if s not in mine]
        if foreign:
            out["dropped_foreign"] = eng.drop_span_rows(
                foreign, asg.total_shards)
            if out["dropped_foreign"]:
                eng.count_rebalance("foreign_dropped",
                                    out["dropped_foreign"])
        self._acked_gen = asg.generation
        self.status.ctl_set("c_layout_ack", asg.generation)
        return out

    def note_checkpointed(self) -> bool:
        """Called right after a checkpoint is saved: every adopted row
        is now in it, so the staged spool (until now the rows' last
        independent durable copy) goes, if its flip is applied here
        (``to_gen <= _acked_gen``); a newer one belongs to a handoff in
        flight and stays."""
        spool = staged_path(self.cluster_dir, self.rank)
        fs = durable.get_fs()
        if not fs.exists(spool):
            return False
        try:
            sp = load_spool(spool)
        except ValueError:
            return False  # torn: left to the abort and retry
        if sp is None or sp["to_gen"] > self._acked_gen:
            return False
        try:
            fs.unlink(spool)
        except OSError:
            return False
        return True

    def step(self, eng) -> bool:
        """One inter-chunk tick of the engine's state machine; True when
        it did protocol work."""
        fence = int(self.status.ctl_get("c_fence"))
        gen = int(self.status.ctl_get("c_layout_gen"))
        did = False
        if fence:
            did = self._fence_tick(eng, fence) or did
        elif self._staged is not None and gen < self._staged[0]["to_gen"]:
            # the fence cleared without the flip: the handoff ABORTED.
            # The donor still owns the span; keeping the staged rows
            # would count them twice on a retry
            _h, keys, _states = self._staged
            eng.count_rebalance("staged_discarded", len(keys))
            self._staged = None
            self._receiver = None
            self._mbx = None
            self._mbx_hid = 0
            self._fence_seen = None
            did = True
        elif not fence and (self._mbx is not None
                            or self._fence_seen is not None):
            # the fence cleared mid-receive: nothing staged, but the
            # partial stream goes, or a retry would drain the aborted
            # attempt's deleted mailbox
            self._receiver = None
            self._mbx = None
            self._mbx_hid = 0
            self._fence_seen = None
            did = True
        if gen > self._acked_gen:
            did = self._flip_tick(eng, gen) or did
        return did

    def _fence_tick(self, eng, fence: int) -> bool:
        h = self._handoff(fence)
        if h is None:
            return False
        phase = _phase_of(int(self.status.ctl_get("c_handoff")), fence)
        if h.get("donor") == self.rank and phase < wire.HP_SHIPPED:
            if self._fence_seen != fence:
                # first sight of the fence: one more chunk, so the
                # span's records sealed before it are served first
                self._fence_seen = fence
                return True
            keys, states = eng.extract_span_rows(
                h["shards"], h["total_shards"])
            mbx = mailbox_cls()(handoff_mailbox_path(self.cluster_dir,
                                                     fence))
            on_slot = None
            if self.crash_midship:
                def on_slot(i, n):
                    if i >= n // 2:
                        os._exit(17)  # a hard death: no cleanup
            total, _crc = ship_rows(mbx, keys, states, on_slot=on_slot)
            eng.count_rebalance("rows_shipped", total)
            eng.count_rebalance("handoffs_donated", 1)
            self._ack(fence, wire.HP_SHIPPED)
            return True
        if h.get("recipient") == self.rank and phase < wire.HP_STAGED:
            if self._mbx is None or self._mbx_hid != fence:
                try:
                    self._mbx = mailbox_cls()(
                        handoff_mailbox_path(self.cluster_dir, fence))
                except (OSError, RingNotReady):
                    self._mbx = None
                    return False
                self._receiver = HandoffReceiver()
                self._mbx_hid = fence
            self._receiver.drain(self._mbx)
            if not self._receiver.done:
                return True
            if not self._receiver.ok:
                # a torn or gapped stream is not staged: no ack, the
                # supervisor aborts on its timeout, the donor keeps the
                # span
                eng.count_rebalance("streams_refused", 1)
                self._receiver = HandoffReceiver()
                return True
            keys, states = self._receiver.rows()
            # the spool is durable before the ack: a recipient that dies
            # after the flip finds the rows on disk
            save_spool(staged_path(self.cluster_dir, self.rank),
                       keys, states, handoff_id=fence,
                       to_gen=h["to_gen"])
            self._staged = (h, keys, states)
            self._ack(fence, wire.HP_STAGED)
            return True
        return False

    def _flip_tick(self, eng, gen: int) -> bool:
        asg = ShardAssignment.load(self.cluster_dir)
        if asg is None or asg.generation < gen:
            return False  # layout.json not visible yet; next tick
        h = None
        p = handoff_json_path(self.cluster_dir)
        fs = durable.get_fs()
        if fs.exists(p):
            try:
                h = json.loads(fs.read_text(p))
            except (OSError, ValueError):
                h = None
        if h is not None and h.get("to_gen") == gen:
            if h.get("donor") == self.rank:
                dropped = eng.drop_span_rows(h["shards"],
                                             h["total_shards"])
                eng.count_rebalance("rows_dropped_post_flip", dropped)
                self._ack(h["id"], wire.HP_DROPPED)
            elif h.get("recipient") == self.rank:
                if self._staged is not None:
                    _h, keys, states = self._staged
                    inserted, dropped = eng.adopt_rows(keys, states)
                    eng.count_rebalance("rows_adopted", inserted)
                    if dropped:
                        eng.count_rebalance("adopt_dropped", dropped)
                    eng.count_rebalance("handoffs_adopted", 1)
                    self._staged = None
                else:
                    # staged in a previous life: the spool has the rows
                    sp = load_spool(staged_path(self.cluster_dir,
                                                self.rank))
                    if sp is not None:
                        inserted, dropped = eng.adopt_rows(
                            sp["keys"], sp["states"])
                        eng.count_rebalance("rows_adopted", inserted)
                        eng.count_rebalance("handoffs_adopted", 1)
                self._ack(h["id"], wire.HP_INSERTED)
        self._receiver = None
        self._mbx = None
        self._fence_seen = None
        self._acked_gen = gen
        self.status.ctl_set("c_layout_ack", gen)
        return True
