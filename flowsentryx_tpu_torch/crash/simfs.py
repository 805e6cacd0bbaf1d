"""Simulated filesystem with honest POSIX crash semantics.

Counterpart of ``flowsentryx_tpu/crash/simfs.py``.  The ``fsx crash``
model checker (checker.py) drives the port's real durable-state
protocols — checkpoint rotation, the layout generation flip, the fenced
handoff, dead-span adoption — against this fs through the
``core/durable.py`` seam (:func:`~flowsentryx_tpu_torch.core.durable
.use_fs`), and at every atomic step forks a crash.
For that to prove anything, the crash semantics here must be the ones
POSIX actually gives you, no kinder:

* ``os.replace`` is ATOMIC: after a crash the name maps to the old
  file or the new one, never a mix.  But the rename is a NAMESPACE op,
  durable only once the parent directory's metadata reaches disk — an
  un-fsynced rename lives in the page cache and is LOST at power loss.
* ``fsync(file)`` makes the file's DATA durable.  A file whose data
  was never fsynced can land torn at any byte boundary: empty, a
  prefix, or complete — the page cache flushes what it pleases.
* Power crash loses everything volatile: un-applied namespace ops,
  un-synced data (torn), and every shm mapping (the mailbox hub and
  ctl words live in ``world.py`` and are cleared by the harness).
* PROCESS crash loses none of that: the page cache and shm belong to
  the kernel, not the process.  Party-crash modes therefore keep the
  same fs instance; only power crashes reconstruct one from
  :meth:`SimFS.durable_states`.

Reads are not crash points: a crash "before a read" is
indistinguishable from a crash before the next mutating op, so
tracing them would only multiply identical explorations.

``fsync_is_noop=True`` is the ``fsync_skipped`` planted regression:
every write claims durability it does not have — a publish without the
fsync-file-then-parent-dir discipline of ``core/durable.py``.
"""

from __future__ import annotations

import dataclasses

#: Durable-state fan-out bound per crash point, applied LOUDLY (the
#: report carries ``capped``): the cross product of torn files can
#: explode only when many un-synced files coexist, i.e. under the
#: fsync plants — where the first few states already violate.
MAX_STATES_PER_POINT = 96


class CrashNow(Exception):
    """Raised by :meth:`Tracer.point` at the injected crash point —
    BEFORE the op it names applies, so the op is lost with the crash."""


class Tracer:
    """Execution trace + crash injector shared by the sim fs, the sim
    mailbox hub and the sim ctl words.  Every durable-or-shared-state
    mutation calls :meth:`point` with a human-readable label; the
    label sequence of a clean run IS the crash-point enumeration, and
    the prefix up to an injected crash IS the printed schedule."""

    def __init__(self):
        self.ops: list[tuple[str, str]] = []  # (actor, label) applied
        self.actor = "world"
        #: False during scenario setup/recovery: those phases model
        #: state that was already durable (or a recovery we assume
        #: crash-free — the single-fault model)
        self.enabled = False
        self.crash_at: int | None = None
        #: None = power (any actor's op); otherwise only that actor's
        #: ops count toward ``crash_at`` — a process crash boundary
        self.crash_actor: str | None = None
        self.fired = False
        self.crashed_op: str | None = None
        self._seen = 0

    def point(self, label: str) -> None:
        if not self.enabled:
            return
        if (self.crash_at is not None and not self.fired
                and (self.crash_actor is None
                     or self.actor == self.crash_actor)):
            if self._seen == self.crash_at:
                self.fired = True
                self.crashed_op = f"{self.actor}: {label}"
                raise CrashNow(self.crashed_op)
            self._seen += 1
        self.ops.append((self.actor, label))

    def rendered(self) -> list[str]:
        return [f"{a}: {op}" for a, op in self.ops]


def eligible_points(ops: list[tuple[str, str]],
                    actor: str | None) -> int:
    """How many crash points a clean run exposes for ``actor`` (None =
    power: every op).  The checker enumerates ``crash_at`` over this."""
    return sum(1 for a, _ in ops if actor is None or a == actor)


@dataclasses.dataclass
class _File:
    """One inode: content is immutable after create (every write here
    is a fresh temp file), so durability is a single bit."""

    data: bytes
    synced: bool


def _base(path) -> str:
    return str(path).rsplit("/", 1)[-1]


class SimFS:
    """The ``core/durable.py`` seam's simulated twin (module
    docstring).  State is split the way the kernel splits it:

    * ``files``: inode id -> :class:`_File` (data + synced bit),
    * ``ns``: the VOLATILE namespace every read sees (page cache view),
    * ``durable_ns``: the namespace as of the last directory fsync,
    * ``pending``: namespace ops applied to ``ns`` but not yet to
      ``durable_ns`` — a power crash preserves any PREFIX of them
      (single-directory world: one fsync flushes the whole journal,
      and the kernel applies metadata ops in order).
    """

    name = "sim"

    def __init__(self, tracer: Tracer, *, fsync_is_noop: bool = False):
        self.tracer = tracer
        self.fsync_is_noop = fsync_is_noop
        self.files: dict[int, _File] = {}
        self.ns: dict[str, int] = {}
        self.durable_ns: dict[str, int] = {}
        self.pending: list[tuple] = []
        #: destination of the most recent publish rename — the
        #: media-fault flavor's target (corrupt-last-published)
        self.last_published: str | None = None
        self._fid = 0

    @classmethod
    def from_state(cls, state: dict[str, bytes], tracer: Tracer, *,
                   fsync_is_noop: bool = False) -> "SimFS":
        """The post-reboot fs: one legal durable state (from
        :meth:`durable_states`), everything on it clean and synced —
        the disk after a power crash IS the durable state."""
        fs = cls(tracer, fsync_is_noop=fsync_is_noop)
        for name, data in state.items():
            fs._fid += 1
            fs.files[fs._fid] = _File(data, True)
            fs.ns[name] = fs._fid
            fs.durable_ns[name] = fs._fid
        return fs

    # -- the seam (core/durable.py RealFS's method set) ----------------------

    def exists(self, path) -> bool:
        return str(path) in self.ns

    def size(self, path) -> int:
        return len(self.read_bytes(path))

    def read_bytes(self, path) -> bytes:
        name = str(path)
        if name not in self.ns:
            raise FileNotFoundError(2, "no such file", name)
        return self.files[self.ns[name]].data

    def read_text(self, path) -> str:
        return self.read_bytes(path).decode()

    def unlink(self, path) -> None:
        name = str(path)
        if name not in self.ns:
            raise FileNotFoundError(2, "no such file", name)
        self.tracer.point(f"unlink {_base(name)}")
        del self.ns[name]
        self.pending.append(("unlink", name))

    def write_atomic(self, path, data, *, fsync: bool = True,
                     rotate_prev=None) -> None:
        """The five-step publish, decomposed into its primitive ops so
        each is a crash point (durable.py's RealFS does the same steps
        against the kernel).  ``fsync_is_noop`` models a publish whose
        fsyncs are missing: the calls happen, durability does not."""
        if isinstance(data, str):
            data = data.encode()
        name = str(path)
        tmp = name + ".tmp"
        do_sync = fsync and not self.fsync_is_noop
        # 1. write the temp file (data volatile, possibly torn)
        self.tracer.point(f"write {_base(tmp)} ({len(data)} B)")
        self._fid += 1
        fid = self._fid
        self.files[fid] = _File(bytes(data), False)
        self.ns[tmp] = fid
        self.pending.append(("create", tmp, fid))
        # 2. fsync the temp file (data durable)
        if do_sync:
            self.tracer.point(f"fsync {_base(tmp)}")
            self.files[fid].synced = True
        # 3. rotate the incumbent to .prev (atomic rename)
        if rotate_prev is not None and name in self.ns:
            prev = str(rotate_prev)
            self.tracer.point(f"rename {_base(name)} -> {_base(prev)}")
            pfid = self.ns.pop(name)
            self.ns.pop(prev, None)
            self.pending.append(("rename", name, prev, pfid))
            self.ns[prev] = pfid
        # 4. publish (atomic rename over the destination)
        self.tracer.point(f"rename {_base(tmp)} -> {_base(name)}")
        del self.ns[tmp]
        self.ns[name] = fid
        self.pending.append(("rename", tmp, name, fid))
        self.last_published = name
        # 5. fsync the parent directory (namespace ops durable)
        if do_sync:
            self.tracer.point(f"fsync parent dir of {_base(name)}")
            self._apply_all_pending()

    # -- crash-state enumeration ---------------------------------------------

    def _apply_all_pending(self) -> None:
        for op in self.pending:
            _apply_ns_op(self.durable_ns, op)
        self.pending.clear()

    def durable_states(self, *, media_fault: bool = False,
                       quick: bool = False):
        """Every distinct on-disk state a power crash RIGHT NOW can
        legally leave: each prefix of the pending namespace journal,
        crossed with every tear variant of each un-synced file visible
        under that prefix.  ``media_fault=True`` adds, per base state
        whose last-published file is intact, a twin with one bit
        flipped in it — the media-corruption fault the ``.prev``
        retention exists for (a pure power crash with correct fsync
        can never damage an already-published file).

        Returns ``(states, capped)`` where each state is
        ``(label, {path: bytes})`` and ``capped`` says the
        :data:`MAX_STATES_PER_POINT` bound truncated the fan-out."""
        out: list[tuple[str, dict[str, bytes]]] = []
        seen: set = set()
        capped = False
        for k in range(len(self.pending) + 1):
            ns = dict(self.durable_ns)
            for op in self.pending[:k]:
                _apply_ns_op(ns, op)
            # content choices per surviving name
            names = sorted(ns)
            choices: list[list[tuple[bytes, str]]] = []
            for name in names:
                f = self.files[ns[name]]
                if f.synced:
                    choices.append([(f.data, "")])
                else:
                    choices.append([
                        (t, f"{_base(name)} torn to {len(t)}/"
                            f"{len(f.data)} B" if t != f.data else "")
                        for t in _tears(f.data, quick)])
            for combo in _product(choices):
                state = {n: c for n, (c, _) in zip(names, combo)}
                key = tuple(sorted(state.items()))
                if key in seen:
                    continue
                seen.add(key)
                notes = [lbl for _, lbl in combo if lbl]
                label = (f"{k}/{len(self.pending)} pending namespace "
                         f"op(s) applied"
                         + ("; " + "; ".join(notes) if notes else ""))
                out.append((label, state))
                if len(out) >= MAX_STATES_PER_POINT:
                    capped = True
                    break
            if capped:
                break
        if media_fault and not capped:
            lp = self.last_published
            extra = []
            for label, state in out:
                if lp and lp in state and len(state[lp]) > 0 \
                        and "torn" not in label:
                    bad = bytearray(state[lp])
                    bad[len(bad) // 2] ^= 0x40
                    extra.append((
                        label + f"; media fault: one bit flipped in "
                                f"{_base(lp)}",
                        {**state, lp: bytes(bad)}))
                if len(out) + len(extra) >= MAX_STATES_PER_POINT:
                    capped = True
                    break
            out.extend(extra)
        return out, capped


def _apply_ns_op(ns: dict, op: tuple) -> None:
    if op[0] == "create":
        _, name, fid = op
        ns[name] = fid
    elif op[0] == "rename":
        _, src, dst, fid = op
        ns.pop(src, None)
        ns[dst] = fid
    else:  # unlink
        ns.pop(op[1], None)


def _tears(data: bytes, quick: bool) -> list[bytes]:
    """Legal post-crash contents of an un-synced file: the page cache
    flushed none, some prefix, or all of it."""
    if quick:
        variants = [b"", data]
    else:
        variants = [b"", data[:1], data[:max(1, len(data) // 2)],
                    data[:-1], data]
    out: list[bytes] = []
    for v in variants:
        if v not in out:
            out.append(v)
    return out


def _product(choices: list[list]):
    """itertools.product over per-file content choices (inline so the
    empty-choices case yields one empty combo, matching product())."""
    if not choices:
        yield ()
        return
    head, *rest = choices
    for h in head:
        for r in _product(rest):
            yield (h,) + r
