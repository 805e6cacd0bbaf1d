"""Live firewall-rule management over the pinned ``rule_map``.

The reference planned "Dynamic Rule Management ... adding or removing
IP addresses from the blocklist" and "config files ... rules to drop
certain packets" (``README.md:70-74,142-147``); blacklist.py covers the
per-IP half, this module the (proto, dport) stateless-rule half.  Keys
pack ``(l4_proto << 16) | dport`` host-order with 0 as wildcard
(:func:`flowsentryx_tpu_torch.core.schema.pack_rule_key`), values are
``schema.RULE_*`` action codes — the exact layout both kernel twins
probe per packet.

NOTE: adding a rule at runtime also requires the config map's
``rule_count`` to be nonzero (the kernel gates the lookups on it);
``fsxd --rule`` sets it at load time, and :func:`set_enabled` flips it
live for rules added post-start.

Counterpart of ``flowsentryx_tpu/bpf/rules.py``.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import os
import struct
from dataclasses import dataclass

from flowsentryx_tpu_torch.bpf import loader
from flowsentryx_tpu_torch.core import wire as schema
from flowsentryx_tpu_torch.core.config import FsxConfig, RuleConfig

DEFAULT_PIN_DIR = "/sys/fs/bpf/fsx"

_PROTO_NAMES = {0: "any", 1: "icmp", 6: "tcp", 17: "udp", 58: "icmpv6"}


@dataclass
class Rule:
    proto: int
    dport: int
    action: int

    def to_json(self) -> dict:
        return {
            "proto": _PROTO_NAMES.get(self.proto, self.proto),
            "dport": self.dport or "any",
            "action": "drop" if self.action == schema.RULE_DROP
            else self.action,
        }


def open_map(pin_dir: str = DEFAULT_PIN_DIR) -> loader.Map:
    fd = loader.obj_get(f"{pin_dir}/rule_map")
    return loader.Map(fd, loader.MAP_TYPE_HASH, 4, 8, 0, "rule_map")


def entries(m: loader.Map) -> list[Rule]:
    out = []
    for kb in m.keys():
        vb = m.lookup(kb)
        if vb is None:
            continue
        key = struct.unpack("<I", kb)[0]
        out.append(Rule(proto=(key >> 16) & 0xFF, dport=key & 0xFFFF,
                        action=struct.unpack("<Q", vb)[0]))
    return sorted(out, key=lambda r: (r.proto, r.dport))


def parse_spec(spec: str) -> RuleConfig:
    """Validate a ``proto:dport`` spec (proto name/number/'any',
    dport 0 = any) — raises ValueError on malformed input BEFORE any
    map state is touched."""
    proto_s, _, dport_s = spec.partition(":")
    return RuleConfig(
        proto=proto_s if not proto_s.isdigit() else int(proto_s),
        dport=int(dport_s or 0))


def add(m: loader.Map, rule: RuleConfig) -> Rule:
    m.update(struct.pack("<I", rule.key()),
             struct.pack("<Q", schema.RULE_DROP))
    return Rule(proto=rule.proto_code(), dport=rule.dport,
                action=schema.RULE_DROP)


def remove(m: loader.Map, rule: RuleConfig) -> bool:
    return bool(m.delete(struct.pack("<I", rule.key())))


_CONFIG_NAMES = [n for n, _, _ in FsxConfig.KERNEL_CONFIG_FIELDS]

#: How long a config writer waits on the advisory lock before erroring
#: (LOCK_NB + retry: a wedged or hostile holder must produce a loud
#: failure, not an indefinite hang of a root CLI).
LOCK_TIMEOUT_S = 5.0


def _lock_path(pin_dir: str) -> str:
    """Per-pin lockfile path under a caller-owned, non-world-writable
    directory.

    The previous scheme — a predictable name in /tmp opened with
    ``open(..., "w")`` — let any local user pre-create the file and
    hold the flock (wedging root's ``fsx rules``/``fsx config --set``
    forever) or, on kernels without ``fs.protected_symlinks``, plant a
    symlink that root then truncates.  bpffs cannot hold regular files,
    so "beside the pin" is not an option; instead the lock lives under
    ``/run/fsx`` for root (tmpfs, root-owned, 0700) or a uid-suffixed
    0700 dir for unprivileged test runs, and the directory's ownership
    is verified so a squatter is an error rather than an acquisition."""
    base = os.environ.get("FSX_LOCK_DIR")
    if base is None:
        if os.geteuid() == 0:
            base = "/run/fsx"
        else:
            import tempfile

            base = os.path.join(tempfile.gettempdir(),
                                f"fsx-lock-{os.getuid()}")
    os.makedirs(base, mode=0o700, exist_ok=True)
    st = os.stat(base)
    if st.st_uid != os.geteuid():
        raise RuntimeError(
            f"lock dir {base} is owned by uid {st.st_uid}, not "
            f"{os.geteuid()} — refusing to take a lock a different "
            "user controls (set FSX_LOCK_DIR to override)")
    return os.path.join(base, "cfg_%s.lock" % hashlib.sha1(
        os.path.abspath(pin_dir).encode()).hexdigest()[:16])


@contextlib.contextmanager
def _locked(pin_dir: str):
    """Acquire the per-pin advisory lock: O_NOFOLLOW + 0600 creation
    (no symlink traversal, no world-writable file) and a bounded
    LOCK_EX|LOCK_NB retry so a held lock ERRORS after
    :data:`LOCK_TIMEOUT_S` instead of hanging."""
    import time

    fd = os.open(_lock_path(pin_dir),
                 os.O_CREAT | os.O_RDWR | os.O_NOFOLLOW, 0o600)
    try:
        deadline = time.monotonic() + LOCK_TIMEOUT_S
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except (BlockingIOError, InterruptedError):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"config lock for {pin_dir} held by another "
                        f"process for > {LOCK_TIMEOUT_S:.0f}s"
                    ) from None
                time.sleep(0.05)
        yield
    finally:
        os.close(fd)  # releases the flock


@contextlib.contextmanager
def config_map_edit(pin_dir: str):
    """Advisory-locked read-modify-write of the pinned kernel config.

    BPF array-map updates replace the WHOLE value, so two concurrent
    field updaters (``fsx rules`` bumping ``rule_count``, ``fsx config
    --set`` rewriting limiter policy) would clobber each other's fields
    through a bare read-modify-write.  An flock keyed by the pin path
    (:func:`_lock_path`; owner-verified dir, O_NOFOLLOW, bounded wait)
    serializes this repo's own writers; the daemon writes the map only
    at startup, so operator-time races are exactly these two commands.
    Yields the unpacked field dict; writes back on clean exit ONLY if
    the dict changed (a pure read must not re-publish a stale snapshot
    over a concurrent writer — that would reintroduce the clobber it
    exists to prevent)."""
    with _locked(pin_dir):
        fd = loader.obj_get(f"{pin_dir}/config_map")
        m = loader.Map(fd, loader.MAP_TYPE_ARRAY, 4,
                       FsxConfig.KERNEL_CONFIG_SIZE, 0, "config_map")
        try:
            blob = m.lookup(struct.pack("<I", 0))
            if blob is None:  # ARRAY lookups can't ENOENT; belt+braces
                raise RuntimeError(
                    "no config pushed yet (daemon not started?)")
            vals = dict(zip(_CONFIG_NAMES, struct.unpack(
                FsxConfig.KERNEL_CONFIG_FMT, blob)))
            before = dict(vals)
            yield vals
            if vals != before:
                m.update(struct.pack("<I", 0), struct.pack(
                    FsxConfig.KERNEL_CONFIG_FMT,
                    *(vals[n] for n in _CONFIG_NAMES)))
        finally:
            m.close()


def set_enabled(pin_dir: str, count: int) -> None:
    """Update ``rule_count`` in the pinned config map so runtime-added
    rules take effect (the kernel gate; module docstring)."""
    with config_map_edit(pin_dir) as vals:
        vals["rule_count"] = count
