"""Operator-editable blacklist: manual block/unblock against the live map.

The reference specifies user-space blacklist management — add/remove
IPs, clear the table, pretty-print — as a planned capability
(reference README.md:70-74,142-147); nothing was built.  Here it is a
thin, dependency-free layer over the pinned ``blacklist_map`` that
``fsxd --bpf --pin DIR`` leaves in bpffs: the same raw-``bpf(2)``
:class:`~flowsentryx_tpu_torch.bpf.loader.Map` the kernel program reads on
every packet, so an operator ``fsx block`` takes effect on the next
packet from that source.

Key space: TWO maps (kern/fsx_kern.c:48-86, mirrored by bpf/progs.py):

* ``blacklist_map`` — u32 keys: IPv4 wire bytes verbatim (little-endian
  load, kern/parsing.h:83-86), or the XOR-fold of a v6 address.  This
  is where the engine's ML verdicts land (its whole data plane keys
  on the fold) — for v6 the fold is approximate by construction.
* ``blacklist_v6`` — EXACT 16-byte v6 source keys (reference
  parity: src/fsx_struct.h:9 ``__u128``).  ``fsx block <v6addr>`` and
  the kernel's own v6 rate-limit blocks write here, so a manual or
  limiter block can never hit an innocent source that merely shares a
  32-bit fold with an attacker.

Counterpart of ``flowsentryx_tpu/bpf/blacklist.py``.
"""

from __future__ import annotations

import socket
import struct
import time
from dataclasses import dataclass

from flowsentryx_tpu_torch.bpf import loader

#: Default bpffs directory fsxd pins under (daemon/fsxd.cpp --pin).
DEFAULT_PIN_DIR = "/sys/fs/bpf/fsx"

#: Matches the kernel image's map spec (bpf/progs.py MAP_SPECS).
KEY_SIZE = 4
V6_KEY_SIZE = 16
VALUE_SIZE = 8


def is_v6(ip: str) -> bool:
    return ":" in ip


def v6_wire(ip: str) -> bytes:
    """16-byte wire form of a v6 address — the EXACT blacklist key."""
    return socket.inet_pton(socket.AF_INET6, ip)


def fold_ip(ip: str) -> int:
    """Fold a textual IPv4/IPv6 address to the kernel's u32 key.

    Mirrors the data plane exactly: the XDP program reads the wire
    source address with a native little-endian u32 load (IPv4) or XORs
    the four address words (IPv6, kern/parsing.h fsx_fold_ip6).
    """
    try:
        wire = socket.inet_pton(socket.AF_INET, ip)
        return struct.unpack("<I", wire)[0]
    except OSError:
        pass
    wire = socket.inet_pton(socket.AF_INET6, ip)  # raises on junk
    w = struct.unpack("<4I", wire)
    return w[0] ^ w[1] ^ w[2] ^ w[3]


def key_to_v4(key: int) -> str:
    """Dotted-quad view of a key (exact for v4 sources; for v6 it is
    the fold, shown only as a convenience)."""
    return socket.inet_ntoa(struct.pack("<I", key))


def ktime_ns() -> int:
    """The kernel program compares against bpf_ktime_get_ns(), which
    reads CLOCK_MONOTONIC."""
    return time.clock_gettime_ns(time.CLOCK_MONOTONIC)


@dataclass
class Entry:
    key: int           # folded u32 source
    until_ns: int      # blocked-until, CLOCK_MONOTONIC ns
    remaining_s: float  # negative = expired, pending lazy delete
    addr: str | None = None  # exact address (v6 exact-map entries only)

    def to_json(self) -> dict:
        d = {
            "key": f"0x{self.key:08x}",
            "v4": key_to_v4(self.key),
            "remaining_s": round(self.remaining_s, 3),
        }
        if self.addr is not None:
            d = {"addr": self.addr, "exact": True,
                 "remaining_s": d["remaining_s"]}
        return d


def open_map(pin_dir: str = DEFAULT_PIN_DIR) -> loader.Map:
    """Open the pinned blacklist map left by ``fsxd --pin`` (or
    ``bpf/loader.py`` pinning)."""
    fd = loader.obj_get(f"{pin_dir}/blacklist_map")
    return loader.Map(fd, loader.MAP_TYPE_LRU_HASH, KEY_SIZE, VALUE_SIZE,
                      0, "blacklist_map")


def open_v6_map(pin_dir: str = DEFAULT_PIN_DIR) -> loader.Map:
    """Open the pinned EXACT v6 blacklist map."""
    fd = loader.obj_get(f"{pin_dir}/blacklist_v6")
    return loader.Map(fd, loader.MAP_TYPE_LRU_HASH, V6_KEY_SIZE, VALUE_SIZE,
                      0, "blacklist_v6")


def open_map_for(ip: str, pin_dir: str = DEFAULT_PIN_DIR) -> loader.Map:
    """The map a manual block/unblock of ``ip`` must target: the exact
    v6 map for v6 addresses, the folded map for v4."""
    return open_v6_map(pin_dir) if is_v6(ip) else open_map(pin_dir)


def block(m: loader.Map, ip: str, ttl_s: float = 10.0) -> Entry:
    """Blacklist ``ip`` for ``ttl_s`` seconds (reference default 10 s,
    fsx_kern.c:308-310); the XDP program drops its next packet.  ``m``
    must be :func:`open_map_for`'s choice: v6 addresses block EXACTLY
    (16-byte key), never by fold."""
    until = ktime_ns() + int(ttl_s * 1e9)
    if is_v6(ip):
        if m.key_size != V6_KEY_SIZE:
            raise ValueError("v6 block needs the blacklist_v6 "
                             "(open_map_for picks it)")
        m.update(v6_wire(ip), struct.pack("<Q", until))
        return Entry(fold_ip(ip), until, ttl_s, addr=ip)
    if m.key_size != KEY_SIZE:
        # the other mismatch direction must not fail SILENTLY: a v4 key
        # zero-padded into the 16-byte map would "succeed" yet never
        # match any packet (v4 traffic only consults blacklist_map)
        raise ValueError("v4 block needs the folded blacklist_map "
                         "(open_map_for picks it)")
    m.update(struct.pack("<I", fold_ip(ip)), struct.pack("<Q", until))
    return Entry(fold_ip(ip), until, ttl_s)


def unblock(m: loader.Map, ip: str) -> bool:
    """Remove ``ip``; returns False if it was not blacklisted."""
    if is_v6(ip):
        if m.key_size != V6_KEY_SIZE:
            raise ValueError("v6 unblock needs the blacklist_v6 "
                             "(open_map_for picks it)")
        return m.delete(v6_wire(ip))
    if m.key_size != KEY_SIZE:
        raise ValueError("v4 unblock needs the folded blacklist_map "
                         "(open_map_for picks it)")
    return m.delete(struct.pack("<I", fold_ip(ip)))


def clear(m: loader.Map) -> int:
    """Delete every entry; returns how many were removed."""
    n = 0
    for kb in m.keys():
        n += m.delete(kb)
    return n


def entries(m: loader.Map) -> list[Entry]:
    """List live entries of either blacklist map (folded or exact-v6;
    distinguished by the map's key size)."""
    now = ktime_ns()
    exact6 = m.key_size == V6_KEY_SIZE
    out = []
    for kb in m.keys():
        vb = m.lookup(kb)
        if vb is None:  # raced a delete/expiry
            continue
        (until,) = struct.unpack("<Q", vb)
        rem = (until - now) / 1e9
        if exact6:
            addr = socket.inet_ntop(socket.AF_INET6, kb)
            out.append(Entry(fold_ip(addr), until, rem, addr=addr))
        else:
            (key,) = struct.unpack("<I", kb)
            out.append(Entry(key, until, rem))
    out.sort(key=lambda e: -e.remaining_s)
    return out
