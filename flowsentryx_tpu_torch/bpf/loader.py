"""Raw ``bpf(2)`` syscall loader: the kernel handshake without libbpf.

Creates maps, patches map fds into program relocations, loads programs
through the real in-kernel verifier (surfacing its log on rejection),
executes them against crafted packets via ``BPF_PROG_TEST_RUN``, and
drains ``BPF_MAP_TYPE_RINGBUF`` maps through the mmap consumer protocol.

This is the kernel↔user seam done with the same syscalls libbpf makes —
the original system's intended path was ``bpftool prog load`` plus a
BCC stub that never ran.  PROG_TEST_RUN is the
SURVEY.md §4 "fake backend": XDP programs run against synthetic frames
with no NIC, no root networking, inside any container whose seccomp
policy admits bpf().

All struct layouts below are the stable kernel uapi ABI (union
bpf_attr), re-derived from the documented field order.

Counterpart of ``flowsentryx_tpu/bpf/loader.py``.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import platform
import struct
from dataclasses import dataclass

from flowsentryx_tpu_torch.bpf.asm import Program

_SYS_BPF = {  # bpf(2) syscall number is per-architecture
    "x86_64": 321,
    "aarch64": 280,
    "riscv64": 280,
    "s390x": 351,
    "ppc64le": 361,
}.get(platform.machine(), 321)
_libc = ctypes.CDLL(None, use_errno=True)

# ---- commands ----
CMD_MAP_CREATE = 0
CMD_MAP_LOOKUP_ELEM = 1
CMD_MAP_UPDATE_ELEM = 2
CMD_MAP_DELETE_ELEM = 3
CMD_MAP_GET_NEXT_KEY = 4
CMD_PROG_LOAD = 5
CMD_OBJ_PIN = 6
CMD_OBJ_GET = 7
CMD_PROG_TEST_RUN = 10

# ---- map types ----
MAP_TYPE_HASH = 1
MAP_TYPE_ARRAY = 2
MAP_TYPE_PERCPU_HASH = 5
MAP_TYPE_PERCPU_ARRAY = 6
MAP_TYPE_LRU_HASH = 9
MAP_TYPE_RINGBUF = 27

# ---- program types ----
PROG_TYPE_SOCKET_FILTER = 1
PROG_TYPE_XDP = 6

# ---- update flags ----
BPF_ANY = 0
BPF_NOEXIST = 1
BPF_EXIST = 2

_PAGE = mmap.PAGESIZE
_RINGBUF_BUSY_BIT = 1 << 31
_RINGBUF_DISCARD_BIT = 1 << 30


class BpfError(OSError):
    pass


class VerifierError(BpfError):
    """PROG_LOAD rejection; carries the verifier log."""

    def __init__(self, errno_: int, log: str):
        super().__init__(errno_, os.strerror(errno_))
        self.log = log

    def __str__(self) -> str:  # pragma: no cover - repr aid
        tail = "\n".join(self.log.strip().splitlines()[-25:])
        return f"{super().__str__()}\nverifier log (tail):\n{tail}"


def _bpf(cmd: int, attr: bytes) -> int:
    buf = ctypes.create_string_buffer(attr, len(attr))
    r = _libc.syscall(_SYS_BPF, cmd, buf, len(attr))
    if r < 0:
        raise BpfError(ctypes.get_errno(), os.strerror(ctypes.get_errno()))
    return r


def bpf_available() -> bool:
    """True when this process may create BPF maps (seccomp/caps allow)."""
    try:
        attr = struct.pack("<IIII", MAP_TYPE_ARRAY, 4, 8, 1) + b"\0" * 112
        fd = _bpf(CMD_MAP_CREATE, attr)
    except BpfError:
        return False
    os.close(fd)
    return True


def n_possible_cpus() -> int:
    """Per-CPU map value arrays are sized by possible CPUs, not online."""
    try:
        txt = open("/sys/devices/system/cpu/possible").read().strip()
        lo, _, hi = txt.partition("-")
        return int(hi or lo) + 1
    except OSError:  # pragma: no cover
        return os.cpu_count() or 1


@dataclass
class Map:
    fd: int
    map_type: int
    key_size: int
    value_size: int
    max_entries: int
    name: str = ""

    @property
    def percpu(self) -> bool:
        return self.map_type in (MAP_TYPE_PERCPU_HASH, MAP_TYPE_PERCPU_ARRAY)

    def _vbuf_size(self) -> int:
        if self.percpu:
            return ((self.value_size + 7) & ~7) * n_possible_cpus()
        return self.value_size

    def lookup(self, key: bytes) -> bytes | None:
        kb = ctypes.create_string_buffer(key, self.key_size)
        vb = ctypes.create_string_buffer(self._vbuf_size())
        attr = struct.pack("<IxxxxQQQ", self.fd, ctypes.addressof(kb),
                           ctypes.addressof(vb), 0) + b"\0" * 96
        try:
            _bpf(CMD_MAP_LOOKUP_ELEM, attr)
        except BpfError as e:
            if e.errno == 2:  # ENOENT
                return None
            raise
        return vb.raw

    def lookup_percpu(self, key: bytes) -> list[bytes]:
        """Per-CPU lookup: one value per possible CPU."""
        raw = self.lookup(key)
        if raw is None:
            return []
        stride = (self.value_size + 7) & ~7
        return [raw[i * stride: i * stride + self.value_size]
                for i in range(n_possible_cpus())]

    def update(self, key: bytes, value: bytes, flags: int = BPF_ANY) -> None:
        kb = ctypes.create_string_buffer(key, self.key_size)
        vb = ctypes.create_string_buffer(value, self._vbuf_size())
        attr = struct.pack("<IxxxxQQQ", self.fd, ctypes.addressof(kb),
                           ctypes.addressof(vb), flags) + b"\0" * 96
        _bpf(CMD_MAP_UPDATE_ELEM, attr)

    def delete(self, key: bytes) -> bool:
        kb = ctypes.create_string_buffer(key, self.key_size)
        attr = struct.pack("<IxxxxQQQ", self.fd, ctypes.addressof(kb), 0, 0) \
            + b"\0" * 96
        try:
            _bpf(CMD_MAP_DELETE_ELEM, attr)
        except BpfError as e:
            if e.errno == 2:
                return False
            raise
        return True

    def keys(self) -> list[bytes]:
        """Iterate all keys via MAP_GET_NEXT_KEY."""
        out: list[bytes] = []
        kb = ctypes.create_string_buffer(self.key_size)
        nb = ctypes.create_string_buffer(self.key_size)
        key_ptr = 0  # NULL: first key
        while True:
            attr = struct.pack("<IxxxxQQQ", self.fd, key_ptr,
                               ctypes.addressof(nb), 0) + b"\0" * 96
            try:
                _bpf(CMD_MAP_GET_NEXT_KEY, attr)
            except BpfError as e:
                if e.errno == 2:
                    return out
                raise
            out.append(nb.raw[:])
            kb = ctypes.create_string_buffer(nb.raw, self.key_size)
            key_ptr = ctypes.addressof(kb)

    def pin(self, path: str) -> None:
        pb = ctypes.create_string_buffer(path.encode())
        attr = struct.pack("<QI", ctypes.addressof(pb), self.fd) + b"\0" * 108
        _bpf(CMD_OBJ_PIN, attr)

    @staticmethod
    def obj_get(path: str) -> int:
        """Open a pinned BPF object (map or prog); returns its fd."""
        return obj_get(path)

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1


def obj_get(path: str) -> int:
    """Open a pinned BPF object (map or prog) from bpffs; returns fd."""
    pb = ctypes.create_string_buffer(path.encode())
    attr = struct.pack("<QI", ctypes.addressof(pb), 0) + b"\0" * 116
    return _bpf(CMD_OBJ_GET, attr)


def map_create(map_type: int, key_size: int, value_size: int,
               max_entries: int, name: str = "", flags: int = 0) -> Map:
    nm = name.encode()[:15].ljust(16, b"\0")
    attr = struct.pack("<IIIIIII", map_type, key_size, value_size,
                       max_entries, flags, 0, 0) + nm + b"\0" * 84
    fd = _bpf(CMD_MAP_CREATE, attr)
    return Map(fd, map_type, key_size, value_size, max_entries, name)


def prog_load(prog: Program | bytes, prog_type: int = PROG_TYPE_XDP,
              map_fds: dict[str, int] | None = None, license_: str = "GPL",
              log_size: int = 1 << 20, name: str = "") -> int:
    """Load through the verifier; raises VerifierError with the log.

    A :class:`Program` is first run through the IN-REPO static verifier
    (``bpf/verifier.py``), so a generation bug surfaces as a precise
    instruction-level diagnostic instead of a kernel ``EACCES`` — and
    surfaces at all in environments where bpf(2) is unavailable.  Raw
    bytes skip the static pass (no relocation table to interpret);
    ``FSX_SKIP_STATIC_VERIFY=1`` skips it explicitly.

    The first load asks for no verifier log; only a refused program is
    loaded again with one, for the diagnosis.  (The kernel fails a load
    with ENOSPC when the log outgrows its buffer, even for a program it
    accepts: the ``ml`` programs' log outgrows 1 MiB.  The reference's
    loader always asks for the log and so cannot load them on such a
    kernel; libbpf loads as this function does.)
    """
    if isinstance(prog, Program) and \
            os.environ.get("FSX_SKIP_STATIC_VERIFY") != "1":
        from flowsentryx_tpu_torch.bpf import verifier

        verifier.check_program_cached(prog)
    code = prog.pack(map_fds) if isinstance(prog, Program) else prog
    insn_cnt = len(code) // 8
    ib = ctypes.create_string_buffer(code, len(code))
    lb = ctypes.create_string_buffer(license_.encode())
    nm = (name or getattr(prog, "name", "prog")).encode()[:15].ljust(16, b"\0")

    def attr(level: int, size: int, buf: int) -> bytes:
        return struct.pack(
            "<IIQQIIQI",
            prog_type, insn_cnt, ctypes.addressof(ib), ctypes.addressof(lb),
            level, size, buf, 0,
        ) + struct.pack("<I", 0) + nm + b"\0" * 60

    try:
        return _bpf(CMD_PROG_LOAD, attr(0, 0, 0))
    except BpfError:
        pass
    logb = ctypes.create_string_buffer(log_size)
    try:
        return _bpf(CMD_PROG_LOAD, attr(1, log_size, ctypes.addressof(logb)))
    except BpfError as e:
        raise VerifierError(e.errno, logb.value.decode(errors="replace")) from None


def prog_test_run(prog_fd: int, data_in: bytes, repeat: int = 1,
                  data_out_size: int = 4096) -> tuple[int, int, bytes]:
    """Returns (retval, duration_ns_mean, data_out)."""
    din = ctypes.create_string_buffer(data_in, len(data_in))
    dout = ctypes.create_string_buffer(data_out_size)
    attr_buf = ctypes.create_string_buffer(
        struct.pack("<IIIIQQII", prog_fd, 0, len(data_in), data_out_size,
                    ctypes.addressof(din), ctypes.addressof(dout),
                    repeat, 0) + b"\0" * 80)
    r = _libc.syscall(_SYS_BPF, CMD_PROG_TEST_RUN, attr_buf, len(attr_buf.raw) - 1)
    if r < 0:
        raise BpfError(ctypes.get_errno(), os.strerror(ctypes.get_errno()))
    _, retval, _, out_sz, _, _, _, duration = struct.unpack(
        "<IIIIQQII", attr_buf.raw[:40])
    return retval, duration, dout.raw[:out_sz]


class RingbufReader:
    """mmap consumer for BPF_MAP_TYPE_RINGBUF (single consumer).

    Layout (kernel ABI): page 0 = consumer pos (we write it), page 1 =
    producer pos (read-only), then the data area mapped twice so records
    never wrap mid-read.  Records carry an 8-byte header: u32 len with
    BUSY/DISCARD bits, u32 pgoff; total stride rounds up to 8.
    """

    def __init__(self, ring_map: Map):
        if ring_map.map_type != MAP_TYPE_RINGBUF:
            raise ValueError("not a ringbuf map")
        self.size = ring_map.max_entries
        self.mask = self.size - 1
        self.cons_mm = mmap.mmap(ring_map.fd, _PAGE, mmap.MAP_SHARED,
                                 mmap.PROT_READ | mmap.PROT_WRITE, offset=0)
        self.prod_mm = mmap.mmap(ring_map.fd, _PAGE + 2 * self.size,
                                 mmap.MAP_SHARED, mmap.PROT_READ,
                                 offset=_PAGE)

    def _consumer_pos(self) -> int:
        return struct.unpack_from("<Q", self.cons_mm, 0)[0]

    def _producer_pos(self) -> int:
        return struct.unpack_from("<Q", self.prod_mm, 0)[0]

    def read(self, max_records: int = 1 << 20) -> list[bytes]:
        out: list[bytes] = []
        pos = self._consumer_pos()
        prod = self._producer_pos()
        while pos < prod and len(out) < max_records:
            off = _PAGE + (pos & self.mask)
            hdr_len = struct.unpack_from("<I", self.prod_mm, off)[0]
            if hdr_len & _RINGBUF_BUSY_BIT:
                break  # producer mid-commit
            rec_len = hdr_len & ~(_RINGBUF_BUSY_BIT | _RINGBUF_DISCARD_BIT)
            if not hdr_len & _RINGBUF_DISCARD_BIT:
                out.append(self.prod_mm[off + 8: off + 8 + rec_len])
            pos += (8 + rec_len + 7) & ~7
        struct.pack_into("<Q", self.cons_mm, 0, pos)
        return out

    def close(self) -> None:
        self.cons_mm.close()
        self.prod_mm.close()
