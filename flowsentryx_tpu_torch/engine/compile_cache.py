"""Persistent store of the built kernel libraries: boot without nvcc.

Counterpart of ``flowsentryx_tpu/engine/compile_cache.py``.  The
reference serializes its XLA executables; CUDA graphs cannot be
serialized, so what a boot of the port compiles and can reuse is its
set of nvcc-built kernel libraries (``ops/kernels.py``: one shared
library per ``csrc/*.cu``).  A boot with a cache directory loads each
library from its entry instead of running nvcc; the captures are paid
at every boot.

Entries are keyed as the reference keys them: the repo's one
staged-shape signature (:func:`~..core.signature.staging_signature`)
names the file, and each entry's header carries the toolchain a
library is valid for (nvcc, torch, the CUDA runtime, the card's compute
capability).  A toolchain change reads as ``version_drift``, counted
apart from a miss and a corrupt entry.

Fail-open: a miss, a drift or a corrupt entry rebuilds the library with
nvcc, counted in :meth:`CompileCache.report` (``EngineReport.boot
["cache"]``).  Nothing ever falls back to a kernel's plain version.

Entry format (one file per (signature, kernel library)), the
reference's layout::

    b"FSXCUSO\\n"                      magic
    <u32 little-endian header length>
    <header JSON: sig digest, variant, toolchain versions>
    <u32 little-endian CRC32 of the blob>
    <blob: the shared library's bytes>

Entries publish through :func:`~..core.durable.atomic_write`: a crash
mid-store leaves the previous complete entry or none.
"""

from __future__ import annotations

import functools
import io
import json
import os
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path

import torch

from flowsentryx_tpu_torch.core import durable
from flowsentryx_tpu_torch.core.signature import signature_digest

MAGIC = b"FSXCUSO\n"


@functools.lru_cache(maxsize=1)
def _nvcc_version() -> str:
    from flowsentryx_tpu_torch.ops import kernels

    try:
        out = subprocess.run([kernels._nvcc(), "--version"],
                             capture_output=True, text=True, check=True)
    except (RuntimeError, OSError, subprocess.CalledProcessError):
        return "unavailable"
    return out.stdout.strip().splitlines()[-1]


def toolchain_versions() -> dict:
    """The toolchain fields a built library is valid under, compared
    header against live at load (a mismatch is ``version_drift``)."""
    cc = (".".join(map(str, torch.cuda.get_device_capability(0)))
          if torch.cuda.is_available() else "none")
    return {"nvcc": _nvcc_version(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "compute_capability": cc}


class CompileCache:
    """On-disk kernel-library store for one staged shape.

    One instance serves one engine boot: the signature is fixed at
    construction, entries are addressed by ``(digest, variant)`` (the
    variant is the library's name, which carries its source hash), and
    the counters tell the boot's story: ``hits`` loaded libraries,
    ``misses`` absent entries, ``corrupt`` CRC or format refusals,
    ``version_drift`` toolchain mismatches, ``stores`` published
    entries, ``store_errors`` failed ones."""

    def __init__(self, root: str | Path, sig: dict):
        self.root = Path(root)
        self.sig = sig
        self.digest = signature_digest(sig)
        self.versions = toolchain_versions()
        self.hits = 0
        self.misses = 0
        self.corrupt = 0
        self.version_drift = 0
        self.stores = 0
        self.store_errors = 0

    def path(self, variant: str) -> Path:
        return self.root / f"{self.digest[:20]}-{variant}.kernel"

    def load(self, variant: str) -> bytes | None:
        """The library bytes of ``variant``; None on any miss, drift or
        corruption (counted: the caller builds with nvcc)."""
        p = self.path(variant)
        try:
            data = p.read_bytes()
        except OSError:
            self.misses += 1
            return None
        try:
            if data[:len(MAGIC)] != MAGIC:
                raise ValueError("bad magic")
            off = len(MAGIC)
            (hlen,) = struct.unpack_from("<I", data, off)
            off += 4
            header = json.loads(data[off:off + hlen].decode())
            off += hlen
            (crc,) = struct.unpack_from("<I", data, off)
            off += 4
            blob = data[off:]
            if zlib.crc32(blob) & 0xFFFFFFFF != crc:
                raise ValueError("CRC mismatch")
        except Exception as e:  # noqa: BLE001 — any damage is a refusal
            self.corrupt += 1
            print(f"fsx compile-cache: corrupt entry {p.name} ({e}); "
                  "rebuilding with nvcc (fail-open)", file=sys.stderr)
            return None
        if header.get("sig_digest") != self.digest:
            # a filename-prefix collision with another shape: not ours, a
            # plain miss (the store after the build overwrites it)
            self.misses += 1
            return None
        if header.get("versions") != self.versions:
            self.version_drift += 1
            print(f"fsx compile-cache: toolchain drift on {p.name} "
                  f"(entry {header.get('versions')} vs live "
                  f"{self.versions}); rebuilding with nvcc (fail-open)",
                  file=sys.stderr)
            return None
        self.hits += 1
        return blob

    def store(self, variant: str, blob: bytes) -> bool:
        """Publish ``blob`` as ``variant``'s entry atomically.  A failure
        is counted and announced, never raised: the library on disk
        still serves this boot."""
        try:
            blob = bytes(blob)
            header = json.dumps({
                "sig_digest": self.digest,
                "variant": variant,
                "versions": self.versions,
                "created_s": round(time.time(), 3),
            }).encode()
            buf = io.BytesIO()
            buf.write(MAGIC)
            buf.write(struct.pack("<I", len(header)))
            buf.write(header)
            buf.write(struct.pack("<I", zlib.crc32(blob) & 0xFFFFFFFF))
            buf.write(blob)
            os.makedirs(self.root, exist_ok=True)
            durable.atomic_write(self.path(variant), buf.getvalue())
        except Exception as e:  # noqa: BLE001 — counted, never raised
            self.store_errors += 1
            print(f"fsx compile-cache: failed to store {variant} "
                  f"({e!r}); this boot serves from the build directory, "
                  "the next one rebuilds", file=sys.stderr)
            return False
        self.stores += 1
        return True

    def report(self) -> dict:
        """The boot's cache story (``EngineReport.boot["cache"]``)."""
        return {
            "dir": str(self.root),
            "sig_digest": self.digest[:20],
            "hits": self.hits,
            "misses": self.misses,
            "corrupt": self.corrupt,
            "version_drift": self.version_drift,
            "stores": self.stores,
            "store_errors": self.store_errors,
        }
