"""Durable publishing of state files: one atomic-write helper.

Counterpart of ``flowsentryx_tpu/core/durable.py`` (its publish
protocol; the reference's simulated-filesystem seam for its crash model
checker is not ported).  A checkpoint publishes in five steps:

1. write a same-directory temp file,
2. ``fsync`` it (the data is durable),
3. optionally rotate the incumbent to its ``.prev`` twin,
4. ``os.replace`` the temp file over the destination (atomic),
5. ``fsync`` the parent directory (the rename is durable).

After step 5 returns the new file survives power loss; before it, the
old complete file does — never a torn mix.
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path


def atomic_write(path: str | Path, data: bytes, *,
                 rotate_prev: Path | None = None) -> None:
    """Publish ``data`` at ``path`` atomically and durably.
    ``rotate_prev`` names where an existing incumbent is kept (the
    checkpoint ``.prev`` generation); both renames are atomic, so a crash
    between them leaves ``.prev`` complete and ``path`` absent — a
    restorable state, never a torn one."""
    path = Path(path)
    tmp = path.with_name(f".{path.name}.tmp.{os.getpid()}")
    try:
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            view = memoryview(data)
            while view:
                view = view[os.write(fd, view):]
            os.fsync(fd)
        finally:
            os.close(fd)
        if rotate_prev is not None and path.exists():
            os.replace(path, rotate_prev)
        os.replace(tmp, path)
        dfd = os.open(path.parent, os.O_RDONLY | os.O_DIRECTORY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
