"""Durable publishing of state files: one atomic-write helper.

Counterpart of ``flowsentryx_tpu/core/durable.py``.  A checkpoint
publishes in five steps:

1. write a same-directory temp file,
2. ``fsync`` it (the data is durable),
3. optionally rotate the incumbent to its ``.prev`` twin,
4. ``os.replace`` the temp file over the destination (atomic),
5. ``fsync`` the parent directory (the rename is durable).

After step 5 returns the new file survives power loss; before it, the
old complete file does — never a torn mix.

Every durable-state protocol of the port (checkpoints, ``layout.json``,
``handoff.json``, the staged spool) reads and writes through one
filesystem seam, :func:`get_fs`: :class:`RealFS` by default.  ``fsx
crash`` (:mod:`flowsentryx_tpu_torch.crash`) swaps a simulated
filesystem in with :func:`use_fs` and forks a crash at every step of the
publish; leaving the ``with`` block restores the real one.
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path


class RealFS:
    """The real filesystem behind the seam: existence, whole-file reads,
    unlink and the five-step publish, which is all the protocols use."""

    def exists(self, path: str | Path) -> bool:
        return Path(path).exists()

    def read_bytes(self, path: str | Path) -> bytes:
        return Path(path).read_bytes()

    def read_text(self, path: str | Path) -> str:
        return Path(path).read_text()

    def unlink(self, path: str | Path) -> None:
        os.unlink(path)

    def write_atomic(self, path: str | Path, data: bytes, *,
                     rotate_prev: Path | None = None) -> None:
        """The five-step publish (module docstring).  ``rotate_prev``
        names where an existing incumbent is kept (the checkpoint
        ``.prev`` generation); both renames are atomic, so a crash
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


_FS = RealFS()


def get_fs():
    """The filesystem behind the seam (:class:`RealFS` unless a checker
    swapped another in with :func:`use_fs`)."""
    return _FS


@contextlib.contextmanager
def use_fs(fs):
    """Put ``fs`` behind the seam for the ``with`` block; the previous
    filesystem comes back on exit, exceptions included."""
    global _FS
    prev = _FS
    _FS = fs
    try:
        yield fs
    finally:
        _FS = prev


def atomic_write(path: str | Path, data: bytes, *,
                 rotate_prev: Path | None = None) -> None:
    """Publish ``data`` at ``path`` atomically and durably through the
    seam (module docstring).  ``rotate_prev`` names where an existing
    incumbent is kept (the checkpoint ``.prev`` generation)."""
    get_fs().write_atomic(path, data, rotate_prev=rotate_prev)
