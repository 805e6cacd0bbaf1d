"""Checkpoint and restore of the serving state: table, stats and clock.

Counterpart of ``flowsentryx_tpu/engine/checkpoint.py``, in the same
file format, so a snapshot written by either package loads in the other
(``tests/test_torch_checkpoint.py``): one ``.npz`` holding

* ``table_key`` (``[N]`` uint32) and one ``table_<column>`` f32 array per
  state column, N the table's capacity (the port's park row is never
  saved);
* ``stats_<counter>`` as the reference's ``[2]`` uint32 ``(lo, hi)``
  pair per counter (the port counts in int64 and converts here);
* ``t0_ns``, and the geometry header ``hash_salt``, ``n_shards``,
  ``capacity``, ``schema_version``;
* ``integrity_crc32``: a CRC32 folded over every other entry (its name,
  then its bytes, in sorted-name order), so a bit flip or a torn file is
  never loaded silently (:class:`CheckpointCorrupt`).

A save publishes atomically and durably (:func:`..core.durable
.atomic_write`) and keeps the incumbent as ``<path>.prev``, the
generation a restore falls back to when ``<path>`` is corrupt.
"""

from __future__ import annotations

import io
import tokenize
import zipfile
import zlib
from pathlib import Path
from typing import NamedTuple

import numpy as np

from flowsentryx_tpu_torch.core import durable, schema

CHECKPOINT_SCHEMA_VERSION = 1

#: One array per state column, named as the reference names them.
TABLE_COLUMN_NAMES = tuple(c.name.lower() for c in schema.TableCol)


class CheckpointCorrupt(ValueError):
    """A checkpoint failed validation: empty, truncated, torn,
    bit-flipped (CRC mismatch) or structurally unreadable.  A
    ``ValueError``, so ``except ValueError`` callers keep refusing; the
    distinct type lets a restore fall back to the ``.prev`` generation
    on damage while contract errors (schema, salt) still propagate."""


#: np.load errors that mean "this file is damaged": zip and zlib tears,
#: short reads, members absent from a file torn at create, and — past
#: the reference's list — a damaged ``.npy`` member header (numpy parses
#: it with ``tokenize``/``ast``: ``TokenError``, ``SyntaxError``) or a
#: damaged zip compression-method field (``NotImplementedError``), which
#: the reference lets escape its ``.prev`` fallback (ROADMAP queue 3).
_DAMAGE_ERRORS = (OSError, EOFError, zipfile.BadZipFile, zlib.error,
                  KeyError, IndexError, ValueError, SyntaxError,
                  tokenize.TokenError, NotImplementedError)


def _fold_crc(entries: dict) -> int:
    """CRC32 over every section, sorted by name: the name's bytes, then
    the array's raw bytes."""
    crc = 0
    for name in sorted(entries):
        arr = np.ascontiguousarray(np.asarray(entries[name]))
        crc = zlib.crc32(name.encode(), crc)
        crc = zlib.crc32(arr.tobytes(), crc)
    return crc & 0xFFFFFFFF


def _npz_path(path: str | Path) -> Path:
    p = Path(path)
    return p if p.suffix == ".npz" else p.with_suffix(p.suffix + ".npz")


def prev_path(path: str | Path) -> Path:
    """The retained previous generation of a checkpoint path
    (``snap.npz`` -> ``snap.npz.prev``), in the same directory."""
    p = _npz_path(path)
    return p.with_name(p.name + ".prev")


class Checkpoint(NamedTuple):
    """A loaded snapshot, on the host (numpy)."""

    key: np.ndarray              # [N] uint32
    state: np.ndarray            # [N, NUM_TABLE_COLS] float32
    stats: dict                  # counter -> [2] uint32 (lo, hi)
    t0_ns: int
    hash_salt: int
    n_shards: int                # geometry the rows were laid out under
    capacity: int
    missing_columns: tuple       # table columns the snapshot predates
    missing_stats: tuple         # counters the snapshot predates
    crc_checked: bool = True     # False only for pre-CRC snapshots


def save_state(path: str | Path, table: schema.IpTableState,
               stats: schema.GlobalStats, t0_ns: int, hash_salt: int = 0,
               n_shards: int = 1) -> Path:
    """Snapshot the serving state atomically, rotating the incumbent to
    ``.prev``; returns the path written (``.npz`` appended if absent).
    Reads the table and stats off the device: call it between runs."""
    path = _npz_path(path)
    key, state = schema.table_to_numpy(table)
    entries = {
        "table_key": key,
        **{f"table_{name}": state[:, i]
           for i, name in enumerate(TABLE_COLUMN_NAMES)},
        **{f"stats_{k}": v
           for k, v in schema.stats_to_numpy(stats).items()},
        "t0_ns": np.uint64(t0_ns),
        "hash_salt": np.uint64(hash_salt),
        "n_shards": np.uint64(n_shards),
        "capacity": np.uint64(key.shape[0]),
        "schema_version": np.int64(CHECKPOINT_SCHEMA_VERSION),
    }
    buf = io.BytesIO()
    np.savez_compressed(buf, integrity_crc32=np.uint32(_fold_crc(entries)),
                        **entries)
    durable.atomic_write(path, buf.getvalue(), rotate_prev=prev_path(path))
    return path


def _read(path: Path) -> bytes:
    try:
        data = durable.get_fs().read_bytes(path)
    except OSError as e:
        raise CheckpointCorrupt(
            f"checkpoint {path} is unreadable: {e}") from e
    if not data:
        raise CheckpointCorrupt(
            f"checkpoint {path} is empty (0 bytes): a file torn at "
            "create time, not a snapshot")
    return data


def peek_header(path: str | Path) -> dict:
    """The geometry header without loading the arrays — salt, shard
    count, capacity, schema version — so the CLI can validate (or plan
    a reshard) before it builds an engine.  Pre-header snapshots read as
    salt 0 / one shard; capacity falls back to the key column's length.
    A damaged file raises :class:`CheckpointCorrupt`."""
    path = Path(path)
    data = _read(path)
    try:
        with np.load(io.BytesIO(data)) as z:
            cap = (int(z["capacity"]) if "capacity" in z
                   else int(z["table_key"].shape[0]))
            return {
                "schema_version": int(z["schema_version"]),
                "hash_salt": int(z["hash_salt"]) if "hash_salt" in z else 0,
                "n_shards": int(z["n_shards"]) if "n_shards" in z else 1,
                "capacity": cap,
                "has_crc": "integrity_crc32" in z,
            }
    except _DAMAGE_ERRORS as e:
        raise CheckpointCorrupt(
            f"checkpoint {path} is corrupt or truncated ({len(data)} "
            f"bytes): {type(e).__name__}: {e}") from e


def peek_salt(path: str | Path) -> int:
    """The hash salt a checkpoint's table was built under (pre-salt
    snapshots read as 0, the unsalted hash)."""
    return peek_header(path)["hash_salt"]


def load_checkpoint(path: str | Path) -> Checkpoint:
    """Load a snapshot to host arrays, verifying its CRC; a damaged file
    raises :class:`CheckpointCorrupt`.  Columns or counters the snapshot
    predates load as zeros and are named in ``missing_*``."""
    path = Path(path)
    data = _read(path)
    entries: dict[str, np.ndarray] = {}
    stored_crc = None
    try:
        with np.load(io.BytesIO(data)) as z:
            for name in z.files:
                if name == "integrity_crc32":
                    stored_crc = int(z[name])
                else:
                    entries[name] = np.asarray(z[name])
    except _DAMAGE_ERRORS as e:
        raise CheckpointCorrupt(
            f"checkpoint {path} is corrupt or truncated: "
            f"{type(e).__name__}: {e}") from e
    if "schema_version" not in entries or "table_key" not in entries:
        raise CheckpointCorrupt(
            f"checkpoint {path} is missing its schema_version/table_key "
            "sections (torn write?)")
    if stored_crc is not None:
        actual = _fold_crc(entries)
        if actual != stored_crc:
            raise CheckpointCorrupt(
                f"checkpoint {path} failed its integrity check: stored "
                f"CRC32 {stored_crc:#010x} != recomputed {actual:#010x}")
    version = int(entries["schema_version"])
    if version != CHECKPOINT_SCHEMA_VERSION:
        raise ValueError(
            f"checkpoint schema {version} != {CHECKPOINT_SCHEMA_VERSION}")
    cap = int(entries["table_key"].shape[0])
    state = np.zeros((cap, schema.NUM_TABLE_COLS), np.float32)
    missing = []
    for i, name in enumerate(TABLE_COLUMN_NAMES):
        if f"table_{name}" in entries:
            state[:, i] = entries[f"table_{name}"]
        else:
            missing.append(name)
    stats, missing_stats = {}, []
    for k in schema.GlobalStats._fields:
        if f"stats_{k}" in entries:
            stats[k] = np.asarray(entries[f"stats_{k}"], np.uint32)
        else:
            # a counter added after the snapshot resumes from zero
            stats[k] = np.zeros((2,), np.uint32)
            missing_stats.append(k)
    return Checkpoint(
        key=np.asarray(entries["table_key"], np.uint32),
        state=state,
        stats=stats,
        t0_ns=int(entries["t0_ns"]),
        hash_salt=(int(entries["hash_salt"])
                   if "hash_salt" in entries else 0),
        n_shards=int(entries["n_shards"]) if "n_shards" in entries else 1,
        capacity=cap,
        missing_columns=tuple(missing),
        missing_stats=tuple(missing_stats),
        crc_checked=stored_crc is not None,
    )
