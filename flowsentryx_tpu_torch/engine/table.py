"""Flow-table geometry on the host: plan, validation, hash twins, reshard.

Counterpart of ``flowsentryx_tpu/engine/table.py`` (numpy).  The table's
GEOMETRY — capacity, shard count, salt, probe depth — fixes where every
key's row lives: the top ``log2(n_shards)`` bits of the salted hash pick
the owner shard, the low bits drive the double-hashed probe inside the
owner's rows (``ops/hashtable.probe_slots``).  Here:

* :class:`TablePlan` — the geometry as one value, compared at restore;
* :func:`validate_capacity` — the refusals ``serve --table-capacity``
  and ``serve --restore`` print before an engine is built;
* numpy twins of the device hash (:func:`hash_u32_np`, :func:`owner_of`),
  bit-identical to ``ops/hashtable.hash_u32``;
* :func:`reshard_rows` — restore under a different geometry: every
  occupied row of a checkpoint re-runs the insert probe under the new
  plan (a checkpoint's slot indices mean nothing under another one), and
  :func:`insert_rows`, the same probe into a populated table.

numpy only.
"""

from __future__ import annotations

import dataclasses

import numpy as np


#: State columns per row (``schema.NUM_TABLE_COLS``; numpy-only here).
NUM_TABLE_COLS = 12

#: Second-hash tweak constant — MUST mirror ``ops/hashtable.probe_slots``
#: (the probe-step hash is ``hash_u32(key ^ GOLDEN, salt) | 1``).
_GOLDEN = np.uint32(0x9E3779B9)


def hash_u32_np(k: np.ndarray, salt: int = 0) -> np.ndarray:
    """Numpy twin of :func:`flowsentryx_tpu_torch.ops.hashtable.hash_u32`
    (murmur3 finalizer, salt xor-mixed ahead) — bit-identical."""
    k = np.asarray(k, np.uint32) ^ np.uint32(salt)
    with np.errstate(over="ignore"):
        k = k ^ (k >> np.uint32(16))
        k = k * np.uint32(0x85EBCA6B)
        k = k ^ (k >> np.uint32(13))
        k = k * np.uint32(0xC2B2AE35)
        k = k ^ (k >> np.uint32(16))
    return k


def owner_of(keys: np.ndarray, salt: int, n_shards: int) -> np.ndarray:
    """Owner-shard index of each key (top hash bits), as the
    reference's sharded step routes it."""
    if n_shards <= 1:
        return np.zeros(np.asarray(keys).shape, np.int64)
    k_bits = int(n_shards).bit_length() - 1
    return (hash_u32_np(keys, salt) >> np.uint32(32 - k_bits)).astype(
        np.int64)


@dataclasses.dataclass(frozen=True)
class TablePlan:
    """The table geometry as one comparable value."""

    capacity: int
    n_shards: int = 1
    salt: int = 0
    probes: int = 8

    def __post_init__(self) -> None:
        problems = validate_capacity(self.capacity, n_shards=self.n_shards)
        if problems:
            raise ValueError("; ".join(problems))

    @property
    def local_capacity(self) -> int:
        return self.capacity // self.n_shards



def validate_capacity(
    capacity: int, max_batch: int = 0, n_shards: int = 1
) -> list[str]:
    """Every reason this capacity cannot serve, each as one sentence
    (the ``serve --table-capacity`` refusals; empty list = valid)."""
    problems: list[str] = []
    if capacity <= 0 or capacity & (capacity - 1):
        problems.append(
            f"table capacity {capacity} is not a power of two (slot "
            "probing masks with capacity-1)")
        return problems  # the rest assumes pow2
    if capacity > 1 << 29:
        problems.append(
            f"table capacity {capacity} exceeds 2^29 (the packed "
            "arbitration sort key must fit int32)")
    if max_batch and capacity < max_batch:
        problems.append(
            f"table capacity {capacity} is smaller than max_batch "
            f"{max_batch}: one batch of distinct flows could not even "
            "be tracked")
    if n_shards > 1:
        if n_shards & (n_shards - 1):
            problems.append(
                f"shard count {n_shards} is not a power of two "
                "(ownership uses top hash bits)")
        elif capacity < n_shards:
            problems.append(
                f"table capacity {capacity} cannot split over "
                f"{n_shards} shards")
    return problems


def _global_candidates(keys: np.ndarray, plan: TablePlan) -> np.ndarray:
    """``[R, probes]`` GLOBAL row candidates of each key under
    ``plan`` — the host twin of the device probe sequence
    (``(h1 + p*step) & (local_capacity - 1)`` inside the owner's
    rows)."""
    h1 = hash_u32_np(keys, plan.salt)
    step = hash_u32_np(np.asarray(keys, np.uint32) ^ _GOLDEN,
                       plan.salt) | np.uint32(1)
    mask = np.uint32(plan.local_capacity - 1)
    offs = np.arange(plan.probes, dtype=np.uint32)
    with np.errstate(over="ignore"):
        local = (h1[:, None] + offs[None, :] * step[:, None]) & mask
    base = owner_of(keys, plan.salt, plan.n_shards) * plan.local_capacity
    return base[:, None] + local.astype(np.int64)


def reshard_rows(
    key: np.ndarray,
    state: np.ndarray,
    plan: TablePlan,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Re-place every occupied row under a new geometry.

    ``key``/``state`` are the HOST global arrays of a loaded checkpoint
    (shard-major under whatever geometry wrote them — their positions
    are discarded; only occupancy matters).  Each occupied key re-runs
    the insert probe under ``plan`` and lands in its earliest free
    candidate row, so a subsequent lookup finds it at match priority
    exactly as if the flow had inserted live.  Returns
    ``(key, state, dropped)`` where ``dropped`` counts rows whose whole
    probe sequence was taken by other restored keys — possible only
    near capacity (a restore into a SMALLER table); fail-open, counted,
    never silent.

    Vectorized: ``probes`` passes over all rows (argsort per pass), so
    a 4M-row reshard is numpy-speed, not a Python loop.
    """
    key = np.asarray(key, np.uint32)
    state = np.asarray(state, np.float32)
    occ = np.flatnonzero(key != 0)
    new_key = np.zeros((plan.capacity,), np.uint32)
    new_state = np.zeros((plan.capacity, NUM_TABLE_COLS),
                         np.float32)
    if not len(occ):
        return new_key, new_state, 0
    k_occ = key[occ]
    st_occ = state[occ]
    dropped = _probe_insert(k_occ, st_occ, new_key, new_state, plan)
    return new_key, new_state, dropped


def _probe_insert(
    k_occ: np.ndarray,
    st_occ: np.ndarray,
    new_key: np.ndarray,
    new_state: np.ndarray,
    plan: TablePlan,
) -> int:
    """Probe-insert ``(k_occ, st_occ)`` into ``new_key``/``new_state``
    IN PLACE (rows whose ``new_key`` is nonzero are occupied and
    skipped over, exactly like the device probe).  Returns the dropped
    count — keys whose whole probe sequence was taken.  Shared by
    :func:`reshard_rows` (empty target) and :func:`insert_rows`
    (populated target)."""
    cand = _global_candidates(k_occ, plan)          # [R, P]
    placed = np.zeros(len(k_occ), bool)
    taken = new_key != 0
    for p in range(plan.probes):
        idx = np.flatnonzero(~placed)
        if not len(idx):
            break
        c = cand[idx, p]
        free = ~taken[c]
        idx, c = idx[free], c[free]
        # one winner per contested slot: stable sort by slot keeps the
        # first (lowest original row) — deterministic across runs
        order = np.argsort(c, kind="stable")
        c_s, idx_s = c[order], idx[order]
        head = np.ones(len(c_s), bool)
        head[1:] = c_s[1:] != c_s[:-1]
        slots_w, rows_w = c_s[head], idx_s[head]
        new_key[slots_w] = k_occ[rows_w]
        new_state[slots_w] = st_occ[rows_w]
        taken[slots_w] = True
        placed[rows_w] = True
    return int(np.sum(~placed))


def insert_rows(
    key: np.ndarray,
    state: np.ndarray,
    add_keys: np.ndarray,
    add_states: np.ndarray,
    plan: TablePlan,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Probe-insert foreign rows into an EXISTING table, the twin of
    :func:`reshard_rows` for a populated target (the reference adopts
    handed-off rows with it): every live row stays where it is, and each
    adopted key runs the insert probe over the remaining free slots,
    landing where a live insert would have.  An adopted key already in
    the table is dropped and counted rather than overwriting live
    state.  Returns ``(key, state, dropped)`` on
    fresh host arrays."""
    key = np.asarray(key, np.uint32).copy()
    state = np.asarray(state, np.float32).copy()
    add_keys = np.asarray(add_keys, np.uint32).reshape(-1)
    add_states = np.asarray(add_states, np.float32).reshape(
        len(add_keys), NUM_TABLE_COLS)
    live = add_keys != 0
    present = np.isin(add_keys, key[key != 0])
    sel = live & ~present
    dropped = int(np.sum(live & present))
    if np.any(sel):
        dropped += _probe_insert(add_keys[sel], add_states[sel],
                                 key, state, plan)
    return key, state, dropped
