"""The port's table summary (plain version of the ``table_summary``
kernel) against the reference's Pallas kernel (interpret mode) and its
XLA twin, on the reference test's cases and on capacities that are no
multiple of the Pallas chunk."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flowsentryx_tpu.core import schema as jschema
from flowsentryx_tpu.ops import pallas_kernels as pk
from flowsentryx_tpu_torch.core import schema
from flowsentryx_tpu_torch.ops import kernels


def _fill(rng, cap, n_fill, n_blocked):
    key = np.zeros(cap, np.uint32)
    slots = rng.choice(cap, n_fill, replace=False)
    key[slots] = rng.integers(1, 1 << 32, n_fill, dtype=np.uint64)
    state = np.zeros((cap, jschema.NUM_TABLE_COLS), np.float32)
    state[slots, int(jschema.TableCol.LAST_SEEN)] = rng.uniform(0, 100, n_fill)
    state[slots[:n_blocked], int(jschema.TableCol.BLOCKED_UNTIL)] = (
        rng.uniform(80, 200, n_blocked))
    # rows the summary must ignore: untracked but with state
    state[key == 0, int(jschema.TableCol.BLOCKED_UNTIL)] = 500.0
    return key, state


def _port(key, state, now, stale_s):
    counts, newest = kernels.table_summary_counts(
        torch.from_numpy(key.view(np.int32)), torch.from_numpy(state),
        now, stale_s)
    return counts.numpy(), np.float32(newest)


def _ref(key, state, now, stale_s, use_pallas):
    c, n = pk._table_summary(jnp.asarray(key), jnp.asarray(state),
                             jnp.float32(now), stale_s,
                             use_pallas=use_pallas)
    return np.asarray(c), np.float32(n)


@pytest.mark.parametrize("cap,n_fill,n_blocked", [
    (4096, 600, 200), (8192, 900, 300), (2048, 0, 0), (8192, 8192, 4000),
])
def test_matches_pallas_interpret_and_xla(rng, cap, n_fill, n_blocked):
    key, state = _fill(rng, cap, n_fill, n_blocked)
    now, stale_s = 90.0, 30.0
    got_c, got_n = _port(key, state, now, stale_s)
    for use_pallas in (True, False):
        want_c, want_n = _ref(key, state, now, stale_s, use_pallas)
        np.testing.assert_array_equal(got_c, want_c)
        assert got_n.view(np.uint32) == want_n.view(np.uint32)


@pytest.mark.parametrize("cap", [512, 1000, 3000, 4097])
def test_any_capacity_matches_xla_twin(rng, cap):
    """The port's kernel takes any N (no misaligned-capacity branch);
    the reference's XLA twin is the oracle where Pallas cannot run."""
    key, state = _fill(rng, cap, cap // 3, cap // 9)
    got_c, got_n = _port(key, state, 60.0, 30.0)
    want_c, want_n = _ref(key, state, 60.0, 30.0, use_pallas=False)
    np.testing.assert_array_equal(got_c, want_c)
    assert got_n.view(np.uint32) == want_n.view(np.uint32)


def test_report_dict_matches_reference(rng):
    key, state = _fill(rng, 4096, 700, 100)
    t = schema.table_from_numpy(key, state)
    jt = jschema.IpTableState(key=jnp.asarray(key), state=jnp.asarray(state))
    assert kernels.table_summary(t, now=90.0, stale_s=30.0) == \
        pk.table_summary(jt, now=90.0, stale_s=30.0)
    assert kernels.table_summary(schema.make_table(2048), now=5.0) == {
        "tracked": 0, "blocked": 0, "stale": 0, "newest_seen_s": 0.0}



def _kernel_tiling_model(key, state, now, stale_s):
    """``csrc/table_summary.cu``'s tiling written out in numpy: warp steps
    of two 128-row tiles; lane ``l`` reads the keys of rows ``4l..4l+3``
    of a tile, four ballots spread the tracked bits, and lane ``l`` then
    loads the state of rows ``32 i + l`` whose bit ``8 i + l // 4`` is set
    in the ballot of component ``l % 4``.  Returns what the kernel sums,
    and how often each row's state was read."""
    n = key.shape[0]
    f = np.float32
    now, stale_s = f(now), f(stale_s)
    lanes = np.arange(32)
    reads = np.zeros(n, np.int64)
    tracked = blocked = stale = 0
    newest = f(0)
    for tile in range(0, n, 128):
        rows = tile + 4 * lanes[:, None] + np.arange(4)         # [lane, c]
        k = np.where(rows < n, key[np.minimum(rows, n - 1)], 0)
        tracked += int((k != 0).sum())
        ballots = [int(((k[:, c] != 0).astype(np.int64) << lanes).sum())
                   for c in range(4)]
        for i in range(4):
            bit = np.array([(ballots[l % 4] >> (8 * i + l // 4)) & 1
                            for l in lanes], bool)
            row = tile + 32 * i + lanes[bit]
            reads[row] += 1
            seen = state[row, int(jschema.TableCol.LAST_SEEN)]
            until = state[row, int(jschema.TableCol.BLOCKED_UNTIL)]
            blocked += int((until > now).sum())
            stale += int((f(now) - seen > stale_s).sum())
            newest = max(newest, seen.max(initial=f(0)))
    return np.array([tracked, blocked, stale]), f(newest), reads


@pytest.mark.parametrize("cap,n_fill", [(1, 1), (255, 90), (4097, 2000),
                                        (8192, 40)])
def test_kernel_tiling_reads_each_tracked_row_once(rng, cap, n_fill):
    """The kernel's lane layout reads the state of every tracked row
    exactly once and of no other row, at any N, and sums the reference's
    answer."""
    key, state = _fill(rng, cap, n_fill, n_fill // 3)
    counts, newest, reads = _kernel_tiling_model(key, state, 90.0, 30.0)
    np.testing.assert_array_equal(reads, (key != 0).astype(np.int64))
    want_c, want_n = _ref(key, state, 90.0, 30.0, use_pallas=False)
    np.testing.assert_array_equal(counts, want_c)
    assert newest.view(np.uint32) == want_n.view(np.uint32)
