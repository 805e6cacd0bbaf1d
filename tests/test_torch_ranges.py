"""``fsx ranges`` of the port: its interval algebra against the
reference's, each aten handler's soundness on concrete operands, the
wire seeds against the reference's, the planted negative controls in
both packages, and the proof over every staged variant.

The reference's ``ranges/interval.py`` is pure numpy and is imported
here only; its prover cannot serve as an oracle for the variants on this
jax (it does not descend into nested ``jit`` equations), so the port's
variant proof stands on its own: clean, with every ``WRAP_OK`` entry
matched and nothing unmodeled.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from flowsentryx_tpu.ranges import interval as jiv
from flowsentryx_tpu.ranges import runner as jrunner
from flowsentryx_tpu.ranges import seeds as jseeds
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.audit import graph
from flowsentryx_tpu_torch.core.config import BatchConfig, FsxConfig, TableConfig
from flowsentryx_tpu_torch.core.device import as_i32
from flowsentryx_tpu_torch.parallel import make_mesh
from flowsentryx_tpu_torch.ranges import interval as iv
from flowsentryx_tpu_torch.ranges import prover, registry, runner, seeds

CAP, B, K = 1 << 12, 256, 64
CFG = FsxConfig(table=TableConfig(capacity=CAP),
                batch=BatchConfig(max_batch=B, verdict_k=K))
I64 = (-(1 << 63), (1 << 63) - 1)


@pytest.fixture(scope="module")
def report():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield runner.run_ranges(CFG, mesh=make_mesh(4, devices=["cpu"] * 4),
                                mega_n=2, device_loop=2, device="cpu")
    finally:
        torch.set_num_threads(prev)


# -- the interval algebra equals the reference's ----------------------------

ints = st.integers(-(1 << 70), 1 << 70)
small = st.integers(0, 70)


@st.composite
def ivals(draw, lo=-(1 << 70), hi=1 << 70):
    a, b = draw(st.integers(lo, hi)), draw(st.integers(lo, hi))
    return min(a, b), max(a, b)


def _same(f_port, f_ref, *args):
    p = f_port(*(iv.scalar(*a) if isinstance(a, tuple) else a
                 for a in args))
    r = f_ref(*(jiv.scalar(*a) if isinstance(a, tuple) else a
                for a in args))
    assert p.bounds() == r.bounds()


@settings(max_examples=60, deadline=None, database=None)
@given(ivals(), ivals())
def test_binary_ops_equal_reference(a, b):
    for name in ("add", "sub", "mul", "join", "vmin", "vmax"):
        _same(getattr(iv, name), getattr(jiv, name), a, b)
    for dt in (np.int64, np.int32, np.uint32):
        _same(lambda x, y: iv.div(x, y, dt), lambda x, y: jiv.div(x, y, dt),
              a, b)
        _same(lambda x, y: iv.rem(x, y, dt), lambda x, y: jiv.rem(x, y, dt),
              a, b)
        _same(lambda x, y: iv.bit_and(x, y, dt),
              lambda x, y: jiv.bit_and(x, y, dt), a, b)
        for is_or in (True, False):
            _same(lambda x, y: iv.bit_or_xor(x, y, dt, is_or),
                  lambda x, y: jiv.bit_or_xor(x, y, dt, is_or), a, b)


@settings(max_examples=60, deadline=None, database=None)
@given(ivals(), ivals(0, 70), st.integers(0, 5))
def test_unary_and_shift_ops_equal_reference(a, s, y):
    for name in ("neg", "absolute"):
        _same(getattr(iv, name), getattr(jiv, name), a)
    _same(iv.shift_left, jiv.shift_left, a, s)
    _same(iv.shift_right_arith, jiv.shift_right_arith, a, s)
    _same(lambda x, z: iv.shift_right_logical(x, z, np.int64),
          lambda x, z: jiv.shift_right_logical(x, z, np.int64), a, s)
    _same(lambda x: iv.int_pow(x, y), lambda x: jiv.int_pow(x, y), a)
    assert iv.dtype_bounds(np.int8) == jiv.dtype_bounds(np.int8)


# -- every aten handler is sound ---------------------------------------------

#: (name, function, operand dtypes): each traced on operands drawn inside
#: their seed intervals; the concrete result must lie in the computed one.
CASES = [
    ("add", lambda a, b: a + b, (torch.int64, torch.int64)),
    ("sub", lambda a, b: a - b, (torch.int64, torch.int64)),
    ("rsub", lambda a, b: 7 - a, (torch.int64, torch.int64)),
    ("mul", lambda a, b: a * b, (torch.int64, torch.int64)),
    ("neg_abs", lambda a, b: (-a).abs(), (torch.int64, torch.int64)),
    ("lshift", lambda a, b: (a & 0xFFFF) << 7, (torch.int64, torch.int64)),
    ("rshift", lambda a, b: a >> 5, (torch.int64, torch.int64)),
    ("and_or_xor", lambda a, b: ((a & 0xFF) | (b & 0xF0)) ^ (a & 3),
     (torch.int64, torch.int64)),
    ("and_signed", lambda a, b: a & b, (torch.int32, torch.int32)),
    ("not", lambda a, b: ~a, (torch.int64, torch.int64)),
    ("mod", lambda a, b: a % 8, (torch.int64, torch.int64)),
    ("floordiv", lambda a, b: torch.div(a, 3, rounding_mode="floor"),
     (torch.int64, torch.int64)),
    ("clamp", lambda a, b: torch.clamp(a, -5, 9), (torch.int64, torch.int64)),
    ("where_fold", lambda a, b: as_i32(a & 0xFFFFFFFF),
     (torch.int64, torch.int64)),
    ("where", lambda a, b: torch.where(a > b, a, b), (torch.int64, torch.int64)),
    ("sum", lambda a, b: a.sum(), (torch.int64, torch.int64)),
    ("sum_dim", lambda a, b: torch.stack([a, b]).sum(0),
     (torch.int64, torch.int64)),
    ("cumsum", lambda a, b: torch.cumsum(a, 0), (torch.int64, torch.int64)),
    ("index_add", lambda a, b: torch.zeros(8, dtype=torch.int64).index_add_(
        0, (b & 7), a), (torch.int64, torch.int64)),
    ("scatter_sum", lambda a, b: torch.zeros(8, dtype=torch.int64)
     .scatter_reduce_(0, b & 7, a, "sum"), (torch.int64, torch.int64)),
    ("scatter_amax", lambda a, b: torch.full((8,), -3, dtype=torch.int64)
     .scatter_reduce_(0, b & 7, a, "amax", include_self=False),
     (torch.int64, torch.int64)),
    ("index_put", lambda a, b: torch.zeros(8, dtype=torch.int64).index_put_(
        (b & 7,), a), (torch.int64, torch.int64)),
    ("bincount", lambda a, b: torch.bincount(a & 15),
     (torch.int64, torch.int64)),
    ("narrow", lambda a, b: (a & 0xFF).to(torch.uint8).long() + 1,
     (torch.int64, torch.int64)),
    ("convert_float", lambda a, b: torch.floor(a.float() * 0.5).long(),
     (torch.int64, torch.int64)),
    ("cat_select", lambda a, b: torch.cat([a[:2], b[1:3]])[1:3].sum(),
     (torch.int64, torch.int64)),
    ("sort_cummax", lambda a, b: torch.cummax(torch.sort(a).values, 0)
     .values + torch.sort(a).indices, (torch.int64, torch.int64)),
    ("empty_scatter", lambda a, b: torch.empty_like(a).scatter_(
        0, torch.sort(b).indices, a) - 1, (torch.int64, torch.int64)),
    ("foreach_add", lambda a, b: _foreach(a, b), (torch.int64, torch.int64)),
]


def _foreach(a, b):
    acc = [torch.zeros((), dtype=torch.int64), torch.ones((), dtype=torch.int64)]
    torch._foreach_add_(acc, [a.sum(), b.max()])
    return acc[0] + acc[1]


@pytest.mark.parametrize("name,fn,dts", CASES, ids=[c[0] for c in CASES])
def test_handler_is_sound(name, fn, dts):
    rng = np.random.default_rng(abs(hash(name)) % (1 << 31))
    for _ in range(6):
        bounds = []
        args = []
        for dt in dts:
            info = torch.iinfo(dt)
            lo = int(rng.integers(info.min // 4, info.max // 4))
            hi = lo + int(rng.integers(0, 1 << int(rng.integers(1, 40))))
            hi = min(hi, info.max)
            bounds.append((lo, hi))
            args.append(torch.from_numpy(rng.integers(
                lo, hi, 8, endpoint=True)).to(dt))
        tr, got = graph.trace_call(fn, tuple(args), ("a", "b"))
        an = prover.analyze(tr, {"a": iv.scalar(*bounds[0]),
                                 "b": iv.scalar(*bounds[1])})
        lo, hi = an.outputs["out"]
        vals = got.double() if got.dtype.is_floating_point else got
        assert lo <= vals.min().item() and vals.max().item() <= hi, (
            name, bounds, (lo, hi), got)
        assert "uninitialized" not in an.unmodeled


def test_where_refinement_proves_the_fold_and_catches_a_wide_input():
    def fold(a):
        return as_i32(a)
    tr, _ = graph.trace_call(fold, (torch.zeros(4, dtype=torch.int64),),
                             ("a",))
    assert prover.analyze(tr, {"a": iv.scalar(0, (1 << 32) - 1)}).ok
    an = prover.analyze(tr, {"a": iv.scalar(0, 1 << 33)})
    assert not an.ok and "narrowing convert" in an.findings[0].reason


def test_counters_are_proved_inside_int64():
    """The reference pairs u32 words and lets them wrap ("stat-carry-add");
    the port's int64 counters are seeded up to RANGE_STAT_MAX and the
    step's adds must provably stay inside int64 -- and a counter seeded
    at int64's top would escape."""
    from flowsentryx_tpu_torch.audit.runner import stage_variants

    (sv,), _, _ = stage_variants(CFG, variants=("compact",), device="cpu")
    tr, _ = graph.trace_call(sv.fn, sv.make_args(),
                             ("table", "stats", "params"))
    good = runner._seeds_for(tr, sv.wire, B)
    assert good["stats.allowed"].bounds() == (0, 1 << 54)
    assert prover.analyze(tr, good).ok
    bad = dict(good, **{"stats.allowed": iv.scalar(*I64)})
    an = prover.analyze(tr, bad)
    assert not an.ok
    assert "_foreach_add_" in an.findings[0].where


# -- the seeds ---------------------------------------------------------------


@pytest.mark.parametrize("shape,wire", [
    ((B + 1, 4), "compact16"), ((2, B + 1, 4), "compact16"),
    ((B + 1, 12), "raw48"), ((2, 2, B + 1, 4), "compact16")])
def test_wire_seeds_equal_reference(shape, wire):
    p = seeds.wire_seed(shape, wire, B)
    r = jseeds.wire_seed(shape, wire, B)
    assert p.lo.shape == r.lo.shape
    assert np.array_equal(p.lo, r.lo) and np.array_equal(p.hi, r.hi)
    bits = seeds.as_bit_patterns(p)
    lo, hi = bits.bounds()
    assert lo >= -(1 << 31) and hi < 1 << 31
    assert bits.hi[..., B, 0].max() == B       # n_valid keeps its bound


def test_param_seeds_equal_reference():
    assert seeds.PARAM_LEAF_RANGES == jseeds.PARAM_LEAF_RANGES
    assert seeds.param_seed("params.in_zp", np.int32).bounds() == (0, 255)


# -- negatives, registry, variants ------------------------------------------


def test_negative_controls_fire_in_both_packages():
    port, ref = runner.negative_controls(), jrunner.negative_controls()
    assert port["ok"] and ref["ok"]
    assert all(v["fired"] for k, v in port.items() if k != "ok")
    assert len(port) == len(ref)


def test_every_variant_proves_clean(report):
    assert report.ok, [str(f) for v in report.variants for f in v.findings]
    assert [v.name for v in report.variants] == [
        "raw", "compact", "sharded", "megastep", "sharded_megastep",
        "device_loop@2x2", "sharded_device_loop@2x2"]
    for v in report.variants:
        assert v.unmodeled == {}, (v.name, v.unmodeled)
        assert v.n_checked > 100, v.name


def test_every_wrap_ok_and_allowlist_entry_matches(report):
    assert not report.registry_findings
    total = {}
    for v in report.variants:
        for k, n in v.wrap_ok_matches.items():
            total[k] = total.get(k, 0) + n
    assert set(total) == {e.name for e in registry.WRAP_OK}
    assert set(registry.REFERENCE_COUNTERPARTS) == {
        "hash-avalanche", "probe-ring-walk", "stat-carry-add",
        "raw-ts-rebase"}


def test_stale_registry_entries_are_findings():
    e = registry.WrapOk("unused", "flowsentryx_tpu_torch/core/device.py",
                        "fma32", frozenset({"add"}), "planted")
    f = registry.audit_registry((e,), {})
    assert f and "matched no node" in f[0].reason


def test_cli_ranges_exit_code(capsys):
    assert cli.main(["ranges", "--quick", "--mega", "0",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "fsx ranges: compact: OK" in out
    assert "negative controls: all fire" in out
    assert out.rstrip().endswith("fsx ranges: PASS")


