"""The port's host-ingest stress harness (``flowsentryx_tpu_torch/
shm_stress.py``) against the reference's ``scripts/shm_stress.py``,
loaded by path (nothing of it is edited; its capacity is set through its
``TableConfig`` name at test time).

(a) two ``fsxd --sim --packets N --seed 7`` runs with no pacing, into
    rings larger than N, write byte-equal records;
(b) on such a pre-filled ring, the daemon exited before the engine
    starts, the port's ``get_engine``/``phase_engine`` on the CPU at 2^12
    rows and B=256 gives the reference engine's stats, blocked sources
    and verdict-ring records;
(c) ``phase_inline_host`` seals the reference's batches (count, bytes);
(d) ``phase_sharded`` with 2 workers, paced low for ~1.5 s, is lossless
    with ``records == produced`` in both packages;
(e) every phase's report keys are the reference's, and each mode's
    report's keys are the reference's plus ``ADDED_KEYS``;
(f) the module's spawn import closure has no torch (nor jax);
(g) a run writes its ``--out`` file and nothing else: the reference's
    two SHMSTRESS files stay byte-identical.
"""

import ast
import hashlib
import importlib.util
import json
import os
import platform
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from flowsentryx_tpu.core.config import TableConfig as JTableConfig
from flowsentryx_tpu.engine import batcher as jbatcher
from flowsentryx_tpu.engine import shm as jshm
from flowsentryx_tpu_torch import shm_stress as ss
from flowsentryx_tpu_torch.core import wire
from flowsentryx_tpu_torch.engine import batcher, shm

REPO = Path(__file__).resolve().parents[1]
REF_SCRIPT = REPO / "scripts" / "shm_stress.py"
REF_FILES = (REPO / "SHMSTRESS_r05.json",
             REPO / "artifacts" / "SHMSTRESS_sharded_r06.json")
#: records of the pre-filled rings, and their capacity (a power of two
#: larger than N, so the daemon drops nothing); half of the records from
#: 8 attack sources, so the rate limiter blocks them within N
N_RECORDS, RING_CAP = 20_000, 1 << 15
CAP, B = 1 << 12, 256

pytestmark = pytest.mark.skipif(
    platform.machine() not in ("x86_64", "AMD64")
    or platform.system() != "Linux",
    reason="shm rings need x86-TSO and CLOCK_MONOTONIC (Linux)")


def _digests() -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in REF_FILES}


@pytest.fixture(scope="module")
def ref():
    """The reference's script, loaded by path; its files' digests are
    taken before any test runs and checked when the module ends."""
    before = _digests()
    spec = importlib.util.spec_from_file_location("ref_shm_stress",
                                                  REF_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    yield mod
    assert _digests() == before


@pytest.fixture(scope="module")
def fsxd(ref):
    r = subprocess.run(["make", "-C", str(REPO / "daemon")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert ss.FSXD.exists() and ref.FSXD == ss.FSXD
    return ss.FSXD


def _prefill(fsxd, root: Path, tag: str) -> subprocess.Popen:
    """``fsxd --sim --packets N`` with no pacing: it writes N records,
    waits (bounded, 3 s) for a consumer that never comes, and exits."""
    return subprocess.Popen(
        [str(fsxd), "--sim", "--packets", str(N_RECORDS), "--rate", "1e6",
         "--attack-fraction", "0.5", "--attack-ips", "8",
         "--benign-ips", "1024", "--seed", "7",
         "--ring-capacity", str(RING_CAP),
         "--feature-ring", str(root / f"{tag}.fring"),
         "--verdict-ring", str(root / f"{tag}.vring")],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


@pytest.fixture(scope="module")
def prefilled(fsxd, tmp_path_factory):
    """Two pre-filled rings of the same daemon run, written side by side;
    ``(root, the daemon's closing line)``."""
    root = tmp_path_factory.mktemp("prefilled")
    procs = [_prefill(fsxd, root, t) for t in ("a", "b")]
    outs = [p.communicate(timeout=60)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs)
    return root, outs[0]


class _Exited:
    """A daemon that already ran: its closing line and no process."""

    def __init__(self, out: str):
        self.out = out

    def communicate(self, timeout=None):
        return self.out, None

    def terminate(self):
        pass

    def poll(self):
        return 0


def _from_prefilled(prefilled, vrings: list):
    """A ``start_daemon`` stand-in: copies the pre-filled ring ``a`` to
    the paths asked for and maps the verdict ring (the mapping outlives
    the harness's temporary directory)."""
    root, out = prefilled

    def start(fring, vring, *a, **k):
        shutil.copy(root / "a.fring", fring)
        shutil.copy(root / "a.vring", vring)
        vrings.append(shm.ShmRing(vring, wire.VERDICT_RECORD_DTYPE))
        return _Exited(out)

    return start


def _ring_records(path: Path, tmp: Path):
    dst = tmp / path.name
    shutil.copy(path, dst)
    return shm.ShmRing(dst, wire.FLOW_RECORD_DTYPE).consume(1 << 20)


# ---------------------------------------------------------------------------
# (a) the daemon's records
# ---------------------------------------------------------------------------


def test_two_unpaced_sim_runs_write_equal_records(prefilled, tmp_path):
    root, out = prefilled
    a = _ring_records(root / "a.fring", tmp_path)
    b = _ring_records(root / "b.fring", tmp_path)
    assert len(a) == len(b) == N_RECORDS
    assert a.tobytes() == b.tobytes()
    d = json.loads(out.strip().splitlines()[-1])
    assert d["produced"] == N_RECORDS and d["dropped_ring_full"] == 0


# ---------------------------------------------------------------------------
# (b) the engine rows
# ---------------------------------------------------------------------------


def _padded_stages(get_engine):
    """The reference's ``get_engine`` whose engine's reports give every
    stage a ``p50`` and ``p99``: its ``phase_engine`` reads both from
    each stage, and its engine reports a stage that saw no batch (the
    inline path's ``pop``) as ``{}`` (ROADMAP queue 3, item 38)."""
    def get(*a, **k):
        eng, ckpt = get_engine(*a, **k)
        if not getattr(eng.run, "padded", False):
            run = eng.run

            def padded(*ra, **rk):
                rep = run(*ra, **rk)
                return rep._replace(stages_ms={
                    k: {"p50": None, "p99": None, **v}
                    for k, v in rep.stages_ms.items()})

            padded.padded = True
            eng.run = padded
        return eng, ckpt

    return get


@pytest.fixture(scope="module")
def engine_rows(ref, prefilled):
    """``phase_engine`` over the pre-filled ring in both packages: each
    row, and the records its engine wrote to the verdict ring.  The ring
    source of a producer that has exited is exhausted once the ring is
    empty, so each run ends when it has served every record (60 s at
    most) rather than at a wall-clock bound."""
    mp = pytest.MonkeyPatch()
    got = {}
    try:
        for cls in (shm.ShmRingSource, jshm.ShmRingSource):
            mp.setattr(cls, "exhausted",
                       lambda self: self.ring.readable() == 0)
        for name, mod, kw in (("port", ss, dict(device="cpu", capacity=CAP)),
                              ("reference", ref, {})):
            vrings = []
            mp.setattr(mod, "start_daemon", _from_prefilled(prefilled,
                                                            vrings))
            if mod is ref:
                mp.setattr(ref, "TableConfig",
                           lambda capacity: JTableConfig(capacity=CAP))
                mp.setattr(ref, "get_engine",
                           _padded_stages(ref.get_engine))
            row = mod.phase_engine(60.0, 0.5, B, "prefilled", 1e6, **kw)
            got[name] = (row, vrings[0].consume(1 << 16))
    finally:
        mp.undo()
    yield got
    ss.close_engines()


def test_engine_row_equals_reference(engine_rows):
    (row, verdicts), (jrow, jverdicts) = (engine_rows["port"],
                                          engine_rows["reference"])
    assert row["engine_records"] == jrow["engine_records"] == N_RECORDS
    assert row["stats"] == jrow["stats"]
    assert row["blocked_sources"] == jrow["blocked_sources"] > 0
    assert len(verdicts) > 0
    assert verdicts.tobytes() == jverdicts.tobytes()
    assert row["wire"] == jrow["wire"] == "compact16"
    assert row["daemon"] == jrow["daemon"]


def test_get_engine_is_cached_and_restored(engine_rows):
    """The row's engine is the cached one, built at the asked capacity
    on the asked device, and restoring its checkpoint empties it."""
    eng, ckpt = ss.get_engine(B, 0, device="cpu", capacity=CAP)
    assert ss.get_engine(B, 0, device="cpu", capacity=CAP)[0] is eng
    assert eng.cfg.table.capacity == CAP and eng.device.type == "cpu"
    assert eng.cfg.batch.deadline_us == 10_000
    assert (eng.cfg.model.vote_k, eng.cfg.model.vote_m) == (4, 2)
    assert eng.readback_depth == 8
    eng.restore(ckpt)
    assert int((eng.table.key != 0).sum()) == 0


# ---------------------------------------------------------------------------
# (c) the inline host stage
# ---------------------------------------------------------------------------


def _capturing(cls, sealed: list):
    class Capturing(cls):
        def add(self, *a, **k):
            out = super().add(*a, **k)
            sealed.extend(hashlib.sha256(b.tobytes()).hexdigest()
                          for b in out)
            return out

    return Capturing


def test_inline_host_seals_the_reference_batches(ref, prefilled,
                                                  monkeypatch):
    got = {}
    for name, mod, bmod in (("port", ss, batcher),
                            ("reference", ref, jbatcher)):
        sealed = []
        monkeypatch.setattr(mod, "start_daemon",
                            _from_prefilled(prefilled, []))
        monkeypatch.setattr(bmod, "MicroBatcher",
                            _capturing(bmod.MicroBatcher, sealed))
        got[name] = (mod.phase_inline_host(1.5, max_batch=1024), sealed)
    (row, sealed), (jrow, jsealed) = got["port"], got["reference"]
    assert row["records"] == jrow["records"] == N_RECORDS
    assert row["batches_sealed"] == jrow["batches_sealed"] == len(sealed)
    assert len(sealed) == N_RECORDS // 1024
    assert sealed == jsealed
    assert set(row) == set(jrow)


# ---------------------------------------------------------------------------
# (d) the sharded subsystem
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sharded_rows(ref, fsxd):
    return {name: mod.phase_sharded(1.5, 2, 2e5, pace=True, max_batch=1024)
            for name, mod in (("port", ss), ("reference", ref))}


@pytest.mark.parametrize("name", ["port", "reference"])
def test_sharded_paced_low_is_lossless(sharded_rows, name):
    row = sharded_rows[name]
    assert row["lossless"], row
    assert row["records"] == row["produced"] > 0
    assert row["dropped_ring_full"] == row["seq_gaps"] == 0
    assert row["n_workers"] == 2 and row["paced"]
    assert row["label"] == "sharded_w2_paced"


# ---------------------------------------------------------------------------
# (e) the report keys
# ---------------------------------------------------------------------------


def test_drain_keys_equal_reference(ref, fsxd):
    row, jrow = ss.phase_drain(0.3), ref.phase_drain(0.3)
    assert set(row) == set(jrow)
    assert row["records_drained"] > 0 and row["polls"] > 0


def test_phase_keys_equal_reference(engine_rows, sharded_rows):
    for name in ("engine", "sharded"):
        rows = engine_rows if name == "engine" else sharded_rows
        port = rows["port"][0] if name == "engine" else rows["port"]
        want = (rows["reference"][0] if name == "engine"
                else rows["reference"])
        assert set(port) == set(want), name
    assert set(engine_rows["port"][0]["stages_ms"]) >= {"fill", "dispatch"}


def _ref_report_keys(fn_name: str) -> tuple[set, set]:
    """The keys the reference's ``fn_name`` gives its report (``out =
    {...}`` and ``out[...] = ...``) and its headline's literal keys."""
    tree = ast.parse(REF_SCRIPT.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == fn_name)
    keys, head = set(), set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        t = node.targets[0]
        if isinstance(t, ast.Name) and t.id == "out" \
                and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys}
        elif (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
              and t.value.id == "out"):
            keys.add(t.slice.value)
            if t.slice.value == "headline":
                head = {k.value for k in node.value.keys}
    return keys, head


def _stub_phases(monkeypatch, engine_rows, sharded_rows):
    row = engine_rows["port"][0]
    monkeypatch.setattr(ss, "phase_drain", lambda d: {"drain_mpps": 1.0})
    monkeypatch.setattr(ss, "phase_engine", lambda *a, **k: dict(row))
    monkeypatch.setattr(ss, "phase_inline_host", lambda *a, **k: {"mpps": 1.0})
    monkeypatch.setattr(ss, "phase_sharded",
                        lambda *a, **k: dict(sharded_rows["port"]))


@pytest.mark.parametrize("mode", ["default", "sharded"])
def test_mode_report_keys_equal_reference(mode, engine_rows, sharded_rows,
                                          monkeypatch, tmp_path, fsxd,
                                          capsys):
    """Each mode's report: the reference's keys plus ``ADDED_KEYS``,
    headline printed as the one line on stdout (the phases stubbed)."""
    _stub_phases(monkeypatch, engine_rows, sharded_rows)
    out = tmp_path / "report.json"
    argv = ["--device", "cpu", "--out", str(out)]
    if mode == "sharded":
        argv = ["--shards", "2", *argv]
    assert ss.main(argv) == 0
    line = capsys.readouterr().out.strip()
    rep = json.loads(out.read_text())
    keys, head = _ref_report_keys("main" if mode == "default"
                                  else "run_sharded_suite")
    assert set(rep) == keys | set(ss.ADDED_KEYS)
    assert rep["device_kind"] == "cpu" and rep["power_limit_w"] is None
    assert set(rep["headline"]) == head
    assert json.loads(line) == rep["headline"]
    if mode == "default":
        assert len(rep["engine_rows"]) == len(ss.ENGINE_ROWS) == 9


def test_engine_rows_are_the_reference_rows():
    """The default mode's nine rows: the reference's labels, batch sizes,
    grouping, pacing and offered rates, in its order."""
    tree = ast.parse(REF_SCRIPT.read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == "main")
    calls = [n for n in ast.walk(main) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "phase_engine"]
    want = []
    for c in sorted(calls, key=lambda n: (n.lineno, n.col_offset)):
        args = [ast.literal_eval(a) if not isinstance(a, ast.Name) else None
                for a in c.args]
        kw = {k.arg: ast.literal_eval(k.value) for k in c.keywords}
        want.append((args[1], args[2], args[3], args[4],
                     kw.get("pace", False), kw.get("mega_n", 0)))
    assert tuple(want) == ss.ENGINE_ROWS


# ---------------------------------------------------------------------------
# (f) the import closure; (g) what a run writes
# ---------------------------------------------------------------------------


def test_spawn_import_closure_has_no_torch():
    """A spawned drain worker re-imports the harness as ``__mp_main__``:
    neither that nor a plain import pulls in torch, jax or the
    reference package."""
    code = ("import runpy, sys\n"
            "import flowsentryx_tpu_torch.shm_stress\n"
            "runpy.run_module('flowsentryx_tpu_torch.shm_stress', "
            "run_name='__mp_main__')\n"
            "import flowsentryx_tpu_torch.ingest.worker\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'flowsentryx_tpu')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_sharded_run_writes_only_its_out_file(fsxd, tmp_path):
    """``python -m flowsentryx_tpu_torch.shm_stress --shards 2 --device
    cpu`` at 0.5 s per row: one headline line with the reference's keys;
    the temp directory is left empty, no SHMSTRESS file appears in the
    repository and the reference's two are unchanged."""
    before = _digests()
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    named = sorted(REPO.glob("**/SHMSTRESS*"))
    out = tmp_path / "r.json"
    r = subprocess.run(
        [sys.executable, "-m", "flowsentryx_tpu_torch.shm_stress",
         "--shards", "2", "--device", "cpu", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, FSX_STRESS_DUR="0.5", TMPDIR=str(tmp)))
    assert r.returncode == 0, r.stderr[-2000:]
    [line] = r.stdout.splitlines()
    head = json.loads(line)
    assert set(head) == _ref_report_keys("run_sharded_suite")[1]
    assert json.loads(out.read_text())["headline"] == head
    assert os.listdir(tmp) == []
    assert sorted(REPO.glob("**/SHMSTRESS*")) == named
    assert _digests() == before


def test_chip_host_ingest_phase_on_the_cpu(fsxd, monkeypatch, capsys):
    """``chip_smoke.host_ingest_phase`` at 2^12 rows on the CPU, 1 s a
    row: every row served, every staged batch kept, each row's state
    equal to its CPU replay in a child process; its launch checks fail
    here (a CPU tensor runs the plain versions, which count nothing),
    and only they do."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    monkeypatch.setattr(cs, "FAILED", [])
    monkeypatch.setattr(cs, "HOST_INGEST_DUR_S", 1.0)
    served = {}
    cs.host_ingest_phase("cpu", served, device="cpu", capacity=CAP)
    [line] = [ln for ln in capsys.readouterr().out.splitlines()
              if '"phase": "host_ingest"' in ln]
    rep = json.loads(line)
    assert set(rep["rows"]) == set(cs.HOST_INGEST_ROWS)
    failed = {k for k, ok in rep["checks"].items() if not ok}
    assert failed == {f"{r}/{c}" for r in cs.HOST_INGEST_ROWS
                      for c in ("score_int8_per_batch",
                                "table_summary_per_report")}
    for label, row in rep["rows"].items():
        assert row["equal_cpu_replay"] == {
            "stats": True, "digest": True, "blacklist": True}, label
        assert row["staged_batches"] == row["batches"] > 0
        assert row["step_busy_ms_per_batch"] is None
    assert served["launches_host_ingest"].keys() == set(cs.HOST_INGEST_ROWS)
    assert not list((REPO / "build" / "host_ingest_rows").glob("*.npy"))
