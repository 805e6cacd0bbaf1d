"""The port's lint gate (``scripts/torch_lint.py``), stage by stage: the
planted cases of ``tests/test_lint.py`` carried over into the port's
terms (flagged, ``# noqa`` exempt, clean, out of scope), the stages the
reference's tests leave without one (syntax, unused imports, liveness
waits), the exit rule, and one ``test_port_tree_is_clean`` per stage.
Each planted case writes a throwaway tree and points the gate's
``REPO`` at it."""

import importlib.util
import json
import shutil
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PKG = "flowsentryx_tpu_torch"

_spec = importlib.util.spec_from_file_location(
    "fsx_torch_lint", REPO / "scripts" / "torch_lint.py")
lint = importlib.util.module_from_spec(_spec)
sys.modules["fsx_torch_lint"] = lint
_spec.loader.exec_module(lint)


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A throwaway tree the gate scans: ``plant(rel, src)`` writes a
    module into it."""
    monkeypatch.setattr(lint, "REPO", tmp_path)

    def plant(rel: str, src: str) -> Path:
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
        return p

    return plant


# ---------------------------------------------------------------------------
# 1. syntax
# ---------------------------------------------------------------------------


class TestSyntaxStage:
    def test_syntax_error_flagged(self, tree):
        tree(f"{PKG}/ops/mod.py", "def f(:\n    pass\n")
        out = lint.stage_syntax()
        assert len(out) == 1 and "mod.py:1: syntax error" in out[0]

    @pytest.mark.parametrize("rel", ["tests/test_torch_x.py",
                                     "scripts/torch_x.py", "chip_smoke.py"])
    def test_every_scope_is_compiled(self, tree, rel):
        tree(rel, "x = (\n")
        assert len(lint.stage_syntax()) == 1

    def test_clean_module_passes(self, tree):
        tree(f"{PKG}/core/mod.py", "import numpy as np\nx = np.zeros(3)\n")
        assert lint.stage_syntax() == []

    @pytest.mark.parametrize("rel", ["tests/test_lint.py", "scripts/lint.py",
                                     "flowsentryx_tpu/core/mod.py"])
    def test_outside_scope_not_scanned(self, tree, rel):
        tree(rel, "def f(:\n")
        assert lint.stage_syntax() == []

    def test_writes_nothing(self, tree, tmp_path):
        tree(f"{PKG}/core/mod.py", "x = 1\n")
        lint.stage_syntax()
        assert not list(tmp_path.rglob("__pycache__"))

    def test_port_tree_is_clean(self):
        assert lint.stage_syntax() == []


# ---------------------------------------------------------------------------
# 2. unused imports
# ---------------------------------------------------------------------------


class TestUnusedImportsStage:
    def test_unused_import_flagged(self, tree):
        tree(f"{PKG}/ops/mod.py", "import os\nimport sys\nprint(sys.argv)\n")
        out = lint.stage_unused_imports()
        assert out == [f"{PKG}/ops/mod.py:1: unused import 'os'"]

    def test_unused_from_import_flagged(self, tree):
        tree("tests/test_torch_x.py", "from typing import NamedTuple\n")
        out = lint.stage_unused_imports()
        assert len(out) == 1 and "'NamedTuple'" in out[0]

    def test_noqa_exempts(self, tree):
        tree(f"{PKG}/ops/mod.py", "import os  # noqa: F401 re-export\n")
        assert lint.stage_unused_imports() == []

    def test_all_reexport_counts_as_use(self, tree):
        tree(f"{PKG}/ops/mod.py",
             "from os import path\n__all__ = ['path']\n")
        assert lint.stage_unused_imports() == []

    def test_init_reexports_exempt(self, tree):
        tree(f"{PKG}/ops/__init__.py", "from os import path\n")
        assert lint.stage_unused_imports() == []

    def test_outside_scope_not_scanned(self, tree):
        tree("tests/test_other.py", "import os\n")
        assert lint.stage_unused_imports() == []

    def test_port_tree_is_clean(self):
        assert lint.stage_unused_imports() == []


# ---------------------------------------------------------------------------
# 3. local imports
# ---------------------------------------------------------------------------


def _local(tree, src):
    return lint._local_import_findings(tree(f"{PKG}/ops/mod.py", src))


class TestLocalImportStage:
    def test_local_torch_under_module_torch_flagged(self, tree):
        out = _local(tree, """\
            import torch.nn.functional as F

            def f():
                import torch
                return torch.zeros(1), F
            """)
        assert len(out) == 1
        assert "function-local torch import" in out[0]
        assert "mod.py:4" in out[0]

    def test_shadowing_local_import_flagged(self, tree):
        out = _local(tree, """\
            from flowsentryx_tpu_torch.core import wire

            def f():
                from flowsentryx_tpu_torch.core import wire
                return wire
            """)
        assert len(out) == 1
        assert "shadows module-level import 'wire'" in out[0]

    def test_lazy_torch_in_torch_free_module_allowed(self, tree):
        # the supervisor's idiom: a torch-free module imports torch in the
        # one function that needs it
        assert _local(tree, """\
            import json

            def serve():
                import torch
                return torch.cuda.is_available(), json
            """) == []

    def test_noqa_exempts(self, tree):
        assert _local(tree, """\
            import torch

            def f():
                import torch  # noqa: deliberate re-import
                return torch
            """) == []

    def test_nested_function_reported_once(self, tree):
        out = _local(tree, """\
            import torch

            def outer():
                def inner():
                    import torch.nn as nn
                    return nn
                return inner
            """)
        assert len(out) == 1

    def test_module_level_conditional_import_not_flagged(self, tree):
        assert _local(tree, """\
            import torch
            if hasattr(torch, "compiler"):
                from torch import compiler
            else:
                compiler = None
            """) == []

    def test_port_tree_is_clean(self):
        assert lint.stage_local_imports() == []


# ---------------------------------------------------------------------------
# 4. np default int
# ---------------------------------------------------------------------------


def _np(tree, src, rel=f"{PKG}/ops/mod.py"):
    tree(rel, src)
    return lint.stage_np_default_int()


class TestNpDefaultIntStage:
    def test_dtype_less_arange_flagged(self, tree):
        out = _np(tree, "import numpy as np\nidx = np.arange(10)\n")
        assert len(out) == 1
        assert "np.arange" in out[0] and "mod.py:2" in out[0]

    def test_dtype_less_full_flagged(self, tree):
        out = _np(tree, "import numpy as np\nproto = np.full(8, 6)\n")
        assert len(out) == 1 and "np.full" in out[0]

    def test_dtype_kwarg_clean(self, tree):
        assert _np(tree, "import numpy as np\n"
                         "idx = np.arange(10, dtype=np.int64)\n"
                         "z = np.zeros(4, dtype=np.uint32)\n") == []

    def test_positional_dtype_clean(self, tree):
        assert _np(tree, "import numpy as np\n"
                         "z = np.zeros(4, np.uint32)\n"
                         "b = np.zeros((3,), bool)\n"
                         "f = np.full(8, 6, np.uint8)\n") == []

    def test_noqa_exempts(self, tree):
        assert _np(tree, "import numpy as np\n"
                         "idx = np.arange(10)  # noqa: host-only index\n") == []

    @pytest.mark.parametrize("pkg", ["core", "fused", "engine", "ingest",
                                     "cluster"])
    def test_every_hot_path_package_scanned(self, tree, pkg):
        assert len(_np(tree, "import numpy as np\nx = np.empty(3)\n",
                       rel=f"{PKG}/{pkg}/m.py")) == 1

    def test_outside_hot_path_not_scanned(self, tree):
        assert _np(tree, "import numpy as np\nidx = np.arange(10)\n",
                   rel=f"{PKG}/train/m.py") == []

    def test_port_tree_is_clean(self):
        assert lint.stage_np_default_int() == []


# ---------------------------------------------------------------------------
# 5. captured-region purity
# ---------------------------------------------------------------------------


def _pure(tree, body, rel=f"{PKG}/fused/device_loop.py"):
    tree(rel, "import torch\n\ndef step(x):\n" + body)
    return lint.stage_captured_purity()


class TestCapturedPurityStage:
    """Host round trips in the step bodies the engine captures into CUDA
    graphs: each is a device -> host wait inside the captured region."""

    @pytest.mark.parametrize("call,name", [
        ("x.sum().item()", ".item()"), ("x.tolist()", ".tolist()"),
        ("x.cpu()", ".cpu()"), ("x.numpy()", ".numpy()"),
        ("torch.cuda.synchronize()", ".synchronize()"),
        ("torch.cuda.current_stream().synchronize()", ".synchronize()"),
        ("print(x)", "print()")])
    def test_host_round_trip_flagged(self, tree, call, name):
        out = _pure(tree, f"    return {call}\n")
        assert len(out) == 1
        assert name in out[0] and "device_loop.py:4" in out[0]

    @pytest.mark.parametrize("rel", ["ops/fused.py", "parallel/step.py"])
    def test_every_captured_module_scanned(self, tree, rel):
        assert len(_pure(tree, "    return x.item()\n",
                         rel=f"{PKG}/{rel}")) == 1

    def test_noqa_exempts(self, tree):
        assert _pure(tree, "    return x.cpu()  # noqa: host-side check, "
                           "outside the capture\n") == []

    def test_clean_captured_code_passes(self, tree):
        assert _pure(tree, "    y = torch.where(x > 0, x, 0)\n"
                           "    return y.sum(0), x.to(torch.int32)\n") == []

    def test_outside_captured_region_not_scanned(self, tree):
        assert _pure(tree, "    return x.item()\n",
                     rel=f"{PKG}/ops/kernels.py") == []

    def test_port_tree_is_clean(self):
        assert lint.stage_captured_purity() == []


# ---------------------------------------------------------------------------
# 6. sync contracts
# ---------------------------------------------------------------------------


class TestSyncContractsStage:
    def test_port_tree_is_clean(self):
        assert lint.stage_sync_contracts() == []

    def test_stage_surfaces_findings(self, tree):
        # a tree without the registered modules: every registry entry is
        # a finding, proof the stage runs the checker
        out = lint.stage_sync_contracts()
        assert out
        assert any("registered module does not exist" in f for f in out)

    def test_stage_catches_planted_discipline_violation(self, tree,
                                                        tmp_path):
        shutil.copytree(REPO / PKG, tmp_path / PKG,
                        ignore=shutil.ignore_patterns("__pycache__"))
        eng = tmp_path / PKG / "engine" / "engine.py"
        src = eng.read_text()
        needle = "    def _sink_worker(self) -> None:"
        assert needle in src
        # the sink worker touches the dispatch-owned staging counter
        eng.write_text(src.replace(
            needle, needle + "\n        self._staged_batches += 1\n", 1))
        out = lint.stage_sync_contracts()
        assert any("_staged_batches" in f and "worker" in f
                   for f in out), out


# ---------------------------------------------------------------------------
# 7. liveness waits
# ---------------------------------------------------------------------------


SCANNED = f"{PKG}/cluster/gossip.py"


class TestLivenessWaitsStage:
    def test_untimed_wait_flagged(self, tree):
        tree(SCANNED, "def park(ev):\n    ev.wait()\n")
        out = lint.stage_liveness_waits()
        assert len(out) == 1
        assert "untimed .wait()" in out[0] and "gossip.py:2" in out[0]

    def test_timed_wait_clean(self, tree):
        tree(SCANNED, "def park(ev, q):\n    ev.wait(q)\n"
                      "    ev.wait(timeout=q)\n")
        assert lint.stage_liveness_waits() == []

    def test_unregistered_spin_flagged(self, tree):
        tree(SCANNED, "class P:\n    def spin(self):\n"
                      "        while True:\n            self.poll()\n")
        out = lint.stage_liveness_waits()
        assert len(out) == 1 and "P.spin" in out[0]

    def test_sleeping_loop_clean(self, tree):
        tree(SCANNED, "import time\n\ndef loop(p):\n    while True:\n"
                      "        p.poll()\n        time.sleep(0.01)\n")
        assert lint.stage_liveness_waits() == []

    def test_registered_loop_clean(self, tree):
        # GossipPlane.tick is a PROGRESS entry: its loop may block
        assert (SCANNED, "GossipPlane.tick") in lint._import_port(
            f"{PKG}.live.registry").registered_sites()
        tree(SCANNED, "class GossipPlane:\n    def tick(self):\n"
                      "        while True:\n            self.step()\n")
        assert lint.stage_liveness_waits() == []

    def test_noqa_exempts(self, tree):
        tree(SCANNED, "def wedge(ev):\n    ev.wait()  # noqa: the fault\n")
        assert lint.stage_liveness_waits() == []

    def test_outside_scan_scope_not_scanned(self, tree):
        tree(f"{PKG}/cluster/runner.py", "def park(ev):\n    ev.wait()\n")
        assert lint.stage_liveness_waits() == []

    def test_port_tree_is_clean(self):
        assert lint.stage_liveness_waits() == []


# ---------------------------------------------------------------------------
# 8. cluster torch-free
# ---------------------------------------------------------------------------


def _cluster(tree, src):
    return lint._cluster_torch_findings(
        tree(f"{PKG}/cluster/newmod.py", src))


class TestClusterTorchFreeStage:
    """Module-level imports under cluster/ that reach torch: one puts
    torch's multi-second import on every fleet boot, adopt census and
    stub spawn."""

    def test_module_level_torch_flagged(self, tree):
        out = _cluster(tree, "import torch\n\ndef f():\n"
                             "    return torch.zeros(1)\n")
        assert len(out) == 1
        assert "module-level import of 'torch'" in out[0]
        assert "newmod.py:1" in out[0]

    def test_from_torch_submodule_flagged(self, tree):
        out = _cluster(tree, "from torch.nn import functional\n")
        assert len(out) == 1 and "'torch.nn'" in out[0]

    def test_torch_importing_port_module_flagged(self, tree):
        tree(f"{PKG}/__init__.py", "")
        tree(f"{PKG}/ops/__init__.py", "")
        tree(f"{PKG}/ops/fused.py", "import torch\n")
        out = _cluster(tree, f"from {PKG}.ops import fused\n")
        assert len(out) == 1
        assert f"{PKG}.ops.fused -> torch" in out[0]

    def test_transitive_import_flagged(self, tree):
        # engine.checkpoint imports core.schema, which imports torch
        tree(f"{PKG}/__init__.py", "")
        tree(f"{PKG}/core/__init__.py", "")
        tree(f"{PKG}/core/schema.py", "import numpy as np\nimport torch\n")
        tree(f"{PKG}/engine/__init__.py", "import importlib\n")
        tree(f"{PKG}/engine/checkpoint.py",
             f"from {PKG}.core import schema\n")
        out = _cluster(tree, f"from {PKG}.engine.checkpoint import save\n")
        assert len(out) == 1
        assert (f"{PKG}.engine.checkpoint -> {PKG}.core.schema -> torch"
                in out[0])

    def test_package_init_that_imports_torch_flagged(self, tree):
        tree(f"{PKG}/__init__.py", "")
        tree(f"{PKG}/models/__init__.py", "import torch\n")
        tree(f"{PKG}/models/registry.py", "import json\n")
        out = _cluster(tree, f"from {PKG}.models.registry import spec\n")
        assert len(out) == 1 and f"{PKG}.models -> torch" in out[0]

    def test_function_local_torch_allowed(self, tree):
        assert _cluster(tree, "def tick():\n    import torch\n"
                              "    return torch\n") == []

    def test_torch_free_port_modules_allowed(self, tree):
        tree(f"{PKG}/__init__.py", "")
        tree(f"{PKG}/engine/__init__.py", "import importlib\n")
        tree(f"{PKG}/engine/writeback.py", "import numpy as np\n")
        tree(f"{PKG}/engine/shm.py", "import mmap\nimport numpy as np\n")
        assert _cluster(tree, f"from {PKG}.engine.writeback import Sink\n"
                              f"from {PKG}.engine import shm\n") == []

    def test_type_checking_block_allowed(self, tree):
        assert _cluster(tree, "from typing import TYPE_CHECKING\n"
                              "if TYPE_CHECKING:\n    import torch\n") == []

    def test_torch_lookalike_not_flagged(self, tree):
        assert _cluster(tree, "import torchtext_free_lookalike\n") == []

    def test_noqa_exempts(self, tree):
        assert _cluster(tree, "import torch  # noqa: measured\n") == []

    def test_real_closure(self):
        memo = {}
        assert lint._reaches_torch(f"{PKG}.engine.checkpoint", memo)
        assert lint._reaches_torch(f"{PKG}.ops.fused", memo)
        assert lint._reaches_torch(f"{PKG}.engine.engine", memo)
        assert lint._reaches_torch(f"{PKG}.engine.writeback", memo) is None
        assert lint._reaches_torch(f"{PKG}.ingest", memo) is None
        assert lint._reaches_torch(f"{PKG}.sync.contracts", memo) is None

    def test_port_tree_is_clean(self):
        assert lint.stage_cluster_torch_free() == []


# ---------------------------------------------------------------------------
# 9. durable writes
# ---------------------------------------------------------------------------


def _durable(tree, src, rel=f"{PKG}/cluster/mod.py"):
    tree(rel, src)
    return lint.stage_durable_writes()


class TestDurableWritesStage:
    def test_open_write_mode_flagged(self, tree):
        out = _durable(tree, "def publish(path, data):\n"
                             "    with open(path, 'wb') as f:\n"
                             "        f.write(data)\n")
        assert len(out) == 1
        assert "open(..., 'wb')" in out[0] and "mod.py:2" in out[0]

    def test_open_mode_kwarg_flagged(self, tree):
        out = _durable(tree, "f = open('layout.json', mode='w')\n")
        assert len(out) == 1 and "open(..., 'w')" in out[0]

    def test_open_read_modes_clean(self, tree):
        assert _durable(tree, "def peek(path):\n"
                              "    with open(path, 'rb') as f:\n"
                              "        return f.read()\n"
                              "def mmap_update(path):\n"
                              "    return open(path, 'r+b')\n") == []

    def test_write_text_flagged(self, tree):
        out = _durable(tree, "from pathlib import Path\ndef save(d):\n"
                             "    Path('handoff.json').write_text(d)\n")
        assert len(out) == 1 and ".write_text(...)" in out[0]

    def test_path_targeted_savez_flagged(self, tree):
        out = _durable(tree, "import numpy as np\ndef spool(keys):\n"
                             "    np.savez_compressed('staged.npz', "
                             "keys=keys)\n")
        assert len(out) == 1 and "np.savez_compressed(<path>" in out[0]

    def test_bytesio_savez_clean(self, tree):
        assert _durable(tree, "import io\nimport numpy as np\n"
                              "from flowsentryx_tpu_torch.core import "
                              "durable\n"
                              "def save(path, keys):\n"
                              "    buf = io.BytesIO()\n"
                              "    np.savez_compressed(buf, keys=keys)\n"
                              "    durable.atomic_write(path, "
                              "buf.getvalue())\n") == []

    def test_noqa_exempts(self, tree):
        assert _durable(tree, "def mk(path):\n"
                              "    with open(path, 'wb') as f:  # noqa: "
                              "shm create\n"
                              "        f.truncate(64)\n") == []

    def test_outside_scope_not_scanned(self, tree):
        assert _durable(tree, "def save(path, d):\n"
                              "    with open(path, 'w') as f:\n"
                              "        f.write(d)\n",
                        rel=f"{PKG}/engine/other.py") == []

    @pytest.mark.parametrize("rel", ["engine/checkpoint.py",
                                     "engine/compile_cache.py"])
    def test_protocol_modules_in_scope(self, tree, rel):
        assert len(_durable(tree, "open('ck.npz', 'wb')\n",
                            rel=f"{PKG}/{rel}")) == 1

    def test_port_tree_is_clean(self):
        assert lint.stage_durable_writes() == []


# ---------------------------------------------------------------------------
# 10-11. ruff, mypy; the exit rule
# ---------------------------------------------------------------------------


class TestToolsAndGate:
    @pytest.mark.parametrize("stage", ["stage_ruff", "stage_mypy"])
    def test_absent_tool_is_skipped_not_passed(self, stage, monkeypatch):
        monkeypatch.setattr(lint.shutil, "which", lambda name: None)
        assert getattr(lint, stage)() is None

    @pytest.mark.parametrize("stage", ["stage_ruff", "stage_mypy"])
    def test_present_tool_failure_is_reported(self, stage, monkeypatch):
        monkeypatch.setattr(lint.shutil, "which", lambda name: "/bin/" + name)
        monkeypatch.setattr(lint, "_run_tool",
                            lambda cmd: [f"{cmd[0]}: 1 error"])
        assert getattr(lint, stage)() == [
            f"{stage.split('_')[1]}: 1 error"]

    def _stub(self, monkeypatch, failing=None):
        stages = tuple((n, (lambda n=n: ["planted"] if n == failing else [])
                        if n not in ("ruff", "mypy") else (lambda: None))
                       for n, _ in lint.STAGES)
        monkeypatch.setattr(lint, "STAGES", stages)

    def test_all_clean_exits_zero_and_says_skipped(self, monkeypatch,
                                                   capsys):
        self._stub(monkeypatch)
        assert lint.main([]) == 0
        out = capsys.readouterr().out
        assert "lint: ruff: SKIPPED" in out and out.endswith(
            "lint: PASS\n")

    @pytest.mark.parametrize("name", [n for n, _ in lint.STAGES
                                      if n not in ("ruff", "mypy")])
    def test_any_stage_finding_fails_the_gate(self, name, monkeypatch,
                                              capsys):
        self._stub(monkeypatch, failing=name)
        assert lint.main(["--json"]) == 1
        rep = json.loads(capsys.readouterr().out)
        assert rep["ok"] is False
        assert rep["stages"][name] == {"ok": False, "findings": ["planted"]}
        assert rep["stages"]["ruff"] == "skipped (tool not installed)"

    def test_stage_order_is_the_reference_order(self):
        assert [n for n, _ in lint.STAGES] == [
            "syntax", "unused_imports", "local_imports", "np_default_int",
            "captured_purity", "sync_contracts", "liveness_waits",
            "cluster_torch_free", "durable_writes", "ruff", "mypy"]

    def test_gate_imports_no_torch_or_reference(self):
        import subprocess

        code = ("import runpy, sys\n"
                "sys.argv = ['torch_lint.py']\n"
                "try:\n"
                "    runpy.run_path('scripts/torch_lint.py', "
                "run_name='__main__')\n"
                "except SystemExit as e:\n"
                "    rc = e.code\n"
                "bad = [m for m in sys.modules if m.split('.')[0] in "
                "('torch', 'jax', 'flowsentryx_tpu')]\n"
                "assert not bad, bad\n"
                "print('rc', rc)\n")
        r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        assert r.stdout.strip().endswith("rc 0"), r.stdout
