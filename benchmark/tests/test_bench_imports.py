"""No run loads JAX or the JAX package (top-level names compared whole),
and the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys

from benchmark import harness
from benchmark.tests.conftest import ROOT

RUN = '''
import json, sys
sys.path.insert(0, {src!r})
import torch
torch.set_num_threads(2)
from benchmark import harness
from benchmark.tests.tiny import CELL_OVERRIDES
out = harness.run_cell({root!r}, {cell!r}, 1, 1.0, False, device="cpu",
                       overrides=CELL_OVERRIDES[{cell!r}])
print(json.dumps([out["correct"],
                  sorted({{m.split(".")[0] for m in sys.modules}})]))
'''


def _top_level(code: str) -> list:
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(ROOT), timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax(bench_root):
    for cell in ("syn_benign_online.paced", "mixed_l34_1m.sharded"):
        correct, mods = _top_level(RUN.format(src=str(ROOT),
                                              root=str(bench_root), cell=cell))
        assert correct
        assert not set(mods) & set(harness.FORBIDDEN), mods
        assert "flowsentryx_tpu_torch" in mods


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "import benchmark.reference.replay, benchmark.reference.step\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))" % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    mods = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not mods & {"flowsentryx_tpu_torch", *harness.FORBIDDEN}, mods
    for f in (ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] in {"benchmark", "numpy", "torch",
                                           "math", "__future__"}, (f, n)


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "flowsentryx_tpu_torch_probe", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flowsentryx_tpu.core.probe", sys)
    assert harness.forbidden_modules() == ["flowsentryx_tpu.core.probe"]
