#!/usr/bin/env python3
"""Lint gate for the PyTorch/CUDA port's Python: ``flowsentryx_tpu_torch/``,
``tests/test_torch_*.py``, ``scripts/torch_*.py`` and ``chip_smoke.py``.

The counterpart of ``scripts/lint.py`` (which gates the reference's
tree), with each stage's rule carried over into the port's terms.  It
imports nothing of ``flowsentryx_tpu`` and no ``torch``.  Stages, in
order; the gate fails if any stage fails:

1. **syntax** -- every file in scope compiles (in memory: nothing is
   written to the tree).
2. **unused imports** -- an AST pass with the contract of pyflakes F401
   (``# noqa`` lines and ``__init__.py`` re-exports are exempt).
3. **local imports** -- a function-local ``import torch`` (or of any
   ``torch.*``) in a module that already imports torch at module level
   (a lazy torch import in a torch-free module stays legal: that is how
   the CLI, the supervisor and the ingest workers keep torch off their
   boot path), and any local import that shadows a name a module-level
   import bound.  ``# noqa`` exempts a line.
4. **np default int** -- over the hot-path packages (``core/``, ``ops/``,
   ``fused/``, ``engine/``, ``ingest/``, ``cluster/``), a dtype-less
   ``np.array``/``zeros``/``ones``/``empty``/``arange``/``full``: the
   default integer is the platform's C long, whose width varies by
   platform, an overflow hazard the ``fsx ranges`` prover cannot see.
   ``# noqa`` exempts a line.
5. **captured-region purity** -- over the step bodies the engine
   captures into CUDA graphs (``ops/fused.py``, ``fused/device_loop.py``,
   ``parallel/step.py``), a host round trip: ``.item()``,
   ``.tolist()``, ``.cpu()``, ``.numpy()``, any ``.synchronize()``
   (``torch.cuda.synchronize`` included) or ``print``.  Each one is a
   device -> host wait inside the captured region (or a capture error);
   ``fsx audit`` proves the same on the traced graph, this stage at
   review speed.  A host-side line carries ``# noqa`` with its reason.
6. **sync contracts** -- the port's thread-contract checker
   (``flowsentryx_tpu_torch/sync/contracts.py``) in quick mode.
7. **liveness waits** -- over ``flowsentryx_tpu_torch/live/registry.py``'s
   ``SCAN_MODULES``: an untimed ``*.wait()`` (a lost notify parks the
   thread forever), and a ``while True:`` loop with neither a bounded
   sleep nor a PROGRESS registry entry.  ``# noqa`` exempts a line.
8. **cluster torch-free** -- no module-level import under
   ``flowsentryx_tpu_torch/cluster/`` may reach ``torch``: neither
   ``torch`` itself nor a port module whose module-level imports reach
   it (followed through the package's own modules and ``__init__``
   files: ``ops``, ``fused``, ``engine.engine``, ``engine.checkpoint``
   and the rest; ``engine.writeback`` imports numpy only).  The cluster
   plane is the supervisor's and every rank's spawn path, where torch's
   import costs seconds per process.  Function-local imports stay
   legal.  ``# noqa`` exempts a line.
9. **durable writes** -- over the durable-protocol scope (``cluster/``,
   ``engine/checkpoint.py``, ``engine/compile_cache.py``): a bare
   ``open(..., "w"/"x"/"a")``, ``.write_text``/``.write_bytes`` or a
   path-targeted ``np.savez*``.  Protocol state publishes through
   ``core/durable.atomic_write``; ``# noqa`` exempts a line (shm
   creates, reports).
10. **ruff** -- ``ruff check flowsentryx_tpu_torch`` when ruff is
    installed; SKIPPED (loudly) when not.
11. **mypy** -- the same availability contract.

Usage::

    python3 scripts/torch_lint.py          # gate: exit 1 on any finding
    python3 scripts/torch_lint.py --json   # machine-readable report
"""

from __future__ import annotations

import argparse
import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

#: The tree the stages scan (tests point it at throwaway trees).
REPO = Path(__file__).resolve().parents[1]
PKG = "flowsentryx_tpu_torch"
#: The scope: ``(directory or file, glob)`` under ``REPO``.
PY_SCOPE = ((PKG, "**/*.py"), ("tests", "test_torch_*.py"),
            ("scripts", "torch_*.py"), ("chip_smoke.py", ""))
RUFF_MYPY_SCOPE = PKG


def _rel(path: Path) -> Path | str:
    try:
        return path.relative_to(REPO)
    except ValueError:
        return path


def scope_files() -> list[Path]:
    """Every Python file of the port's scope under ``REPO``."""
    out = []
    for where, pattern in PY_SCOPE:
        p = REPO / where
        if not pattern:
            out += [p] if p.is_file() else []
        elif p.is_dir():
            out += sorted(p.glob(pattern))
    return out


def _parse(path: Path) -> tuple[ast.Module | None, list[str]]:
    """The module's tree and lines; None on a syntax error (the syntax
    stage reports those)."""
    src = path.read_text()
    try:
        return ast.parse(src, filename=str(path)), src.splitlines()
    except SyntaxError:
        return None, []


def _noqa(lines: list[str], lineno: int) -> bool:
    return lineno <= len(lines) and "noqa" in lines[lineno - 1]


def stage_syntax() -> list[str]:
    fails = []
    for path in scope_files():
        try:
            compile(path.read_text(), str(path), "exec")
        except SyntaxError as e:
            fails.append(f"{_rel(path)}:{e.lineno}: syntax error: {e.msg}")
    return fails


def _unused_imports(path: Path) -> list[str]:
    """F401-shaped unused-import findings for one module."""
    tree, lines = _parse(path)
    if tree is None:
        return []
    imported: dict[str, int] = {}  # bound name -> line number
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                imported[a.asname or a.name.split(".")[0]] = node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                if a.name != "*":
                    imported[a.asname or a.name] = node.lineno
    used = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    # __all__ re-exports count as uses
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "__all__"
                        for t in node.targets)
                and isinstance(node.value, (ast.List, ast.Tuple))):
            used |= {e.value for e in node.value.elts
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str)}
    return [f"{_rel(path)}:{lineno}: unused import {name!r}"
            for name, lineno in sorted(imported.items(), key=lambda kv: kv[1])
            if name not in used and not _noqa(lines, lineno)]


def stage_unused_imports() -> list[str]:
    fails = []
    for path in scope_files():
        if path.name != "__init__.py":   # the re-export surface
            fails.extend(_unused_imports(path))
    return fails


def _import_bindings(node: ast.Import | ast.ImportFrom):
    """``(bound name, root module)`` pairs one import statement binds."""
    if isinstance(node, ast.Import):
        for a in node.names:
            yield a.asname or a.name.split(".")[0], a.name.split(".")[0]
    else:
        root = ("" if node.module is None or node.level
                else node.module.split(".")[0])
        for a in node.names:
            if a.name != "*":
                yield a.asname or a.name, root


def _local_import_findings(path: Path) -> list[str]:
    """Stage 3's findings for one module: a torch re-import under a
    module-level torch import, and a local import shadowing a
    module-level import binding."""
    tree, lines = _parse(path)
    if tree is None:
        return []
    module_binds: dict[str, int] = {}
    module_has_torch = False
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for name, root in _import_bindings(node):
                module_binds[name] = node.lineno
                module_has_torch |= root == "torch"
    out = []
    seen: set[int] = set()   # nested defs re-walk their imports: dedupe
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(fn):
            if (not isinstance(node, (ast.Import, ast.ImportFrom))
                    or id(node) in seen):
                continue
            seen.add(id(node))
            if _noqa(lines, node.lineno):
                continue
            for name, root in _import_bindings(node):
                if root == "torch" and module_has_torch:
                    out.append(
                        f"{_rel(path)}:{node.lineno}: function-local torch "
                        f"import ({name!r}) duplicates this module's "
                        "module-level torch import; hoist it")
                elif name in module_binds:
                    out.append(
                        f"{_rel(path)}:{node.lineno}: local import shadows "
                        f"module-level import {name!r} (line "
                        f"{module_binds[name]})")
    return out


def stage_local_imports() -> list[str]:
    fails = []
    for path in scope_files():
        fails.extend(_local_import_findings(path))
    return fails


#: Hot-path packages where a dtype-less numpy constructor is an overflow
#: hazard (module docstring, stage 4).
NP_DEFAULT_INT_TREES = tuple(f"{PKG}/{d}" for d in (
    "core", "ops", "fused", "engine", "ingest", "cluster"))

#: Banned-without-dtype numpy constructors -> positional index at which
#: a dtype may stand instead of the ``dtype=`` keyword.
NP_DEFAULT_INT_CTORS = {
    "array": 1, "zeros": 1, "ones": 1, "empty": 1, "full": 2, "arange": 3,
}


def _np_default_int_findings(path: Path) -> list[str]:
    tree, lines = _parse(path)
    if tree is None:
        return []
    out = []
    for node in ast.walk(tree):
        fn = getattr(node, "func", None)
        if not (isinstance(node, ast.Call)
                and isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name) and fn.value.id == "np"
                and fn.attr in NP_DEFAULT_INT_CTORS):
            continue
        if (any(kw.arg == "dtype" for kw in node.keywords)
                or len(node.args) > NP_DEFAULT_INT_CTORS[fn.attr]
                or _noqa(lines, node.lineno)):
            continue
        out.append(
            f"{_rel(path)}:{node.lineno}: dtype-less np.{fn.attr} in a "
            "hot-path package: the default int is the platform C long "
            "(its width varies by platform), an overflow hazard the fsx "
            "ranges prover cannot see; pass an explicit dtype")
    return out


def stage_np_default_int() -> list[str]:
    fails = []
    for tree in NP_DEFAULT_INT_TREES:
        for path in sorted((REPO / tree).rglob("*.py")):
            fails.extend(_np_default_int_findings(path))
    return fails


#: The step bodies the engine captures into CUDA graphs.
CAPTURED_REGION = tuple(f"{PKG}/{m}" for m in (
    "ops/fused.py", "fused/device_loop.py", "parallel/step.py"))
#: Method calls that wait for the device and copy to the host.
CAPTURED_REGION_BANNED = frozenset({"item", "tolist", "cpu", "numpy",
                                    "synchronize"})


def _captured_purity_findings(path: Path) -> list[str]:
    """Host-round-trip findings for one captured-region module."""
    tree, lines = _parse(path)
    if tree is None:
        return []
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in CAPTURED_REGION_BANNED:
            name = f".{fn.attr}()"
        elif isinstance(fn, ast.Name) and fn.id == "print":
            name = "print()"
        else:
            continue
        if _noqa(lines, node.lineno):
            continue
        out.append(
            f"{_rel(path)}:{node.lineno}: host round trip {name} in a "
            "captured step body: a device -> host wait inside the CUDA "
            "graph's region (fsx audit proves it on the traced graph; fix "
            "it here first), or # noqa with the reason it runs on the "
            "host")
    return out


def stage_captured_purity() -> list[str]:
    fails = []
    for rel in CAPTURED_REGION:
        p = REPO / rel
        if p.is_file():
            fails.extend(_captured_purity_findings(p))
    return fails


def _import_port(name: str):
    """A module of the port's package, from this checkout (the package
    is importable from the repository root)."""
    import importlib

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module(name)


def stage_sync_contracts() -> list[str]:
    """The thread-contract half of ``fsx sync`` (quick mode: pure AST)."""
    contracts = _import_port(f"{PKG}.sync.contracts")
    return [str(f) for f in contracts.run_contracts(root=REPO,
                                                    quick=True).findings]


def _liveness_wait_findings(path: Path, rel: str,
                            registered: set[tuple[str, str]]) -> list[str]:
    """An untimed ``*.wait()``, and a ``while True:`` loop with neither a
    bounded sleep nor a PROGRESS entry under its ``(path, qualname)``."""
    tree, lines = _parse(path)
    if tree is None:
        return []
    out = []

    def walk(node, stack):
        for ch in ast.iter_child_nodes(node):
            sub = stack
            if isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                sub = stack + [ch.name]
            if (isinstance(ch, ast.Call)
                    and isinstance(ch.func, ast.Attribute)
                    and ch.func.attr == "wait"
                    and not ch.args and not ch.keywords
                    and not _noqa(lines, ch.lineno)):
                out.append(
                    f"{rel}:{ch.lineno}: untimed .wait(): a lost notify "
                    "parks this thread forever; pass a quantum (a "
                    "sync/tuning constant) so the wait re-polls its "
                    "predicate (# noqa if wedging is the point)")
            if (isinstance(ch, ast.While)
                    and isinstance(ch.test, ast.Constant)
                    and ch.test.value is True
                    and not _noqa(lines, ch.lineno)):
                qn = ".".join(stack) or "<module>"
                sleeps = any(isinstance(n, ast.Call)
                             and isinstance(n.func, ast.Attribute)
                             and n.func.attr == "sleep"
                             for n in ast.walk(ch))
                if not sleeps and (rel, qn) not in registered:
                    out.append(
                        f"{rel}:{ch.lineno}: while True: in {qn} has no "
                        "bounded sleep and no PROGRESS registry entry: "
                        "declare its wake source, fairness assumption and "
                        f"bound in {PKG}/live/registry.py, or # noqa")
            walk(ch, sub)

    walk(tree, [])
    return out


def stage_liveness_waits() -> list[str]:
    """Every blocking loop in the protocol scope has a declared wake
    edge (the ``fsx live`` leg's lint half)."""
    registry = _import_port(f"{PKG}.live.registry")
    registered = registry.registered_sites()
    fails = []
    for rel in registry.SCAN_MODULES:
        p = REPO / rel
        if p.is_file():
            fails.extend(_liveness_wait_findings(p, rel, registered))
    return fails


#: The torch-free package: the supervisor's and every rank's spawn path.
CLUSTER_TORCH_FREE_TREE = f"{PKG}/cluster"


def _module_level_imports(tree: ast.Module):
    """The import statements a module runs when it is imported: its body's,
    and those of its top-level ``if``/``try`` blocks (not functions or
    classes, and not ``if TYPE_CHECKING:``)."""
    todo = list(tree.body)
    while todo:
        node = todo.pop(0)
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield node
        elif isinstance(node, ast.If):
            if not (isinstance(node.test, ast.Name)
                    and node.test.id == "TYPE_CHECKING"):
                todo += node.body + node.orelse
        elif isinstance(node, ast.Try):
            todo += (node.body + node.orelse + node.finalbody
                     + [s for h in node.handlers for s in h.body])


def _imported_modules(node: ast.Import | ast.ImportFrom, current: str
                      ) -> list[str]:
    """Dotted modules one import statement may load (``from a import b``:
    ``a`` and ``a.b``, which is a module or a name of ``a``)."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if node.level:
        base = current.split(".")[:-node.level]
        mod = ".".join(base + ([node.module] if node.module else []))
    else:
        mod = node.module or ""
    return [mod] + [f"{mod}.{a.name}" for a in node.names if a.name != "*"]


def _module_file(mod: str) -> Path | None:
    """The source of a port module under ``REPO``, None outside it."""
    if mod != PKG and not mod.startswith(PKG + "."):
        return None
    p = REPO.joinpath(*mod.split("."))
    if (p / "__init__.py").is_file():
        return p / "__init__.py"
    if p.with_suffix(".py").is_file():
        return p.with_suffix(".py")
    return None


def _reaches_torch(mod: str, memo: dict) -> list[str] | None:
    """The chain of port modules by which importing ``mod`` imports
    torch at module level (``[mod, ..., "torch"]``), else None."""
    if mod in memo:
        return memo[mod]
    memo[mod] = None                      # import cycles end here
    if mod == "torch" or mod.startswith("torch."):
        memo[mod] = ["torch"]
        return memo[mod]
    parts = mod.split(".")
    # importing a.b.c runs a/__init__.py and a/b/__init__.py first
    for i in range(1, len(parts)):
        chain = _reaches_torch(".".join(parts[:i]), memo)
        if chain:
            memo[mod] = [mod, *chain]
            return memo[mod]
    path = _module_file(mod)
    if path is None:
        return None
    tree, _ = _parse(path)
    if tree is None:
        return None
    current = mod if path.name != "__init__.py" else mod + ".__init__"
    for node in _module_level_imports(tree):
        for m in _imported_modules(node, current):
            chain = _reaches_torch(m, memo)
            if chain:
                memo[mod] = [mod, *chain]
                return memo[mod]
    return None


def _cluster_torch_findings(path: Path, memo: dict | None = None
                            ) -> list[str]:
    """Module-level imports of one cluster module that reach torch."""
    tree, lines = _parse(path)
    if tree is None:
        return []
    memo = {} if memo is None else memo
    rel = _rel(path)
    mod = ".".join(Path(rel).with_suffix("").parts)
    out = []
    for node in _module_level_imports(tree):
        if _noqa(lines, node.lineno):
            continue
        for m in _imported_modules(node, mod):
            chain = _reaches_torch(m, memo)
            if chain:
                out.append(
                    f"{rel}:{node.lineno}: module-level import of {m!r} "
                    f"imports torch ({' -> '.join(chain)}): every fleet "
                    "boot, adopt census and stub spawn pays torch's "
                    "import; move it function-local")
                break
    return out


def stage_cluster_torch_free() -> list[str]:
    fails, memo = [], {}
    for path in sorted((REPO / CLUSTER_TORCH_FREE_TREE).rglob("*.py")):
        fails.extend(_cluster_torch_findings(path, memo))
    return fails


#: The durable-protocol scope: modules whose file writes are protocol
#: state (layout, handoff, spools, checkpoints, compile-cache entries).
DURABLE_WRITE_SCOPE = (f"{PKG}/cluster", f"{PKG}/engine/checkpoint.py",
                       f"{PKG}/engine/compile_cache.py")


def _open_write_mode(node: ast.Call) -> str | None:
    """The write mode of an ``open()`` call, None when it reads."""
    mode = node.args[1] if len(node.args) > 1 else None
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if not (isinstance(mode, ast.Constant) and isinstance(mode.value, str)):
        return None   # absent (= "r") or dynamic
    return mode.value if any(c in mode.value for c in "wxa") else None


def _durable_write_findings(path: Path) -> list[str]:
    tree, lines = _parse(path)
    if tree is None:
        return []
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn, what = node.func, None
        if isinstance(fn, ast.Name) and fn.id == "open":
            m = _open_write_mode(node)
            if m is not None:
                what = f"open(..., {m!r})"
        elif (isinstance(fn, ast.Attribute)
              and fn.attr in ("write_text", "write_bytes")):
            what = f".{fn.attr}(...)"
        elif (isinstance(fn, ast.Attribute)
              and isinstance(fn.value, ast.Name) and fn.value.id == "np"
              and fn.attr in ("savez", "savez_compressed")
              and not (node.args and isinstance(node.args[0], ast.Name))):
            # savez into a bare-Name handle is the in-memory idiom that
            # feeds atomic_write; anything else writes the disk
            what = f"np.{fn.attr}(<path>, ...)"
        if what is None or _noqa(lines, node.lineno):
            continue
        out.append(
            f"{_rel(path)}:{node.lineno}: bare durable write {what} in the "
            "durable-protocol scope: publish through "
            "core/durable.atomic_write (fsync the file and its directory, "
            "atomic rename; a bare write tears at power loss); # noqa for "
            "files that are not protocol state (shm creates, reports)")
    return out


def stage_durable_writes() -> list[str]:
    fails = []
    for scope in DURABLE_WRITE_SCOPE:
        p = REPO / scope
        paths = [p] if p.suffix == ".py" else sorted(p.rglob("*.py"))
        for path in paths:
            if path.is_file():
                fails.extend(_durable_write_findings(path))
    return fails


def _run_tool(cmd: list[str]) -> list[str]:
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    if r.returncode == 0:
        return []
    out = (r.stdout + r.stderr).strip()
    return out.splitlines()[-40:] or [f"{cmd[0]} failed (exit "
                                      f"{r.returncode})"]


def stage_ruff() -> list[str] | None:
    if shutil.which("ruff") is None:
        return None
    return _run_tool(["ruff", "check", RUFF_MYPY_SCOPE])


def stage_mypy() -> list[str] | None:
    if shutil.which("mypy") is None:
        return None
    return _run_tool(["mypy", RUFF_MYPY_SCOPE])


#: The stages, in order.
STAGES = (
    ("syntax", stage_syntax),
    ("unused_imports", stage_unused_imports),
    ("local_imports", stage_local_imports),
    ("np_default_int", stage_np_default_int),
    ("captured_purity", stage_captured_purity),
    ("sync_contracts", stage_sync_contracts),
    ("liveness_waits", stage_liveness_waits),
    ("cluster_torch_free", stage_cluster_torch_free),
    ("durable_writes", stage_durable_writes),
    ("ruff", stage_ruff),
    ("mypy", stage_mypy),
)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    stages = {name: fn() for name, fn in STAGES}
    ok = not any(stages.values())
    if args.json:
        print(json.dumps({
            "ok": ok,
            "stages": {n: ("skipped (tool not installed)" if v is None
                           else {"ok": not v, "findings": v})
                       for n, v in stages.items()},
        }, indent=2))
    else:
        for name, findings in stages.items():
            if findings is None:
                print(f"lint: {name}: SKIPPED (tool not installed)")
            elif findings:
                print(f"lint: {name}: FAILED")
                for f in findings:
                    print(f"  {f}")
            else:
                print(f"lint: {name}: OK")
        print(f"lint: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
