"""The ``WRAP_OK`` registry: audited exemptions for arithmetic the
interval domain cannot see is wrap-free.

Counterpart of ``flowsentryx_tpu/ranges/registry.py``.  The reference
wraps fixed-width integers by design at four sites.  The port does its
u32 arithmetic in int64, masked (``core/device.py::u32``,
``ops/hashtable.py``), so the claim it proves is its own: no int64
partial product overflows, and every int32 or narrower result comes
from an explicit fold.  :data:`REFERENCE_COUNTERPARTS` says, for each
reference entry, why the port needs none.  What remains is one site
whose operand the interval domain reads as all of int64 (a float64
bit pattern) and which is wrap-free by construction.

Discipline (the reference's): entries are **audited for staleness**
every run -- the named function must still exist in the named file, and
the entry must have matched at least one node across the run's staged
variants.  Either failure is a finding.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

from flowsentryx_tpu_torch.audit.graph import Finding


@dataclasses.dataclass(frozen=True)
class WrapOk:
    """One audited exemption."""

    name: str            # slug (artifact/report key)
    file: str            # repo-relative source file the site lives in
    func: str            # function whose nodes are exempt
    prims: frozenset     # op names it covers ("sub" for aten.sub.Tensor)
    rationale: str       # why the site cannot wrap (report-facing)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["prims"] = sorted(self.prims)
        return d


def _ok(name, file, func, prims, rationale) -> WrapOk:
    return WrapOk(name, file, func, frozenset(prims), rationale)


#: The shipped registry.  Keep it MINIMAL: the staleness audit fails on
#: any entry that stops matching.
WRAP_OK: tuple[WrapOk, ...] = (
    _ok("fma32-round-to-odd",
        "flowsentryx_tpu_torch/core/device.py", "fma32",
        {"sub"},
        "s.view(int64) - ((err*s) < 0): the subtrahend is 1 only where "
        "err*s < 0, so s is finite and nonzero there; its int64 bit "
        "pattern is then in [1, 2^63-1] (s > 0) or above INT64_MIN "
        "(s < 0: only -0.0 has the pattern INT64_MIN), and one less "
        "cannot wrap; the interval domain reads the bit pattern as all "
        "of int64"),
)

#: Each reference ``WRAP_OK`` entry, and why the port has no counterpart.
REFERENCE_COUNTERPARTS: dict[str, str] = {
    "hash-avalanche":
        "none needed: ops/hashtable.py::_mul32 multiplies a u32 held in "
        "int64 by the constant's 16-bit halves and masks, so no partial "
        "product leaves int64 (proved, not exempted)",
    "probe-ring-walk":
        "none needed: h1 + p*step stays below 2^36 in int64 before the "
        "capacity mask (proved)",
    "stat-carry-add":
        "none needed: the counters are int64, not (lo, hi) u32 pairs; "
        "the prover shows a step's adds keep a counter seeded up to "
        "RANGE_STAT_MAX (2^54, the deployment horizon at 2^32 records/s) "
        "inside int64",
    "raw-ts-rebase":
        "none needed: schema.decode_raw takes (ts_hi - t0_hi) in int64, "
        "masks it to u32 and folds it to a signed delta with an explicit "
        "where, before converting to float (proved)",
}


def match(entries: tuple[WrapOk, ...], prim_name: str,
          frames) -> WrapOk | None:
    """First entry covering ``prim_name`` at one of the node's user
    source frames (``frames``: (file, function) pairs, innermost
    first)."""
    for fname, func in frames:
        for e in entries:
            if (prim_name in e.prims and func == e.func
                    and fname.replace("\\", "/").endswith(e.file)):
                return e
    return None


def audit_registry(entries: tuple[WrapOk, ...],
                   match_counts: dict[str, int],
                   root: Path | None = None) -> list[Finding]:
    """The staleness audit: every entry must name a still-existing
    function AND have matched during the run."""
    root = root or Path(__file__).resolve().parents[2]
    findings: list[Finding] = []
    for e in entries:
        src_path = root / e.file
        if not src_path.is_file():
            findings.append(Finding(
                contract="wrap-ok", where=e.name,
                reason=(f"stale WRAP_OK entry: file {e.file} does not "
                        "exist; the exempted code was deleted or moved; "
                        "delete or retarget the entry")))
            continue
        src = src_path.read_text()
        if not re.search(rf"^\s*def {re.escape(e.func)}\b", src,
                         re.MULTILINE):
            findings.append(Finding(
                contract="wrap-ok", where=e.name,
                reason=(f"stale WRAP_OK entry: no function {e.func!r} in "
                        f"{e.file}; the exempted code was deleted or "
                        "renamed; delete or retarget the entry")))
            continue
        if not match_counts.get(e.name):
            findings.append(Finding(
                contract="wrap-ok", where=e.name,
                reason=(f"stale WRAP_OK entry: {e.name} matched no node "
                        "in any staged variant this run; an unused "
                        "exemption would silently cover a future "
                        f"accidental wrap at {e.file}:{e.func}; delete "
                        "it")))
    return findings
