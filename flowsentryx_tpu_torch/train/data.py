"""Dataset loading and cleaning.

Counterpart of ``flowsentryx_tpu/train/data.py``: the same CSV columns
and units, the same cleaning (negatives clipped to 0, rows with NaN or
inf dropped, exact duplicate ``(row, label)`` pairs dropped, first
kept), the same synthetic labelled set from the traffic generators and
the same seeded 80/20 split.

:func:`load_csvs` reads with the standard library's ``csv`` module and
numpy instead of pandas (the GPU machine has no pandas).  It parses
what the reference's ``pandas.read_csv(skipinitialspace=True)`` parses
in the CICFlowMeter files: header names with leading spaces, numbers,
``Infinity``/``-Infinity``/``inf``, the ``NaN`` spellings and empty
cells (both missing), and labels with surrounding spaces.
"""

from __future__ import annotations

import csv
import glob as _glob
from pathlib import Path

import numpy as np

#: CSV column -> feature index (names matched after ``strip()``); slots
#: 3/4 are the flow-age features, converted by :data:`CSV_SCALE`.
CSV_COLUMNS: tuple[str, ...] = (
    "Destination Port",
    "Packet Length Mean",
    "Packet Length Std",
    "Flow Duration",
    "Flow Packets/s",
    "Fwd IAT Mean",
    "Fwd IAT Std",
    "Fwd IAT Max",
)

#: Per-column multiplier applied after load (CIC units -> wire units).
CSV_SCALE: tuple[float, ...] = (1.0, 1.0, 1.0, 1e-3, 1e3, 1.0, 1.0, 1.0)
LABEL_COLUMN = "Label"
BENIGN_LABEL = "BENIGN"

#: Cells pandas reads as missing by default (``na_values``).
_NA = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def _cell(s: str, path: str, line: int) -> float:
    s = s.strip()
    if s in _NA:
        return float("nan")
    if "_" in s:            # Python's float() takes digit separators
        raise ValueError(f"{path}:{line}: not a number: {s!r}")
    try:
        return float(s)
    except ValueError:
        raise ValueError(f"{path}:{line}: not a number: {s!r}") from None


def _read(path: str) -> tuple[list[str], list[list[str]]]:
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f, skipinitialspace=True) if r]
    if not rows:
        raise ValueError(f"{path}: no header")
    header = [c.strip() for c in rows[0]]
    for i, r in enumerate(rows[1:], 2):
        if len(r) > len(header):
            raise ValueError(f"{path}:{i}: expected {len(header)} fields, "
                             f"saw {len(r)}")
    return header, rows[1:]


def load_csvs(pattern: str) -> tuple[np.ndarray, np.ndarray]:
    """Load + clean CICIDS2017/CICDDoS2019-format CSVs.

    Returns ``(X [N, 8] float32, y [N] float32)`` with y in {0, 1}
    (every label but ``BENIGN`` is an attack)."""
    paths = sorted(_glob.glob(pattern))
    if not paths:
        raise FileNotFoundError(f"no CSVs match {pattern!r}")
    feats, labels = [], []
    for p in paths:
        header, rows = _read(p)
        missing = [c for c in (*CSV_COLUMNS, LABEL_COLUMN) if c not in header]
        if missing:
            raise KeyError(f"dataset lacks expected columns: {missing}")
        cols = [header.index(c) for c in CSV_COLUMNS]
        lab = header.index(LABEL_COLUMN)
        for i, r in enumerate(rows, 2):
            r = r + [""] * (len(header) - len(r))   # short rows: missing
            feats.append([_cell(r[c], p, i) for c in cols])
            labels.append(r[lab].strip() != BENIGN_LABEL)
    X = np.asarray(feats, np.float64).reshape(-1, len(CSV_COLUMNS)).astype(
        np.float32)
    y = np.asarray(labels, np.float32)
    X *= np.asarray(CSV_SCALE, np.float32)

    # clean: negatives are CICFlowMeter artifacts -> clip to 0; NaN/inf
    # rows dropped; exact duplicate (row, label) pairs dropped
    X = np.where(X < 0, 0, X)
    finite = np.isfinite(X).all(axis=1)
    X, y = X[finite], y[finite]
    _, keep = np.unique(
        np.concatenate([X, y[:, None]], axis=1), axis=0, return_index=True
    )
    keep.sort()
    return X[keep], y[keep]


def synthetic_dataset(
    n: int = 50_000, attack_fraction: float = 0.5, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Labelled feature set from the traffic generators (the stand-in
    dataset when no CIC CSVs are present, and the test fixture)."""
    from flowsentryx_tpu_torch.engine.traffic import (
        Scenario, TrafficGen, TrafficSpec,
    )

    gen = TrafficGen(TrafficSpec(scenario=Scenario.MIXED_L34_1M,
                                 attack_fraction=attack_fraction, seed=seed))
    buf = gen.next_records(n)
    X = buf["feat"].astype(np.float32)
    y = gen.labels_for(buf).astype(np.float32)
    return X, y


def train_test_split(
    X: np.ndarray, y: np.ndarray, test_fraction: float = 0.2, seed: int = 42
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """80/20 shuffled split, seed 42 (the reference's split)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(X))
    n_test = int(len(X) * test_fraction)
    test, train = order[:n_test], order[n_test:]
    return X[train], X[test], y[train], y[test]


def write_fixture_csv(path: str | Path, n: int = 500, seed: int = 3) -> Path:
    """A tiny CICIDS-format CSV (leading-space column names and all) for
    exercising the loader without the real 2.8M-row dataset."""
    path = Path(path)
    X, y = synthetic_dataset(n, seed=seed)
    cols = [" " + c if i else c for i, c in enumerate(CSV_COLUMNS)]
    header = ",".join(cols) + ", Label"
    rows = [header]
    inv_scale = 1.0 / np.asarray(CSV_SCALE, np.float64)
    for xi, yi in zip(X, y):
        label = "DDoS" if yi else BENIGN_LABEL
        # CIC units (Flow Duration in µs, Flow Packets/s in pps), so the
        # loader's unit conversion is exercised for real
        rows.append(",".join(f"{v:.3f}" for v in xi * inv_scale)
                    + f", {label}")
    path.write_text("\n".join(rows) + "\n")
    return path
