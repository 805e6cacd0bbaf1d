"""CICIDS2017-calibrated evaluation fixture.

The port's own copy of ``flowsentryx_tpu/train/fixture.py`` (numpy
only): the same seed gives byte-identical rows to the reference's
``cicids_fixture``.

The repo ships no CIC CSVs (the upstream project checks in only an md5
stub, ``model/dataset/archive/MachineLearningCSV.md5``), so the BASELINE
metric (CICDDoS2019 F1) cannot be computed on real flows from it alone.
This module is a documented, distribution-faithful stand-in, with its
provenance stated per field rather than pretending to be real data.

Calibrated to REAL published statistics (the reference notebook's
``df_concat.describe()`` over the cleaned 2,520,798-flow CICIDS2017
set, ``model/model.ipynb`` cell 20):

* label rate 0.1688914 (label column mean — real),
* destination_port quantiles (min 0, 25% 53, 50% 80, 75% 443,
  max 65535, mean 8690.59 — real),
* dataset/test-split sizes (2,520,798 / 504,160 — real,
  ``model.ipynb:1658-1665,4538``).

NOT calibrated to real data (the notebook's rendered describe()
truncates the middle columns): the remaining 7 features use
class-conditional lognormal/mixture models built from CICFlowMeter
semantics — volumetric floods send small fixed-size packets at µs
inter-arrival times; benign flows are heavy-tailed in both — with
ranges consistent with the published neighbours (flow_duration max
1.2e8 µs bounds every IAT).  No parameter below was tuned to reproduce
the reference's 83.02 % accuracy; whatever the golden model scores
here is reported as a FIXTURE number, never as CICIDS performance.
"""

from __future__ import annotations

import numpy as np

from flowsentryx_tpu_torch.core.schema import NUM_FEATURES, Feature

#: Real aggregate marginals from model.ipynb cell 20 (describe()).
LABEL_RATE = 0.1688914
DPORT_QUANTILES = ((0.0, 0.0), (0.25, 53.0), (0.5, 80.0),
                   (0.75, 443.0), (1.0, 65535.0))
N_CLEANED = 2_520_798
N_TEST_SPLIT = 504_160


def _dport(rng: np.random.Generator, n: int) -> np.ndarray:
    """Piecewise-linear inverse-CDF sampler through the real quantiles.

    Real quartiles are tiny (53/80/443) with a long tail to 65535; the
    published mean 8690 confirms the tail mass.  Linear interpolation
    between published quantiles is the assumption-free choice."""
    u = rng.random(n)
    qs = np.array([q for q, _ in DPORT_QUANTILES])
    vs = np.array([v for _, v in DPORT_QUANTILES])
    return np.interp(u, qs, vs)


def _lognormal(rng, n, median, sigma, cap):
    return np.minimum(rng.lognormal(np.log(median), sigma, n), cap)


def _benign(rng: np.random.Generator, n: int) -> np.ndarray:
    X = np.zeros((n, NUM_FEATURES), np.float32)
    X[:, Feature.DST_PORT] = _dport(rng, n)
    # packet sizes: web/dns/bulk mix, heavy-tailed across flows
    mean_len = _lognormal(rng, n, 180.0, 0.9, 1460.0)
    rel_std = rng.beta(2.0, 3.0, n)  # most flows vary, none absurdly
    std_len = mean_len * rel_std * 2.0
    X[:, Feature.PKT_LEN_MEAN] = mean_len
    X[:, Feature.PKT_LEN_STD] = std_len
    # IATs (µs): interactive ms-scale to idle-dominated seconds-scale,
    # bounded by the real flow_duration max (1.2e8 µs)
    iat_mean = _lognormal(rng, n, 2.0e4, 2.2, 1.2e8)
    iat_rel = rng.lognormal(0.0, 0.8, n)
    X[:, Feature.FWD_IAT_MEAN] = iat_mean
    X[:, Feature.FWD_IAT_STD] = np.minimum(iat_mean * iat_rel, 1.2e8)
    X[:, Feature.FWD_IAT_MAX] = np.minimum(
        iat_mean * (1.0 + 3.0 * iat_rel), 1.2e8
    )
    # flow-age slots: duration = iat_mean x (n_pkts - 1) under the real
    # 1.2e8 us duration cap; rate follows (kernel-estimator identity
    # pps_x1000 = n * 1e9 / dur_us)
    npkts = np.maximum(_lognormal(rng, n, 10.0, 1.2, 1e5), 2.0)
    dur_us = np.clip(iat_mean * (npkts - 1.0), 1.0, 1.2e8)
    X[:, Feature.FLOW_DUR_MS] = dur_us / 1e3
    X[:, Feature.FLOW_PPS_X1000] = npkts * 1e9 / dur_us
    return X


#: Attack subtype ids — aligned with models.multiclass.ATTACK_CLASSES
#: (0 benign, 1 volumetric, 2 syn, 3 slow).
CLASS_BENIGN, CLASS_VOLUMETRIC, CLASS_SYN, CLASS_SLOW = 0, 1, 2, 3


def _attack(rng: np.random.Generator, n: int) -> tuple[np.ndarray, np.ndarray]:
    """DoS/DDoS flow features + subtype labels: volumetric floods
    (fixed small frames, µs IATs, low variance), SYN floods (minimal
    TCP frames on service ports, µs-ms IATs), and a slow-attack
    minority (Slowloris-style: sparse, long idle gaps).  NOTE on
    separability: the 8 flow features carry no protocol bits, so
    syn-vs-volumetric attribution rests on frame-size/IAT signatures
    only — the per-class eval reports that confusion honestly."""
    X = np.zeros((n, NUM_FEATURES), np.float32)
    cls = rng.choice(
        [CLASS_VOLUMETRIC, CLASS_SYN, CLASS_SLOW], n, p=[0.60, 0.25, 0.15]
    ).astype(np.int32)
    vol, syn, slow = (cls == CLASS_VOLUMETRIC), (cls == CLASS_SYN), \
        (cls == CLASS_SLOW)
    nv, ny, ns = int(vol.sum()), int(syn.sum()), int(slow.sum())

    X[:, Feature.DST_PORT] = np.where(
        rng.random(n) < 0.85,
        rng.choice([80.0, 443.0, 53.0], n),  # floods hit a service port
        _dport(rng, n),
    )
    # frame sizes: volumetric small-ish constant; SYN minimal TCP
    # (54-74 B, near-zero variance); slow: small but varied
    mean_len = np.empty(n)
    std_len = np.empty(n)
    mean_len[vol] = rng.uniform(54.0, 120.0, nv)
    std_len[vol] = rng.uniform(0.0, 4.0, nv)
    mean_len[syn] = rng.uniform(54.0, 74.0, ny)
    std_len[syn] = rng.uniform(0.0, 1.0, ny)
    mean_len[slow] = rng.uniform(60.0, 400.0, ns)
    std_len[slow] = rng.uniform(0.0, 60.0, ns)
    X[:, Feature.PKT_LEN_MEAN] = mean_len
    X[:, Feature.PKT_LEN_STD] = std_len

    iat_mean = np.empty(n)
    iat_max = np.empty(n)
    npkts = np.empty(n)
    if nv:
        iat_mean[vol] = _lognormal(rng, nv, 50.0, 1.5, 1e6)
        iat_max[vol] = iat_mean[vol] * rng.uniform(1.0, 20.0, nv)
        npkts[vol] = _lognormal(rng, nv, 3000.0, 1.0, 1e7)
    if ny:
        # handshake-rate floods: slower per flow than raw volumetric,
        # and per-flow SHORT (a few SYNs per spoofed source)
        iat_mean[syn] = _lognormal(rng, ny, 800.0, 1.2, 1e6)
        iat_max[syn] = iat_mean[syn] * rng.uniform(1.0, 10.0, ny)
        npkts[syn] = rng.uniform(3.0, 20.0, ny)
    if ns:
        # Slowloris-style: long-lived by construction (holding
        # connections open IS the attack), tens-to-hundreds of sparse
        # keepalive frames
        iat_mean[slow] = _lognormal(rng, ns, 5.0e6, 1.0, 1.2e8)
        iat_max[slow] = np.minimum(
            iat_mean[slow] * rng.uniform(2.0, 10.0, ns), 1.2e8
        )
        npkts[slow] = rng.uniform(10.0, 200.0, ns)
    X[:, Feature.FWD_IAT_MEAN] = iat_mean
    X[:, Feature.FWD_IAT_STD] = np.minimum(
        iat_mean * rng.lognormal(-0.5, 0.6, n), 1.2e8
    )
    X[:, Feature.FWD_IAT_MAX] = iat_max
    dur_us = np.clip(iat_mean * (npkts - 1.0), 1.0, 1.2e8)
    X[:, Feature.FLOW_DUR_MS] = dur_us / 1e3
    X[:, Feature.FLOW_PPS_X1000] = np.minimum(npkts * 1e9 / dur_us,
                                              4.0e9)
    return X, cls


def cicids_fixture(
    n: int = N_CLEANED, seed: int = 42, return_classes: bool = False
):
    """``(X [n,8] f32, y [n] f32)`` with the real 16.89 % label rate;
    with ``return_classes`` additionally ``y_class [n] i32`` (attack
    subtype ids aligned with models.multiclass.ATTACK_CLASSES)."""
    rng = np.random.default_rng(seed)
    n_attack = int(round(n * LABEL_RATE))
    Xa, cls_a = _attack(rng, n_attack)
    X = np.concatenate([_benign(rng, n - n_attack), Xa])
    y = np.concatenate([
        np.zeros(n - n_attack, np.float32), np.ones(n_attack, np.float32)
    ])
    y_class = np.concatenate([
        np.full(n - n_attack, CLASS_BENIGN, np.int32), cls_a
    ])
    order = rng.permutation(n)
    if return_classes:
        return X[order], y[order], y_class[order]
    return X[order], y[order]


def provenance() -> dict:
    """Machine-readable provenance block for metrics artifacts."""
    return {
        "kind": "synthetic-calibrated-fixture",
        "why_not_real_data": (
            "no network egress in the build image; CICIDS2017/CICDDoS2019 "
            "CSVs absent (reference repo ships only an md5 stub: "
            "model/dataset/archive/MachineLearningCSV.md5)"
        ),
        "real_calibration": {
            "label_rate": {
                "value": LABEL_RATE,
                "source": "reference model.ipynb cell 20 describe(): label mean",
            },
            "destination_port_quantiles": {
                "value": dict((str(q), v) for q, v in DPORT_QUANTILES),
                "source": "reference model.ipynb cell 20 describe()",
            },
            "sizes": {
                "cleaned_rows": N_CLEANED,
                "test_split": N_TEST_SPLIT,
                "source": "reference model.ipynb:1658-1665,4538",
            },
        },
        "synthetic_assumptions": (
            "7 of 8 feature marginals are class-conditional lognormal/"
            "mixture models from CICFlowMeter semantics (floods: fixed "
            "small frames, microsecond IATs; benign: heavy-tailed), NOT "
            "fit to real data and NOT tuned toward the reference's "
            "83.02% accuracy"
        ),
    }
