"""The reference's data-parallel QAT trainer at the deployed recipe's
size, for the port's card check to hold its run to.

    JAX_PLATFORMS=cpu python scripts/qat_dp_reference.py [--out artifacts/qat_dp_reference.json]

Runs ``flowsentryx_tpu.train.qat.train_logreg_qat_dp`` over 8 virtual
CPU devices and ``train_logreg_qat`` on one, both for 200 epochs on the
training split of ``cicids_fixture(N_CLEANED, seed=0)`` (2,016,639
rows, no sample weight), and writes each run's per-epoch losses, final
observers and converted artifact (float32 values written exactly), and
their relation: the largest relative loss gap and its epoch, and the
largest ``w_int8`` code gap.  ``chip_smoke.py``'s ``train_qat_dp`` reads
it (the card has no JAX).  ~30 s on 8 cores.
"""

import argparse
import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

EPOCHS = 200
SHARDS = 8


def run_record(res) -> dict:
    import numpy as np

    p = res.params
    return {
        "losses": [float(v) for v in np.asarray(res.losses, np.float32)],
        "obs_in": [float(res.state.obs_in.lo), float(res.state.obs_in.hi)],
        "obs_out": [float(res.state.obs_out.lo),
                    float(res.state.obs_out.hi)],
        "params": {"w_int8": np.asarray(p.w_int8).astype(int).tolist(),
                   **{k: float(np.asarray(getattr(p, k))) for k in (
                       "bias", "w_scale", "in_scale", "in_zp", "out_scale",
                       "out_zp", "log1p")}}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "artifacts", "qat_dp_reference.json"))
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from flowsentryx_tpu.parallel import make_mesh
    from flowsentryx_tpu.train import data, fixture, qat

    X, y = fixture.cicids_fixture(fixture.N_CLEANED, seed=0)
    Xtr, _, ytr, _ = data.train_test_split(X, y)
    single = qat.train_logreg_qat(Xtr, ytr, epochs=EPOCHS)
    dp = qat.train_logreg_qat_dp(Xtr, ytr, make_mesh(SHARDS), epochs=EPOCHS)
    rel = np.abs(dp.losses - single.losses) / np.abs(single.losses)
    out = {
        "rows": int(len(Xtr)), "epochs": EPOCHS, "shards": SHARDS,
        "fixture": "cicids_fixture(N_CLEANED, seed=0), train split",
        "jax": jax.__version__,
        "dp": run_record(dp), "single": run_record(single),
        "dp_vs_single": {
            "loss_max_rel": float(rel.max()),
            "loss_max_rel_epoch": int(rel.argmax()),
            "w_int8_max_code_diff": int(np.abs(
                np.asarray(dp.params.w_int8).astype(int)
                - np.asarray(single.params.w_int8).astype(int)).max())}}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out["dp_vs_single"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
