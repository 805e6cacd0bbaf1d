"""Tiny sizes of the two cells for CPU runs: the cells' own paths and
shapes of work, cut so a run takes seconds."""

CELL_OVERRIDES = {
    "mixed_l34_1m.sharded": {
        "config": {"fsx": {"table": {"capacity": 4096},
                           "batch": {"max_batch": 256}},
                   "traffic": {"n_attack_ips": 512, "n_benign_ips": 512}},
        "workload": {"params": {"workers": 2, "min_cores": 1,
                                "pool_records": 16384, "ring_records": 4096}},
    },
    "syn_benign_online.paced": {
        "config": {"fsx": {"table": {"capacity": 4096},
                           "batch": {"max_batch": 256}}},
        "workload": {"params": {"rate_pps": 20000.0, "pool_records": 16384}},
    },
}
CELLS = sorted(CELL_OVERRIDES)
