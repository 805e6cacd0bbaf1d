"""``fsx audit``: the static contracts of the staged step graphs.

Counterpart of ``flowsentryx_tpu/audit/``.  Proves the device fast
path's serving contracts on the staged step itself, before the first
batch: the aten graph of one all-masked call of each step variant and,
on the card, its captured CUDA graph (:mod:`.graph` for the checks,
:mod:`.runner` for variant staging, the JSON report and the engine-boot
hook).
"""

from flowsentryx_tpu_torch.audit.graph import (  # noqa: F401
    AuditError, Finding, check_collectives, check_dtypes, check_host_sync,
    check_in_place, check_quantized_lane, check_table_copies,
    staging_check, trace_call,
)
from flowsentryx_tpu_torch.audit.runner import (  # noqa: F401
    AuditReport, VariantReport, audit_serving, boot_audit, run_audit,
)
